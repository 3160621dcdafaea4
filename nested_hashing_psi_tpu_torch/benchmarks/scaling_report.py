"""The batched-PIE online step at one device and on the ``parallel/`` mesh.

Counterpart of ``benchmarks/scaling_report.py``: depth rows per second
("ciphertext-ops": one depth row of the PIE online step) of

  1. one device, unsharded (``batched_pie_forward``, the full basis the
     sharded steps compute on);
  2. the dp x tp step (``parallel/mesh.py`` ``sharded_pie_step``) on a
     process group of one: NCCL on the card (gloo on the CPU);
  3. with ``--ranks R``, the same step over R rank processes
     (``parallel/launch.py``) on a dp x tp mesh through gloo: on one card
     the ranks share it and each exchange is staged through host memory.

Every result is gathered and held bit-equal to the unsharded one (the
report fails otherwise), and the JSON line names each row's transport.
Ranks that share one card measure correctness and per-rank compute, not
scale-out: scale-out needs a card per rank.

    python -m nested_hashing_psi_tpu_torch.benchmarks.scaling_report \\
        --ring 16384 --limbs 8 --depths 16 [--ranks 4] [--device cuda]

Each rate is the host clock over queries issued back to back
(``timing.wall_ms``) ending in a synchronise; across ranks, the slowest
rank's. ``--device cpu`` runs it on
the CPU (gloo ranks) for the tests.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from nested_hashing_psi_tpu_torch.benchmarks import card, small_pie
from nested_hashing_psi_tpu_torch.benchmarks.timing import wall_ms
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.parallel import comm
from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
from nested_hashing_psi_tpu_torch.parallel.mesh import sharded_pie_step
from nested_hashing_psi_tpu_torch.parallel.multihost import (
    compute_device,
    global_mesh,
    global_to_host,
    host_to_global,
    init_distributed,
)
from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import resolve_device

RANKS_TIMEOUT = 600.0  # s: the ranks' start, their builds and their queries
NOTE = ("ranks sharing one card measure correctness and per-rank compute, not scale-out "
        "(each exchange of the staged gloo transport crosses host memory twice)")


def _sharded(rank: int, world: int, scheme: dict, host: dict, device: str, tp: int,
             iters: int) -> dict:
    """One rank of the dp x tp step: its ms per query, the transport, and
    (rank 0) the gathered result. The rank program of ``run_ranks``."""
    dev = compute_device(device)
    ctx = make_context(SchemeParams(**scheme), seed=1, device=dev)
    mesh = global_mesh(world // tp, tp, device=dev)
    fn, specs = sharded_pie_step(ctx, mesh)
    args = [host_to_global(mesh, specs[k], host[name]) for k, name in
            (("idx", "idx"), ("minus", "minus"), ("table", "table"), ("mask", "mask"),
             ("rlk", "rlk_b"), ("rlk", "rlk_a"))]
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()  # the ranks start the timed queries together
    ms = wall_ms(lambda: fn(*args), dev, iters, warm=0)
    out = global_to_host(fn(*args), mesh, specs["out"])
    return {"ms": ms, "transport": comm.transport(mesh.groups["tp"], dev),
            "result": out if rank == 0 else None}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", type=int, default=256)
    ap.add_argument("--limbs", type=int, default=8)
    ap.add_argument("--depths", type=int, default=8)
    ap.add_argument("--positions", type=int, default=8)
    ap.add_argument("--hashes", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2, help="tp of the --ranks mesh")
    ap.add_argument("--ranks", type=int, default=0, help="rank processes (0: none)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    device = resolve_device(a.device)
    built = small_pie.build_small_pie(ring=a.ring, limbs=a.limbs, H=a.hashes, P=a.positions,
                                      D=a.depths, simple=min(32, a.ring // 4), device=device)
    ctx, pie = built.ctx, built.pie
    rlk = pie.rlk

    def np32(x):
        return x.detach().cpu().numpy()

    host = dict(idx=np32(built.idx_ct.data), minus=np32(built.minus_ct.data),
                table=np32(pie.table_pt), mask=np32(pie.mask_pt), rlk_b=np32(rlk.b_mont),
                rlk_a=np32(rlk.a_mont))
    scheme = dict(ring_dim=a.ring, plaintext_modulus=ctx.t, num_limbs=a.limbs,
                  scheme=ctx.default_form)
    idx, minus = built.idx_ct.data, built.minus_ct.data

    def unsharded(i):
        return batched_pie_forward(ctx, rlk, i, minus, pie.table_pt, pie.mask_pt).data

    want = np32(unsharded(idx)).view(np.uint32)
    rows = [{"label": "1 device, unsharded", "ranks": 1, "transport": "none",
             "ms_per_query": wall_ms(lambda: unsharded(idx), device, a.iters)}]

    backend = "nccl" if device.type == "cuda" else "gloo"
    own_group = not dist.is_initialized()
    init_distributed(None, 1, 0, backend)
    try:
        one = _sharded(0, 1, scheme, host, device.type, 1, a.iters)
    finally:
        if own_group:
            dist.destroy_process_group()
    rows.append({"label": f"{backend}, world 1", "ranks": 1, "transport": one["transport"],
                 "ms_per_query": one["ms"], "bit_equal": bool(np.array_equal(one["result"], want))})
    if a.ranks:
        if device.type == "cuda":
            cuda_lib.get_lib()  # the ranks load the library this process builds
        outs = run_ranks(_sharded, a.ranks, "gloo",
                         (scheme, host, device.type, a.tp, a.iters), RANKS_TIMEOUT)
        rows.append({"label": f"{a.ranks} ranks, dp {a.ranks // a.tp} x tp {a.tp}, gloo",
                     "ranks": a.ranks, "transport": outs[0]["transport"],
                     "ms_per_query": max(o["ms"] for o in outs),
                     "bit_equal": bool(np.array_equal(outs[0]["result"], want))})
    base = a.depths / (rows[0]["ms_per_query"] / 1e3)
    for row in rows:
        row["rate"] = a.depths / (row["ms_per_query"] / 1e3)
        row["efficiency"] = row["rate"] / (base * row["ranks"])
    report = {"metric": "pie_depth_rows_per_sec",
              "config": {"ring": a.ring, "limbs": a.limbs, "depths": a.depths,
                         "positions": a.positions, "hashes": a.hashes,
                         "scheme": ctx.default_form},
              "device": device.type,
              "card": card.card_line() if device.type == "cuda" else "none (cpu: host clocks)",
              "rows": rows, "note": NOTE}
    print(json.dumps(report), flush=True)
    bad = [r["label"] for r in rows if r.get("bit_equal") is False]
    if bad:
        raise RuntimeError(f"sharded results differ from the unsharded step: {bad}")
    return report


if __name__ == "__main__":
    main()
