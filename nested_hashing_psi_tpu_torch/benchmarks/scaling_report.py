"""The batched-PIE online step at one device and on the ``parallel/`` mesh.

Counterpart of ``benchmarks/scaling_report.py``: depth rows per second
("ciphertext-ops": one depth row of the PIE online step) of

  1. one device, unsharded (``batched_pie_forward``, the full basis the
     sharded steps compute on);
  2. the dp x tp step (``parallel/mesh.py`` ``sharded_pie_step``) on a
     process group of one: ``--backend``, NCCL on the card by default
     (gloo on the CPU);
  3. with ``--ranks R``, the same step over R rank processes
     (``parallel/launch.py``) on a dp x tp mesh through gloo: on one card
     the ranks share it and each exchange is staged through host memory;
  (c) with ``--num-processes N`` (the JAX tool's multi-host mode), N
     processes launched on their own, each one rank, joined at
     ``--coordinator`` (``tcp://host:port``, ``host:port`` or ``file://``;
     process 0 serves a TCP store) through ``--backend``. Every process
     builds the same PIE from the same seed, and the processes check that
     their host inputs are identical (a digest gathered from every
     process). Each times row 1 on its own, one process after another;
     then all time the step on a (N / tp) x tp mesh, dp outermost so that
     it crosses the processes, as the JAX package lays it out. Row 2 is
     not measured (the process already belongs to the group of N), and
     only process 0 prints the report. ``--tp`` defaults to 1 here: one
     rank per process, so tp stays within one, as the JAX package keeps it
     within a host.

Every result is gathered and held bit-equal to the unsharded one (the
report fails otherwise, in every process), and the JSON line names each
row's transport. Ranks that share one card measure correctness and
per-rank compute, not scale-out: scale-out needs a card per rank.

    python -m nested_hashing_psi_tpu_torch.benchmarks.scaling_report \\
        --ring 16384 --limbs 8 --depths 16 [--ranks 4] [--device cuda]
    # one shell per process:
    python -m nested_hashing_psi_tpu_torch.benchmarks.scaling_report \\
        --ring 16384 --limbs 8 --depths 16 --coordinator tcp://HOST:PORT \\
        --num-processes 2 --process-id {0,1} [--backend gloo]

Each rate is the host clock over queries issued back to back
(``timing.wall_ms``) ending in a synchronise; across ranks, the slowest
rank's, after a barrier. Without ``--iters`` a row runs as many queries as
fill 1.5 s (at least 3), from one timed query, as the JAX tool does; the
ranks of a mesh agree on the fewest. The sharded rows carry each rank's K1
and K2 launches over its timed queries. ``--device cpu`` (or ``--cpu``)
runs it on the CPU (gloo ranks) for the tests.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch
import torch.distributed as dist

from nested_hashing_psi_tpu_torch.benchmarks import card, small_pie
from nested_hashing_psi_tpu_torch.benchmarks.timing import wall_ms
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda, pie_kernels
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
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

RANKS_TIMEOUT = 600.0  # s: the ranks' start, their builds and their queries
BUDGET_S = 1.5  # the JAX tool's time per row without --iters
NOTE = ("ranks sharing one card measure correctness and per-rank compute, not scale-out "
        "(each exchange of the staged gloo transport crosses host memory twice)")
HOST_INPUTS = ("idx", "minus", "table", "mask", "rlk_b", "rlk_a")


def _budget_iters(fn, device, iters: int | None) -> int:
    """``iters``, or the queries that fill BUDGET_S (at least 3), from one
    timed call after a warm one."""
    if iters:
        return iters
    per_s = wall_ms(fn, device, 1) / 1e3
    return max(3, int(BUDGET_S / max(per_s, 1e-5)))


def _launches() -> dict:
    return {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
            "pie_ip": pie_kernels.launches}


def _sharded(rank: int, world: int, scheme: dict, host: dict, device: str, tp: int,
             iters: int | None, want: np.ndarray) -> dict:
    """One rank of the dp x tp step: its ms per query, its K1 and K2
    launches over the timed queries, the transport, and whether the
    gathered result equals ``want``. The rank program of ``run_ranks``."""
    dev = compute_device(device)
    ctx = make_context(SchemeParams(**scheme), seed=1, device=dev)
    mesh = global_mesh(world // tp, tp, device=dev)
    fn, specs = sharded_pie_step(ctx, mesh)
    args = [host_to_global(mesh, specs[k], host[name]) for k, name in
            zip(("idx", "minus", "table", "mask", "rlk", "rlk"), HOST_INPUTS)]
    fn(*args)
    if iters is None:  # every rank runs the same queries: the fewest any rank's budget gives
        budgets = [None] * world
        dist.all_gather_object(budgets, _budget_iters(lambda: fn(*args), dev, None))
        iters = min(budgets)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()  # the ranks start the timed queries together
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    ms = wall_ms(lambda: fn(*args), dev, iters, warm=0)
    launches = _launches()
    out = global_to_host(fn(*args), mesh, specs["out"])
    return {"ms": ms, "launches": launches, "transport": comm.transport(mesh.groups["tp"], dev),
            "bit_equal": bool(np.array_equal(out, want))}


def _sharded_row(label: str, outs: list) -> dict:
    """A sharded row from every rank's ``_sharded``: the slowest rank's ms."""
    return {"label": label, "ranks": len(outs), "transport": outs[0]["transport"],
            "ms_per_query": max(o["ms"] for o in outs),
            "bit_equal": all(o["bit_equal"] for o in outs),
            "launches": [o["launches"] for o in outs]}


def _digest(host: dict) -> str:
    """sha256 over the host inputs, in ``HOST_INPUTS`` order."""
    h = hashlib.sha256()
    for name in HOST_INPUTS:
        a = np.ascontiguousarray(host[name])
        h.update(f"{name}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", type=int, default=256)
    ap.add_argument("--limbs", type=int, default=8)
    ap.add_argument("--depths", type=int, default=8)
    ap.add_argument("--positions", type=int, default=8)
    ap.add_argument("--hashes", type=int, default=2)
    ap.add_argument("--tp", type=int, default=None,
                    help="tp of the sharded mesh (default 2 for --ranks, 1 for --num-processes)")
    ap.add_argument("--coordinator", default=None,
                    help="tcp://host:port, host:port or file://path (--num-processes > 1)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--iters", type=int, default=None,
                    help="queries per row (default: as many as fill 1.5 s, at least 3)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--ranks", type=int, default=0, help="rank processes (0: none)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="of the world-1 row and --num-processes (default nccl on cuda, gloo "
                         "on cpu); --ranks always takes gloo")
    a = ap.parse_args(argv)
    if a.num_processes > 1 and a.ranks:
        ap.error("--ranks spawns local ranks; it cannot be combined with --num-processes > 1")
    if a.num_processes > 1 and not a.coordinator:
        ap.error(f"--num-processes {a.num_processes} needs --coordinator")
    if not 0 <= a.process_id < a.num_processes:
        ap.error(f"--process-id {a.process_id} is not in [0, {a.num_processes})")
    if a.cpu:
        a.device = "cpu"
    if a.tp is None:
        a.tp = 1 if a.num_processes > 1 else 2
    return a


def main(argv=None) -> dict:
    a = parse_args(argv)
    device = resolve_device(a.device)
    backend = a.backend or ("nccl" if device.type == "cuda" else "gloo")
    if a.num_processes == 1:
        return _report(a, device, backend)
    init_distributed(a.coordinator, a.num_processes, a.process_id, backend)
    try:
        return _report(a, compute_device(device), backend)
    finally:
        dist.destroy_process_group()


def _report(a: argparse.Namespace, device: torch.device, backend: str) -> dict:
    multi = a.num_processes > 1
    built = small_pie.build_small_pie(ring=a.ring, limbs=a.limbs, H=a.hashes, P=a.positions,
                                      D=a.depths, simple=min(32, a.ring // 4), device=device)
    ctx, pie = built.ctx, built.pie
    rlk = pie.rlk

    def np32(x):
        return x.detach().cpu().numpy()

    host = dict(zip(HOST_INPUTS, map(np32, (built.idx_ct.data, built.minus_ct.data,
                                            pie.table_pt, pie.mask_pt, rlk.b_mont,
                                            rlk.a_mont))))
    if multi:
        digests = [None] * a.num_processes
        dist.all_gather_object(digests, _digest(host))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the processes built different host inputs: {digests}")
    scheme = dict(ring_dim=a.ring, plaintext_modulus=ctx.t, num_limbs=a.limbs,
                  scheme=ctx.default_form)
    idx, minus = built.idx_ct.data, built.minus_ct.data

    def unsharded():
        return batched_pie_forward(ctx, rlk, idx, minus, pie.table_pt, pie.mask_pt).data

    want = np32(unsharded()).view(np.uint32)

    def time_unsharded() -> float:
        return wall_ms(unsharded, device, _budget_iters(unsharded, device, a.iters))

    if multi:  # one process after another, so that processes sharing a card do not slow it
        for turn in range(a.num_processes):
            if turn == a.process_id:
                one_ms = time_unsharded()
            dist.barrier()
    else:
        one_ms = time_unsharded()
    rows = [{"label": "1 device, unsharded", "ranks": 1, "transport": "none",
             "ms_per_query": one_ms}]

    if multi:
        outs = [None] * a.num_processes
        dist.all_gather_object(outs, _sharded(a.process_id, a.num_processes, scheme, host,
                                              device.type, a.tp, a.iters, want))
        rows.append(_sharded_row(f"{a.num_processes} processes, dp {a.num_processes // a.tp} "
                                 f"x tp {a.tp}, {backend}", outs))
    else:
        own_group = not dist.is_initialized()
        init_distributed(None, 1, 0, backend)
        try:
            one = _sharded(0, 1, scheme, host, device.type, 1, a.iters, want)
        finally:
            if own_group:
                dist.destroy_process_group()
        rows.append(_sharded_row(f"{backend}, world 1", [one]))
    if a.ranks:
        if device.type == "cuda":
            cuda_lib.get_lib()  # the ranks load the library this process builds
        outs = run_ranks(_sharded, a.ranks, "gloo",
                         (scheme, host, device.type, a.tp, a.iters, want), RANKS_TIMEOUT)
        rows.append(_sharded_row(f"{a.ranks} ranks, dp {a.ranks // a.tp} x tp {a.tp}, gloo",
                                 outs))
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
    if a.process_id == 0:
        print(json.dumps(report), flush=True)
    bad = [r["label"] for r in rows if r.get("bit_equal") is False]
    if bad:
        raise RuntimeError(f"sharded results differ from the unsharded step: {bad}")
    return report


if __name__ == "__main__":
    main()
