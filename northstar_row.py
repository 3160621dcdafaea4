#!/usr/bin/env python3
"""The BASELINE.json north-star row through the port on one GPU: a 2^24-item
server set against a 2^12-item client set, batched BFV at ring 16384 with
32-bit items, 2 x 4505 client slots and 48 x 48 inner tables (the geometry
bench_e2e_psi derives), bit-exact intersection.

    python3 northstar_row.py [--out build/northstar] [--server-log2 24] [--client-log2 12]

1. ``python -m nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi
   --buildOnly --checkpoint OUT/ns<log2>.npz`` in a fresh process: the
   offline build, the client's query, the v3 artifact and its sidecar;
2. ``... --resume OUT/ns<log2>.npz`` in another fresh process, which must
   print "Set matches!" and launch K1 and K2;
3. in this process: the artifact loaded once more, its online step timed at
   steady state (chip_smoke.trace_online: 20 queries after 3 warm-ups,
   then 10 traced by torch.profiler; device time by K1, K2 and the plain
   kernels, busy share), and K2 at the row's shape through its wrapper
   beside its bound (chip_smoke.k2_bound) and its plain version, which it
   must equal (the plain version run in depth slices);
4. profile_build's split of the offline build on the card at this row and
   at the 2^20 main row (-e 8022 -E 12 -b 12), read from the build's own
   spans (``build.insert``, ``build.encode``), the split the benchmark's
   cell reads.

Every time is printed beside the card's name and power limit and the host
CPU, and a JSON line at the end holds them all. It fails (exit 1) on any
mismatch. OUT is under build/ (ignored by git); the artifact at 2^24 is
about 2 GB.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import host_cpu, k2_bound, trace_online  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks import profile_build  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi import (  # noqa: E402
    geometry,
    sidecar_path,
)
from nested_hashing_psi_tpu_torch.benchmarks.card import card_line  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks.timing import time_ms  # noqa: E402
from nested_hashing_psi_tpu_torch.convert import from_numpy  # noqa: E402
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext  # noqa: E402
from nested_hashing_psi_tpu_torch.ops import pie_kernels  # noqa: E402
from nested_hashing_psi_tpu_torch.utils.checkpoint import load_batched_pie  # noqa: E402

BENCH = [sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi"]
MAIN_ROW_PROFILE = ["20", "--simpleSize", "8022", "--inner", "12"]


def run_bench(args: list[str], label: str) -> tuple[str, float]:
    """One bench_e2e_psi process on the GPU; its output echoed. -> (stdout,
    wall seconds). Exits 1 unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(BENCH + args + ["--device", "cuda"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=3000)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[northstar] {label}: {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"northstar_row: {label} failed (rc {proc.returncode}):\n"
                         f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout, wall


def k2_at_row(pie, idx: torch.Tensor, depth_slice: int = 4) -> dict:
    """K2 on the row's own table and query through the wrapper, against its
    plain version run over depth slices (its (H, d, P, 2, L, N) int64
    products at once would need tens of GB)."""
    ctx = pie.ctx
    H, D, P, L, N = pie.table_pt.shape

    def kernel():
        return pie_kernels.indexed_inner_product(idx, pie.table_pt, ctx.p_u32, ctx.pinv_u32)

    def plain():
        return torch.cat([pie_kernels.indexed_inner_product_plain(
            idx, pie.table_pt[:, d0:d0 + depth_slice], ctx.p, ctx.pinv)
            for d0 in range(0, D, depth_slice)], dim=1)

    if not torch.equal(kernel(), plain()):
        raise SystemExit("northstar_row: K2 differs from its plain version at the row's shape")
    b_ms, b_by = k2_bound(H, D, P, L, N)
    return {"shape": [H, D, P, L, N], "max_abs_err": 0, "ms": time_ms(kernel, "cuda", 20),
            "plain_ms": time_ms(plain, "cuda", 2), "bound_ms": b_ms, "bound_by": b_by}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "northstar"))
    ap.add_argument("--server-log2", type=int, default=24)
    ap.add_argument("--client-log2", type=int, default=12)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("northstar_row: needs a GPU (torch.cuda.is_available() is false)")
    card, cpu = card_line(), host_cpu()
    print(f"[northstar] card {card} | host CPU {cpu}", flush=True)
    os.makedirs(a.out, exist_ok=True)
    art = os.path.join(a.out, f"ns{a.server_log2}.npz")
    row = ["--server-log2", str(a.server_log2), "--client-log2", str(a.client_log2)]
    res = {"card": card, "host_cpu": cpu}

    out, res["build_process_s"] = run_bench(row + ["--checkpoint", art, "--buildOnly"],
                                            "--buildOnly")
    m = re.search(r"offline done ([0-9.]+)s \(server offline compute ([0-9.]+)s\)", out)
    res["client_offline_s"], res["server_offline_compute_s"] = map(float, m.groups())
    res["save_s"] = float(re.search(r"checkpoint saved ([0-9.]+)s", out).group(1))
    res["artifact_bytes"] = os.path.getsize(art)
    res["sidecar_bytes"] = os.path.getsize(sidecar_path(art))

    out, res["resume_process_s"] = run_bench(["--resume", art], "--resume")
    if "RESUME RESULT: Set matches!" not in out:
        raise SystemExit("northstar_row: the fresh-process resume did not verify")
    m = re.search(r"load ([0-9.]+)s, online query ([0-9.]+)s, decrypt ([0-9.]+)s", out)
    res["resume_load_s"], res["resume_query_s"], res["resume_decrypt_s"] = map(float, m.groups())
    res["resume_launches"] = json.loads(out.split("kernel launches ", 1)[1].splitlines()[0])
    res["found"] = int(re.search(r"\|intersection\| (\d+)", out).group(1))
    if min(res["resume_launches"].values()) <= 0:
        raise SystemExit(f"northstar_row: the resume did not launch K1 and K2: "
                         f"{res['resume_launches']}")

    t0 = time.perf_counter()
    pie = load_batched_pie(art, device="cuda")
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    with np.load(sidecar_path(art)) as z:
        idx = Ciphertext(from_numpy(z["idx"], "cuda"), pie.ctx.default_form)
        minus = Ciphertext(from_numpy(z["minus"], "cuda"), pie.ctx.default_form)
    res["L"], res["table_shape"] = pie.ctx.L, list(pie.table_pt.shape)
    res["host_table"] = pie.host_table
    tr = trace_online(lambda: pie.run(idx, minus))
    res["online"] = {k: v for k, v in tr.items() if k != "k1_kernels"}
    device_ms = sum(tr[f"{g}_ms_per_query"] for g in ("K1", "K2", "plain"))
    print(f"[northstar] online step, one query, steady state: wall median "
          f"{tr['wall_ms_median']:.3f} ms (min {tr['wall_ms_min']:.3f}, max "
          f"{tr['wall_ms_max']:.3f}) over 20 queries; traced 10: device {device_ms:.3f} ms/query, "
          f"K1 {tr['K1_ms_per_query']:.4f} ms ({tr['K1_launches_per_query']:.0f} kernels), K2 "
          f"{tr['K2_ms_per_query']:.4f} ms ({tr['K2_launches_per_query']:.0f}), plain PyTorch "
          f"{tr['plain_ms_per_query']:.3f} ms ({tr['plain_launches_per_query']:.0f}); busy share "
          f"{tr['busy_share']:.3f} | card {card}", flush=True)
    res["k2"] = k2_at_row(pie, idx.data)
    k2 = res["k2"]
    print(f"[northstar] K2 at {tuple(k2['shape'])}: bit-equal with plain; kernel "
          f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.2f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}), share {k2['bound_ms'] / k2['ms']:.3f} | card {card}", flush=True)
    del pie, idx, minus
    torch.cuda.empty_cache()

    simple, inner = geometry(1 << a.server_log2, 1 << a.client_log2)
    res["profile_row"] = profile_build.main(
        [str(a.server_log2), "--simpleSize", str(simple), "--inner", str(inner)])
    res["profile_main_row"] = profile_build.main(MAIN_ROW_PROFILE)
    print(f"[northstar] host CPU {cpu} | card {card}", flush=True)
    print(f"[northstar] {json.dumps(res)}", flush=True)
    return res


if __name__ == "__main__":
    main()
