#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from nested_hashing_psi_tpu_torch/csrc
   (nvcc, sm_90a) and holds each against its plain PyTorch version on the
   card at the main path's shapes (bit-exact), timing both with CUDA events;
2. drives the port's main path through its user entry points
   (``cli.parse_args`` + ``protocol.runner.run_in_process``): BatchedFHE
   with BFV at the 2^20-server x 2048-client geometry, ring 16384, once with
   one query and once with ``--queries 4``; each run must self-verify
   "Set matches!" with 1024 items found;
3. checks that the main path launched every kernel (launch counters reset
   just before it, read just after).

It prints the card's name and power limit, one JSON line listing the
kernels, and as its last line {"ok": true, "device": {...}}. Any failure
exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_FLAGS = [
    "-F", "--batched", "-B", "32", "-S", "1048576", "-C", "2048", "-I", "1024",
    "-e", "8022", "-E", "12", "-b", "12", "-k", "2", "-K", "2",
    "--device", "cuda",
]
EXPECTED_FOUND = 1024


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events, warmed)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def compare(name, kernel_fn, plain_fn, iters=20, plain_iters=3):
    """Run kernel and plain version on the same inputs; exact comparison."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel {tuple(got.shape)}/{got.dtype} vs plain "
             f"{tuple(want.shape)}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max().item())
    ms = time_ms(kernel_fn, iters)
    plain_ms = time_ms(plain_fn, plain_iters)
    print(f"[kernel] {name}: shape {tuple(got.shape)} max_abs_err {err} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain version (max_abs_err {err})")
    return err, ms, plain_ms


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch

        from nested_hashing_psi_tpu_torch import cli
        from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
        from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda, pie_kernels
        from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
        from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    print(f"[env] {smi_line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.get_lib()
    print(f"[build] {len(cuda_lib.sources())} sources -> {cuda_lib.LIB_PATH} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- kernels vs plain at the main path's shapes ---------------------
    T = (1 << 32) + (1 << 20) + (1 << 19) + 1
    N, L = 16384, 6
    q = ntt_primes(L, 31, 2 * N, avoid=(T,))
    mul = bfv_mul_limbs(T.bit_length(), L, 1, ring_dim=N)
    aux = BFVMulConverter(q[:mul], T, N).aux_primes
    rng = np.random.default_rng(0)

    def residues(shape, ps):
        p = np.array(ps, np.int64).reshape(len(ps), 1)
        return torch.from_numpy(
            (rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32)
        ).to(dev)

    results = {}
    # the HPS operand transforms: (2 operands, D = 12 depths, 2 components)
    for base, ps in (("q", q), ("aux", aux)):
        plan = NTTPlan(N, ps)
        x = residues((2, 12, 2, len(ps), N), ps)
        y = ntt(x, plan)
        results[f"ntt_{base}"] = compare(
            f"K1 forward NTT, {base} base (L={len(ps)})",
            lambda: ntt_cuda.ntt(x, plan), lambda: ntt(x, plan))
        results[f"intt_{base}"] = compare(
            f"K1 inverse NTT, {base} base (L={len(ps)})",
            lambda: ntt_cuda.intt(y, plan), lambda: intt(y, plan))
    H, D, P = 2, 12, 12
    tb = NTTPlan(N, q).tensors(dev)
    idx = residues((H, P, 2, L, N), q)
    pt = residues((H, D, P, L, N), q)
    results["pie_ip"] = compare(
        f"K2 position sum (H,D,P,L,N)=({H},{D},{P},{L},{N})",
        lambda: pie_kernels.indexed_inner_product(idx, pt, tb["p"], tb["pinv"]),
        lambda: pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"]),
        plain_iters=2)
    del x, y, idx, pt
    torch.cuda.empty_cache()

    # ---- the main path -------------------------------------------------
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for queries in (1, 4):
        psi, ht, device = cli.parse_args(MAIN_FLAGS + ["--queries", str(queries)])
        t0 = time.perf_counter()
        client, server, ok = run_in_process(psi, ht, device=device)
        wall = time.perf_counter() - t0
        found = len(client.intersection_calculated)
        m = client.measurements
        print(f"[main] queries={queries} ring={psi.ring_dim} L={server.ctx.L} "
              f"mul_limbs={server.pie.mul_limbs} ship_limbs={server.pie.ship_limbs} "
              f"table_pt={tuple(server.pie.table_pt.shape)} found={found} "
              f"noise_bits={client.noise_bits:.1f} wall {wall:.2f} s | "
              f"setup {m['Setup'].duration_us / 1e6:.3f} s offline "
              f"{m['Offline'].duration_us / 1e6:.3f} s online "
              f"{m['Online'].duration_us / 1e6:.3f} s | server offline "
              f"{server.offline_computation_us / 1e6:.3f} s online "
              f"{server.online_computation_us / 1e3:.3f} ms = "
              f"{server.online_computation_us / 1e3 / queries:.3f} ms/query", flush=True)
        if not ok or found != EXPECTED_FOUND:
            fail(f"main path (queries={queries}) did not verify: ok={ok} found={found}")
    launches = {
        "ntt_fwd": ntt_cuda.launches["ntt"],
        "ntt_inv": ntt_cuda.launches["intt"],
        "pie_ip": pie_kernels.launches,
    }
    print(f"[main] kernel launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the main path did not launch every kernel: {launches}")
    if "jax" in sys.modules:
        fail("jax was imported")

    def entry(name, source, replaces, key):
        err, ms, plain_ms = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

    csrc = "nested_hashing_psi_tpu_torch/csrc"
    kernels = [
        entry("ntt_fwd", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:631", "ntt_q"),
        entry("ntt_inv", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:645", "intt_q"),
        entry("pie_ip", f"{csrc}/pie_ip.cu", "nested_hashing_psi_tpu/ops/pie_kernels.py:48", "pie_ip"),
    ]
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
