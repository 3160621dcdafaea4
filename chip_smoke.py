#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from nested_hashing_psi_tpu_torch/csrc
   (one nvcc per source, in parallel, sm_90a) and holds each against its
   plain PyTorch version on the card at the main path's shapes (bit-exact),
   timing both with CUDA events: K1 (NTT, q and aux bases), K2 (position
   sum, whole table and an in-place slice p0 = 3, w = 3 of P = 12) and K3
   (the int8 tensor-core NTT, q and aux bases, also held against K1; K3
   has no caller on the protocol path, so its launches come from this phase);
2. drives the port's main path through its user entry points
   (``cli.parse_args`` + ``protocol.runner.run_in_process``): BatchedFHE
   with BFV at the 2^20-server x 2048-client geometry, ring 16384, three
   times -- one query, ``--queries 4`` and ``--streamChunks 4`` -- each
   self-verifying "Set matches!" with 1024 items found; the client decrypts
   on the device. Launch counters are reset just before each run and read
   just after it; each run must have launched K1 and K2;
3. decrypts the one-query server's result on the device (zero mask) and on
   the host, which must agree, and times both;
4. builds the one-query server's table twice more with one mask seed, on
   the device and host-resident (pinned, uploaded in position slices), and
   checks that run() is bit-equal, with the default slice rule and with
   pos_chunk = 3, timing each.

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
RUNS = (("queries=1", []), ("queries=4", ["--queries", "4"]),
        ("streamChunks=4", ["--streamChunks", "4"]))
EXPECTED_FOUND = 1024
MASK_SEED = 20240601


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


def wall_ms(fn, iters: int) -> float:
    """Mean host-clock time of fn() ending in a synchronize (warmed once)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def max_err(got, want, name: str) -> int:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    return int((got.long() - want.long()).abs().max().item())


def compare(name, kernel_fn, plain_fn, iters=20, plain_iters=3):
    """Run kernel and plain version on the same inputs; exact comparison."""
    err = max_err(kernel_fn(), plain_fn(), name)
    ms = time_ms(kernel_fn, iters)
    plain_ms = time_ms(plain_fn, plain_iters)
    print(f"[kernel] {name}: max_abs_err {err} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms", flush=True)
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain version (max_abs_err {err})")
    return err, ms, plain_ms


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch

        from nested_hashing_psi_tpu_torch import cli
        from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
        from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
        from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda, ntt_mxu, pie_kernels
        from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
        from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
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
            f"K1 forward NTT, {base} base (2,12,2,{len(ps)},{N})",
            lambda: ntt_cuda.ntt(x, plan), lambda: ntt(x, plan))
        results[f"intt_{base}"] = compare(
            f"K1 inverse NTT, {base} base (2,12,2,{len(ps)},{N})",
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
    idx_s = idx[:, 3:6].contiguous()
    results["pie_ip_slice"] = compare(
        "K2 position sum over table positions [3, 6) of P = 12, in place",
        lambda: pie_kernels.indexed_inner_product(idx_s, pt, tb["p"], tb["pinv"], p0=3),
        lambda: pie_kernels.indexed_inner_product_plain(idx_s, pt, tb["p"], tb["pinv"], p0=3),
        plain_iters=2)
    # K2's launch alone, constants prepared once: how much of the wrapper's
    # event time above is the host preparing each call
    lib, stream = cuda_lib.get_lib(), torch.cuda.current_stream().cuda_stream
    consts = [pie_kernels._u32_bits(tb[k]) for k in ("p", "pinv")]
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=dev)
    for label, ii, p0 in (("whole table", idx, 0), ("slice [3, 6)", idx_s, 3)):
        raw_ms = time_ms(lambda: lib.nhpsi_pie_ip(
            ii.data_ptr(), pt.data_ptr(), out.data_ptr(), consts[0].data_ptr(),
            consts[1].data_ptr(), H, D, ii.shape[1], L, N, p0, P, stream), 20)
        print(f"[kernel] K2 launch alone, {label}: {raw_ms:.4f} ms", flush=True)
    del idx, pt, idx_s, out

    # ---- K3: its own phase (no caller on the protocol path) ------------
    ntt_mxu.reset_launches()
    k3 = {}
    for base, ps in (("q", q), ("aux", aux)):
        plan, mplan = NTTPlan(N, ps), ntt_mxu.MxuNTTPlan(N, ps)
        x = residues((2, 12, 2, len(ps), N), ps)
        k3[base] = (plan, mplan, x, ntt_mxu.ntt_mxu(x, mplan))
        k3[base] += (ntt_mxu.intt_mxu(k3[base][3], mplan),)
    torch.cuda.synchronize()
    k3_launches = {"ntt_mxu_fwd": ntt_mxu.launches["ntt"],
                   "ntt_mxu_inv": ntt_mxu.launches["intt"]}
    for base, (plan, mplan, x, y, back) in k3.items():
        shape = f"{base} base (2,12,2,{plan.L},{N})"
        e_k1 = max(max_err(y, ntt_cuda.ntt(x, plan), "K3 fwd vs K1"),
                   max_err(back, ntt_cuda.intt(y, plan), "K3 inv vs K1"),
                   max_err(back, x, "K3 round trip"))
        if e_k1 != 0:
            fail(f"K3 disagrees with K1 on the {shape} (max_abs_err {e_k1})")
        for key, name, kfn, pfn, k1fn in (
            ("fwd", "forward", lambda: ntt_mxu.ntt_mxu(x, mplan),
             lambda: ntt_mxu.ntt_mxu_plain(x, mplan), lambda: ntt_cuda.ntt(x, plan)),
            ("inv", "inverse", lambda: ntt_mxu.intt_mxu(y, mplan),
             lambda: ntt_mxu.intt_mxu_plain(y, mplan), lambda: ntt_cuda.intt(y, plan)),
        ):
            err, ms, plain_ms = compare(f"K3 {name} NTT, {shape}", kfn, pfn)
            k1_ms = time_ms(k1fn, 20)
            print(f"[kernel] K3 {name} NTT, {shape}: max_abs_err vs K1 {e_k1}; "
                  f"K3 {ms:.4f} ms, K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            results[f"ntt_mxu_{key}_{base}"] = (max(err, e_k1), ms, plain_ms, k1_ms)
    del k3
    torch.cuda.empty_cache()

    # ---- the main path: three protocol runs ----------------------------
    launches, peaks = {"ntt_fwd": 0, "ntt_inv": 0, "pie_ip": 0}, []
    runs = {}
    for label, extra in RUNS:
        ntt_cuda.reset_launches()
        pie_kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        psi, ht, device = cli.parse_args(MAIN_FLAGS + extra)
        t0 = time.perf_counter()
        client, server, ok = run_in_process(psi, ht, device=device)
        wall = time.perf_counter() - t0
        got = {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
               "pie_ip": pie_kernels.launches}
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        found = len(client.intersection_calculated)
        Q = psi.num_queries
        m = client.measurements
        noise = "n/a (device decrypt)" if client.noise_bits is None else f"{client.noise_bits:.1f}"
        print(f"[main] {label} ring={psi.ring_dim} L={server.ctx.L} "
              f"mul_limbs={server.pie.mul_limbs} ship_limbs={server.pie.ship_limbs} "
              f"table_pt={tuple(server.pie.table_pt.shape)} host_table={server.pie.host_table} "
              f"found={found} noise_bits={noise} wall {wall:.2f} s | "
              f"setup {m['Setup'].duration_us / 1e6:.3f} s offline "
              f"{m['Offline'].duration_us / 1e6:.3f} s online "
              f"{m['Online'].duration_us / 1e6:.3f} s | server offline "
              f"{server.offline_computation_us / 1e6:.3f} s online "
              f"{server.online_computation_us / 1e3:.3f} ms = "
              f"{server.online_computation_us / 1e3 / Q:.3f} ms/query | launches {got} "
              f"| peak device memory {peaks[-1]:.3f} GiB", flush=True)
        if not ok or found != EXPECTED_FOUND:
            fail(f"main path ({label}) did not verify: ok={ok} found={found}")
        if min(got.values()) <= 0:
            fail(f"the main path ({label}) did not launch every kernel: {got}")
        if not client._decryptors:
            fail(f"the client ({label}) did not decrypt on the device")
        for k in launches:
            launches[k] += got[k]
        runs[label] = (client, server)
    print(f"[main] kernel launches over the three runs {launches}", flush=True)

    # ---- device decrypt vs host decrypt on the one-query result ---------
    client, server = runs["queries=1"]
    result = server.pie.run(client.idx_ct, client.minus_ct)
    L_ship = result.data.shape[-2]
    dctx = client.ctx.context_for_limbs(L_ship)
    dsk = client.ctx.shrink_key_to(client.sk, L_ship)
    batch = client.ht.batch_slots
    t0 = time.perf_counter()
    dec = DeviceDecryptor(dctx)
    build_ms = (time.perf_counter() - t0) * 1e3
    mask_dev = dec.zero_mask(result.data, dsk.s_mont, batch).cpu().numpy()
    slots, _ = dctx.decrypt(result, dsk, length=batch)
    mask_host = np.asarray(slots, dtype=object) == 0
    if mask_dev.shape != mask_host.shape or not (mask_dev == mask_host).all():
        fail("the device decrypt's zero mask differs from the host decrypt's")
    dev_ms = time_ms(lambda: dec.zero_mask(result.data, dsk.s_mont, batch), 10)
    dev_wall = wall_ms(lambda: dec.zero_mask(result.data, dsk.s_mont, batch).cpu(), 5)
    host_ms = wall_ms(lambda: dctx.decrypt(result, dsk, length=batch), 3)
    print(f"[decrypt] result {tuple(result.data.shape)}: device zero mask == host "
          f"decrypt mask ({int(mask_dev.sum())} zero slots); device {dev_ms:.3f} ms "
          f"(CUDA events), {dev_wall:.3f} ms with the mask's copy to the host; "
          f"host decrypt {host_ms:.3f} ms; decryptor constants built in {build_ms:.1f} ms",
          flush=True)

    # ---- host-resident table vs device table, same mask seed ------------
    t0 = time.perf_counter()
    pie_dev = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=MASK_SEED)
    t1 = time.perf_counter()
    pie_host = BatchedFHEPIE(server.ctx, server.server_table, server.rlk,
                             mask_seed=MASK_SEED, host_table=True)
    t2 = time.perf_counter()
    if not pie_host.table_pt.is_pinned():
        fail("the host-resident table is not in pinned memory")
    i_ct, m_ct = client.idx_ct, client.minus_ct
    want = pie_dev.run(i_ct, m_ct).data
    ms_dev = wall_ms(lambda: pie_dev.run(i_ct, m_ct), 5)
    for pos_chunk in (None, 3):
        got = pie_host._run_host_table(i_ct, m_ct, pos_chunk).data
        if max_err(got, want, "host table") != 0:
            fail(f"host-table PIE (pos_chunk={pos_chunk}) differs from the device table")
        ms_host = wall_ms(lambda: pie_host._run_host_table(i_ct, m_ct, pos_chunk), 5)
        print(f"[host_table] pos_chunk={pos_chunk}: run() bit-equal to the device "
              f"table; online {ms_host:.3f} ms vs device table {ms_dev:.3f} ms "
              f"(table {pie_host.table_pt.numel() * 4 / 2**20:.1f} MiB pinned; build "
              f"{t2 - t1:.2f} s host vs {t1 - t0:.2f} s device)", flush=True)
    if "jax" in sys.modules:
        fail("jax was imported")

    def entry(name, source, replaces, key, launched, **extra):
        err, ms, plain_ms = results[key][:3]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **extra}

    csrc = "nested_hashing_psi_tpu_torch/csrc"
    k3_note = "own phase: K3 has no caller on the protocol path"
    kernels = [
        entry("ntt_fwd", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:631",
              "ntt_q", launches["ntt_fwd"]),
        entry("ntt_inv", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:645",
              "intt_q", launches["ntt_inv"]),
        entry("pie_ip", f"{csrc}/pie_ip.cu", "nested_hashing_psi_tpu/ops/pie_kernels.py:48",
              "pie_ip", launches["pie_ip"]),
        entry("ntt_mxu_fwd", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:323",
              "ntt_mxu_fwd_q", k3_launches["ntt_mxu_fwd"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_fwd_q"][3]),
        entry("ntt_mxu_inv", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:330",
              "ntt_mxu_inv_q", k3_launches["ntt_mxu_inv"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_inv_q"][3]),
    ]
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
