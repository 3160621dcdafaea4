#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from nested_hashing_psi_tpu_torch/csrc
   (one nvcc per source, in parallel, sm_90a) and holds each against its
   plain PyTorch version on the card at the main path's shapes (bit-exact),
   timing both with CUDA events: K1 (NTT, q and aux bases, then the nine K1
   launches of one server query, each also replayed from a CUDA graph, in
   the form the kernel chose and in both forced forms, with its bound and
   share of it), K2 (position sum, whole table and an in-place slice
   p0 = 3, w = 3 of P = 12) and K3 (the int8 tensor-core NTT, q and aux
   bases, also held against K1, beside its digit products alone as
   torch._int_mm from a CUDA graph; K3 has no caller on the protocol path,
   so its launches come from this phase). The [sass] step counts K3's
   wgmma (IGMMA) and bulk-copy (UBLKCP, UTMALDG) instructions and fails
   without them. Then K2 at flat --bgv's L = 9, K1 at the BGV paths' shapes
   (the full-basis relin decompose at L = 9, the leveled chain's switches
   and relin at 6 and 5 limbs, the SimpleFHE Galois key switches), and
   ``mod_switch`` on the card against the port on the CPU (bit-equal).
   The [sass] step also counts the three probes' instructions (A1 per
   application of each op mix, by pipe, failing if a chain was folded:
   fewer than one application can take; A2's and A3's per butterfly;
   LDS/STS in A3's moves, failing without them). The [probe] phase drives
   the probe path, the three probes' ``main`` (benchmarks/ of the port) at
   their full shapes, with their launch counts set to 0 just before and
   read just after: A1 the uint32 op mixes at (64, 128, 128), K = 64, then
   at K = 2^15 for the rates; A2 the lazy butterfly forms and A3 the NTT
   anatomy at (512, 6, 16384), each beside K1 on the same input. Each
   ``main`` holds every variant, and K1, against its plain version on the
   card, bit-exact (fmul: NaNs as one class), and raises otherwise;
2. drives the port's main path through its user entry points
   (``cli.parse_args`` + ``protocol.runner.run_in_process``): BatchedFHE
   with BFV at the 2^20-server x 2048-client geometry, ring 16384, three
   times -- one query, ``--queries 4`` and ``--streamChunks 4`` -- each
   self-verifying "Set matches!" with 1024 items found; the client decrypts
   on the device. Launch counters are reset just before each run and read
   just after it; each run must have launched K1 and K2;
3. times the one-query server's online step at steady state (host clock,
   20 queries) and traces 10 more with torch.profiler: device time per
   query by kernel (K1, K2, the plain PyTorch kernels; K1 also by kernel
   instance) and the device's busy share of the traced span;
4. decrypts the one-query server's result on the device (zero mask) and on
   the host, which must agree, and times both;
5. builds the one-query server's table twice more with one mask seed, on
   the device and host-resident (pinned, uploaded in position slices), and
   checks that run() is bit-equal, with the default slice rule and with
   pos_chunk = 3, timing each;
6. drives three more paths the same way: ``--bgv`` at the main geometry
   (flat BGV, L = 9; 1024 found, the client decrypts on the host), ``--bgv
   -B 16`` leveled on the main geometry's table with a 4096-item server
   (L = 6, the result ships 5 limbs; 128 found), both launching K1 and K2
   and traced as in 3, and SimpleFHE at full width and reduced scale (32
   inner tables at L = 7; 8 found, K1 launched, the client decrypts on
   the device; traced over 3 timed and 2 traced queries). The kernel
   line's launches sum all six runs.

It fails if jax or the JAX package nested_hashing_psi_tpu was imported. It
prints the card's name and power limit, one JSON line listing the kernels
(each with its bound: the larger of its bytes over 3.35 TB/s and its
operations over the card's peak rate for their type), and as its last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that line;
so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# --bgv at the main geometry: flat BGV at 32-bit items (L = 9 from the
# package's own rules)
BGV_FLAGS = MAIN_FLAGS + ["--bgv"]
# --bgv -B 16, leveled (L = 6, the result ships 5 limbs): the main
# geometry's table and slots, a 4096-item server set (16-bit items repeat
# rarely at this size; the generator draws with replacement)
LEVELED_FLAGS = [
    "-F", "--batched", "--bgv", "-B", "16", "-S", "4096", "-C", "256", "-I", "128",
    "-e", "8022", "-E", "12", "-b", "12", "-k", "2", "-K", "2", "--device", "cuda",
]
# SimpleFHE (-F without --batched) at full width (ring 16384, 32-bit items,
# -E 12 -b 12 -k 2 -K 2), reduced scale: 32 inner tables, 768 packed
# plaintexts at L = 7
SIMPLE_FLAGS = [
    "-F", "-B", "32", "-S", "1024", "-C", "16", "-I", "8",
    "-e", "16", "-E", "12", "-b", "12", "-k", "2", "-K", "2", "--device", "cuda",
]
T16 = 65537

# H100 SXM peaks for the bounds: 3.35 TB/s of HBM3 and 1,979 T int8
# tensor-core ops/s (NVIDIA's data sheet). 32-bit integer instructions run
# on two pipes of 64 lanes per clock per SM (CUDA C Programming Guide,
# compute capability 9.0): multiplies on the FMA pipe, min/max and the
# fused add-min on the ALU pipe, adds on either; the four schedulers issue
# one warp instruction per clock each, 128 lanes per clock per SM in all,
# which a mix balanced over the two pipes reaches: 128 x 132 SMs x 1.98 GHz
# = 33.5 T ops/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
INT32_OPS_S = 128 * 132 * 1.98e9
# A butterfly: a Shoup product (IMAD.HI, IMAD, IMAD on the FMA pipe; a
# VIADDMNMX conditional subtract), an add_mod and a sub_mod (an IADD3 and a
# VIADDMNMX each): 8 instructions, 3 of them tied to the FMA pipe and 3 to
# the ALU pipe, so they balance.
BUTTERFLY_OPS = 8
SHOUP_OPS = 4       # the inverse's n^-1: a second Shoup product in its last stage
MONT_OPS = 6        # 32x32->64 product, one low and one high multiply, csub
ADD_OPS = 3
# The nine K1 launches of one server query at L = 6, mul_limbs 5,
# ship_limbs 4, 8 aux limbs, D = 12 (fhe/bfv.py hps_mul_relin_rescaled and
# _hps_core, fhe/bgv.py _key_switch_coeffs): (label, inverse, leading
# shape, basis).
K1_QUERY_LAUNCHES = (
    ("1 operands to coefficients", True, (2, 12, 2), "q6"),
    ("2 ntt_m", False, (2, 12, 2), "q5"),
    ("3 eab, aux base", False, (2, 12, 2), "aux"),
    ("4 d_q", True, (12, 3), "q5"),
    ("5 d_aux, aux base", True, (12, 3), "aux"),
    ("6 d01", False, (12, 2), "q5"),
    ("7 key-switch digits", False, (12, 5), "q5"),
    ("8 ship, inverse", True, (12, 2), "q5"),
    ("9 ship, forward", False, (12, 2), "q4"),
)


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() replayed from a CUDA graph of iters calls:
    the kernels' time without the host's pace between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (and set attributes) outside the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * iters)


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


def bound(ops: float, ops_per_s: float, nbytes: float) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(rows: int, L: int, n: int, inverse: bool) -> tuple[float, str]:
    """K1 on rows x n residues: n/2 log n butterflies per row (plus, for the
    inverse, n/2 Shoup products for the n^-1 scale folded into its last
    stage); each row read and written once, plus the twiddle pairs of the L
    primes."""
    logn = n.bit_length() - 1
    ops = rows * (n // 2) * (logn * BUTTERFLY_OPS + (SHOUP_OPS if inverse else 0))
    return bound(ops, INT32_OPS_S, rows * n * 8 + L * n * 8 + L * 12)


def k2_bound(H: int, D: int, P: int, L: int, N: int) -> tuple[float, str]:
    """K2: index (H,P,2,L,N) and the P table positions read once, out
    (H,D,2,L,N) written once; P Montgomery products and adds per output."""
    out = H * D * 2 * L * N
    return bound(out * P * (MONT_OPS + ADD_OPS), INT32_OPS_S,
                 4 * (H * P * 2 * L * N + H * D * P * L * N + out) + 8 * L)


def k3_bound(rows: int, L: int, n: int, m1: int, digits: int) -> tuple[float, str]:
    """K3: two digit-stacked matrix stages per row, digits^2 * n * (m1 + m2)
    int8 multiply-adds (2 ops each); rows read and written once plus the
    int8 digit matrices and twiddles of the L primes."""
    m2 = n // m1
    macs = rows * digits * digits * n * (m1 + m2)
    table_bytes = L * digits * digits * (m1 * m1 + m2 * m2) + L * n * 8
    return bound(2 * macs, INT8_OPS_S, rows * n * 8 + table_bytes)


def ptxas_summary(report: str) -> str:
    """Registers and spills per kernel family from `nvcc -Xptxas -v`."""
    fam, regs, spills = None, {}, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            fam = next((f for f in ("ntt_fwd", "ntt_inv", "ntt_mxu", "pie_ip", "vpu_ops",
                                    "ntt_lazy", "ntt_anatomy") if f in name), "other")
        elif fam and "Used" in line and "registers" in line:
            n = int(line.split("Used")[1].split("registers")[0])
            regs[fam] = max(regs.get(fam, 0), n)
        elif fam and "spill stores" in line:
            n = int(line.split("bytes spill stores")[0].split()[-1])
            spills[fam] = max(spills.get(fam, 0), n)
    return "max registers " + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())) + \
        "; max spill-store bytes " + ", ".join(f"{k} {v}" for k, v in sorted(spills.items()))


# SASS opcodes by the pipe that runs them (the ALU pipe takes the rest)
FMA_PIPE = ("IMAD", "IMUL", "HFMA2")
MEMORY = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC")


def k1_instruction_mix(lib_path: str, nvcc: str) -> str:
    """Instructions per butterfly of K1's top-window kernels at n = 16384
    (straight-line code: 32 residues and 5 stages, 80 butterflies, per
    thread), by pipe, from `cuobjdump -sass` of the built library."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    parts = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        if "kernelILi14ELi9ELi5E" not in name:
            continue
        ops = []  # opcodes, e.g. "IMAD" of "@!P0 IMAD.HI.U32 R5, R4, R3, RZ ;"
        for ln in fn.splitlines():
            toks = ln.split("*/", 1)[1].split() if ln.strip().startswith("/*") else []
            toks = toks[1:] if toks and toks[0].startswith("@") else toks
            if toks:
                ops.append(toks[0].split(".")[0])
        fma = sum(o in FMA_PIPE for o in ops)
        mem = sum(o in MEMORY for o in ops)
        alu = len(ops) - fma - mem - sum(o in ("NOP", "BRA", "EXIT") for o in ops)
        direction = "inverse" if "ntt_inv" in name else "forward"
        parts.append(f"{direction}: FMA pipe {fma / 80:.2f}, ALU and the other pipes "
                     f"{alu / 80:.2f}, memory {mem / 80:.2f} per butterfly")
    return "; ".join(parts) or "no n = 16384 top-window kernel found"


def k3_sass_counts(lib_path: str, nvcc: str) -> dict:
    """IGMMA (wgmma) and bulk-copy / TMA instructions in K3's kernels, from
    `cuobjdump -sass` of the built library."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    counts = {"kernels": 0, "IGMMA": 0, "UBLKCP": 0, "UTMALDG": 0}
    for fn in sass.split("Function : ")[1:]:
        if "ntt_mxu_kernel" not in fn.split("\n", 1)[0]:
            continue
        counts["kernels"] += 1
        for ln in fn.splitlines():
            for op in ("IGMMA", "UBLKCP", "UTMALDG"):
                counts[op] += f" {op}" in ln
    return counts


def int8_products_ms(mplan, x, D: int) -> float:
    """The digit products of one K3 forward call alone (D digits), as torch._int_mm
    (PyTorch's int8 tensor-core matrix product), 2L calls from a CUDA graph:
    per prime, stage 1 the five G1 stacked, (5 m1, 5 m1), @ the rows' digit
    stack, (5 m1, m2 R); stage 2 the digit stack, (m1 R, 5 m2), @ the five
    G2 side by side, (5 m2, 5 m2). The same tables and shapes as the kernel;
    the second stage's digits are the input's (the kernel keeps its
    intermediate on chip). The port never calls _int_mm."""
    import torch

    L, m1, m2, dev = mplan.L, mplan.m1, mplan.m2, x.device
    X = x.reshape(-1, L, m1, m2).long()
    R = X.shape[0]
    calls = []
    for l in range(L):
        Xl = X[:, l]
        left = torch.cat([(Xl >> (7 * j)) & 127 for j in range(D)], dim=1).to(torch.int8)
        right = torch.cat([(Xl >> (7 * j)) & 127 for j in range(D)], dim=2).to(torch.int8)
        g1 = torch.from_numpy(mplan.G1[l].reshape(D * m1, D * m1)).to(dev)
        g2 = torch.from_numpy(mplan.G2[l]).permute(1, 0, 2).reshape(D * m2, D * m2).to(dev)
        calls.append((g1, left.permute(0, 2, 1).reshape(R * m2, D * m1).contiguous()))
        calls.append((right.reshape(R * m1, D * m2), g2.t().contiguous()))
    outs = [torch.empty((a.shape[0], bt.shape[0]), dtype=torch.int32, device=dev)
            for a, bt in calls]

    def run():
        for (a, bt), o in zip(calls, outs):
            torch._int_mm(a, bt.t(), out=o)
    return graph_ms(run, iters=10)


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


def trace_online(step, timed: int = 20, traced: int = 10, warm: int = 3) -> dict:
    """Steady-state online step of one query (step()): host-clock ms over
    `timed` queries (after `warm` warm-ups), then a torch.profiler trace of
    `traced` more, summed by kernel group from the exported chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "online_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        fail("the profiler recorded no kernel on the device")
    groups = {"K1": [0.0, 0], "K2": [0.0, 0], "plain": [0.0, 0]}
    k1_kernels = {}  # K1 by kernel instance <log2 n, window's low bit, width>
    for e in kernels:
        name = e["name"]
        g = ("K1" if "ntt_fwd" in name or "ntt_inv" in name
             else "K2" if "pie_ip" in name else "plain")
        groups[g][0] += e["dur"] / 1e3
        groups[g][1] += 1
        if g == "K1":
            inst = name.split("::")[-1].split("(")[0]
            k = k1_kernels.setdefault(inst, [0.0, 0])
            k[0] += e["dur"] / 1e3 / traced
            k[1] += 1 / traced
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > hi:
            busy, lo, hi = busy + hi - lo, s0, s1
        else:
            hi = max(hi, s1)
    busy += hi - lo
    span = max(s1 for _, s1 in spans) - spans[0][0]
    walls.sort()
    return {"wall_ms_median": walls[len(walls) // 2], "wall_ms_min": walls[0],
            "wall_ms_max": walls[-1], "busy_share": busy / span, "k1_kernels": k1_kernels,
            **{f"{g}_ms_per_query": v[0] / traced for g, v in groups.items()},
            **{f"{g}_launches_per_query": v[1] / traced for g, v in groups.items()}}


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch

        from nested_hashing_psi_tpu_torch import cli
        from nested_hashing_psi_tpu_torch.benchmarks import (
            bench_ntt_anatomy,
            bench_ntt_lazy_probe,
            bench_vpu_ops,
        )
        from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext
        from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
        from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, bfv_mul_limbs
        from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda, ntt_mxu, pie_kernels
        from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
        from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan
        from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
        from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE
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
    report = cuda_lib.build(verbose=True)
    cuda_lib.get_lib()
    print(f"[build] {len(cuda_lib.sources())} sources -> {cuda_lib.LIB_PATH} in "
          f"{time.perf_counter() - t0:.2f} s; {ptxas_summary(report)}", flush=True)
    print("[sass] K1 top window, n = 16384: "
          f"{k1_instruction_mix(cuda_lib.LIB_PATH, cuda_lib.find_nvcc())}", flush=True)
    k3_sass = k3_sass_counts(cuda_lib.LIB_PATH, cuda_lib.find_nvcc())
    print(f"[sass] K3: {k3_sass['kernels']} kernels, IGMMA (wgmma) {k3_sass['IGMMA']}, "
          f"UBLKCP (bulk copy) {k3_sass['UBLKCP']}, UTMALDG (TMA) {k3_sass['UTMALDG']}; "
          "registers and spills above under ntt_mxu (the launch count: the consumer "
          "warpgroups take 232 by setmaxnreg)", flush=True)
    if k3_sass["IGMMA"] == 0 or k3_sass["UBLKCP"] + k3_sass["UTMALDG"] == 0:
        fail(f"K3's kernels lack wgmma or bulk-copy instructions: {k3_sass}")
    vpu_sass = {m: bench_vpu_ops.sass_per_application(m) for m in bench_vpu_ops.MIXES}
    print("[sass] A1 per application, FMA pipe + ALU (loop body of UNROLL x ELEMS "
          "applications): " + "; ".join(f"{m} {s['fma']:.2f} + {s['alu']:.2f}"
                                        for m, s in vpu_sass.items()), flush=True)
    # A chain folded by the compiler (64 adds into one multiply-add, two
    # multiplies by c into one by c^2) leaves fewer instructions per
    # application than one application can take (bench_vpu_ops.MIN_ARITH).
    folded = {m: (s["arith"], bench_vpu_ops.MIN_ARITH[m]) for m, s in vpu_sass.items()
              if s["arith"] < bench_vpu_ops.MIN_ARITH[m]}
    if folded:
        fail(f"A1 chains folded (instructions per application, floor): {folded}")
    probe_plan = SplitNTTPlan(16384, ntt_primes(6, 31, 2 * 16384))
    probe_sass = {v: bench_ntt_lazy_probe.sass_per_butterfly("ntt_lazy_kernel", probe_plan, i)
                  for i, v in enumerate(bench_ntt_lazy_probe.VARIANTS)}
    probe_sass["stages"] = bench_ntt_lazy_probe.sass_per_butterfly(
        "ntt_anatomy_kernel", probe_plan, 0)
    probe_sass["moves"] = bench_ntt_anatomy.moves_sass(probe_plan)
    moves_ops = probe_sass.pop("moves")["opcodes"]
    print("[sass] A2 and A3 at n = 16384, per butterfly, FMA pipe + ALU + memory: "
          + "; ".join(f"{v} {s['fma']:.2f} + {s['alu']:.2f} + {s['memory']:.2f}"
                      for v, s in probe_sass.items())
          + f"; A3 moves, its row loop (static): LDS {moves_ops.get('LDS', 0):.0f}, STS "
          f"{moves_ops.get('STS', 0):.0f}", flush=True)
    if not (moves_ops.get("LDS") and moves_ops.get("STS")):
        fail("A3's moves kernel has no LDS/STS: it does not move the data through shared memory")

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
    # bring the card to its working clocks before the first timing (the
    # first K1 timing of a fresh process read up to 1.5x slower otherwise)
    warm_plan = NTTPlan(N, q)
    warm = residues((2, 12, 2, L, N), q)
    time_ms(lambda: ntt_cuda.ntt(warm, warm_plan), 500)
    del warm
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
    for key, inverse in (("ntt_q", False), ("intt_q", True)):
        results[key] += k1_bound(2 * 12 * 2 * L, L, N, inverse)

    # ---- K1 at the nine launches of one server query --------------------
    bases = {"q6": q, "q5": q[:mul], "q4": q[:4], "aux": aux}
    plans = {k: NTTPlan(N, ps) for k, ps in bases.items()}
    k1_query = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0, "rows": 0}
    for label, inverse, lead, base in K1_QUERY_LAUNCHES:
        plan, ps = plans[base], bases[base]
        shape = (*lead, len(ps), N)
        x = residues(shape, ps)
        kfn = (lambda: ntt_cuda.intt(x, plan)) if inverse else (lambda: ntt_cuda.ntt(x, plan))
        pfn = (lambda: intt(x, plan)) if inverse else (lambda: ntt(x, plan))
        want = pfn()
        err = max_err(kfn(), want, f"K1 launch {label}")
        forms = {}
        for form, code in (("whole-row", ntt_cuda.WHOLE_ROW), ("split", ntt_cuda.SPLIT)):
            ffn = lambda: ntt_cuda._launch(x, plan, inverse, form=code)  # noqa: E731
            err = max(err, max_err(ffn(), want, f"K1 launch {label}, {form}"))
            forms[form] = graph_ms(ffn)
        if err != 0:
            fail(f"K1 launch {label} {shape}: kernel disagrees with plain (max_abs_err {err})")
        ms, dev_ms = time_ms(kfn, 50), graph_ms(kfn)
        rows = x.numel() // N
        b_ms, b_by = k1_bound(rows, len(ps), N, inverse)
        k1_query["ms"] += ms
        k1_query["device_ms"] += dev_ms
        k1_query["bound_ms"] += b_ms
        k1_query["rows"] += rows
        print(f"[k1_query] {label}: {'inverse' if inverse else 'forward'} {shape} "
              f"rows {rows}: max_abs_err {err} kernel {ms:.4f} ms through the wrapper, "
              f"{dev_ms:.4f} ms from a CUDA graph (whole-row {forms['whole-row']:.4f}, "
              f"split {forms['split']:.4f}) bound {b_ms:.4f} ms ({b_by}) share "
              f"{b_ms / dev_ms:.3f}", flush=True)
        del x, want
    print(f"[k1_query] sum of the nine launches: {k1_query['rows']} rows, kernel "
          f"{k1_query['ms']:.4f} ms through the wrapper, {k1_query['device_ms']:.4f} ms from "
          f"a CUDA graph, bound {k1_query['bound_ms']:.4f} ms, share "
          f"{k1_query['bound_ms'] / k1_query['device_ms']:.3f}", flush=True)

    # ---- K2 ------------------------------------------------------------
    H, D, P = 2, 12, 12
    tb = NTTPlan(N, q).tensors(dev)
    idx = residues((H, P, 2, L, N), q)
    pt = residues((H, D, P, L, N), q)
    results["pie_ip"] = compare(
        f"K2 position sum (H,D,P,L,N)=({H},{D},{P},{L},{N})",
        lambda: pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"]),
        lambda: pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"]),
        plain_iters=2) + k2_bound(H, D, P, L, N)
    idx_s = idx[:, 3:6].contiguous()
    results["pie_ip_slice"] = compare(
        "K2 position sum over table positions [3, 6) of P = 12, in place",
        lambda: pie_kernels.indexed_inner_product(idx_s, pt, tb["p_u32"], tb["pinv_u32"], p0=3),
        lambda: pie_kernels.indexed_inner_product_plain(idx_s, pt, tb["p"], tb["pinv"], p0=3),
        plain_iters=2) + k2_bound(H, D, 3, L, N)
    # K2's launch alone: how much of the wrapper's event time above is the
    # host preparing each call
    lib, stream = cuda_lib.get_lib(), torch.cuda.current_stream().cuda_stream
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=dev)
    for key, ii, p0 in (("pie_ip", idx, 0), ("pie_ip_slice", idx_s, 3)):
        raw_ms = time_ms(lambda: lib.nhpsi_pie_ip(
            ii.data_ptr(), pt.data_ptr(), out.data_ptr(), tb["p_u32"].data_ptr(),
            tb["pinv_u32"].data_ptr(), H, D, ii.shape[1], L, N, p0, P, stream), 20)
        err, ms, _, b_ms, b_by = results[key]
        print(f"[kernel] K2 {key}: wrapper {ms:.4f} ms, launch alone {raw_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), share of the bound {b_ms / raw_ms:.3f} "
              f"(launch) {b_ms / ms:.3f} (wrapper)", flush=True)
    del idx, pt, idx_s, out

    # ---- K2 and K1 at the BGV paths' shapes; the modulus switch ----------
    q9 = ntt_primes(9, 31, 2 * N, avoid=(T,))
    tb9 = NTTPlan(N, q9).tensors(dev)
    idx = residues((H, P, 2, 9, N), q9)
    pt = residues((H, D, P, 9, N), q9)
    results["pie_ip_l9"] = compare(
        f"K2 position sum, flat --bgv (H,D,P,L,N)=({H},{D},{P},9,{N})",
        lambda: pie_kernels.indexed_inner_product(idx, pt, tb9["p_u32"], tb9["pinv_u32"]),
        lambda: pie_kernels.indexed_inner_product_plain(idx, pt, tb9["p"], tb9["pinv"]),
        plain_iters=2) + k2_bound(H, D, P, 9, N)
    err, ms, plain_ms, b_ms, b_by = results["pie_ip_l9"]
    print(f"[kernel] K2 at L = 9: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
          f"{b_ms / ms:.3f}", flush=True)
    del idx, pt
    q16 = ntt_primes(6, 31, 2 * N, avoid=(T16,))
    simple_chunk = SimpleFHEPIE.CHUNK_BYTES // (2 * 12 * 2 * 7 * N * 4 * 9)  # its _pie_chunk
    q7 = ntt_primes(7, 31, 2 * N, avoid=(T,))
    for label, inverse, lead, ps in (
        ("flat --bgv relin, iNTT of d2", True, (12,), q9),
        ("flat --bgv relin, decompose digits", False, (12, 9), q9),
        ("leveled mod_switch, iNTT", True, (12, 2), q16),
        ("leveled mod_switch, child NTT", False, (12, 2), q16[:5]),
        ("leveled relin at level 1, iNTT of d2", True, (12,), q16[:5]),
        ("leveled relin at level 1, decompose digits", False, (12, 5), q16[:5]),
        ("SimpleFHE Galois key switch, iNTT of c1", True, (simple_chunk, 2, 12), q7),
        ("SimpleFHE Galois key switch, decompose digits", False, (simple_chunk, 2, 12, 7), q7),
    ):
        plan = NTTPlan(N, ps)
        x = residues((*lead, len(ps), N), ps)
        kfn = (lambda: ntt_cuda.intt(x, plan)) if inverse else (lambda: ntt_cuda.ntt(x, plan))
        want = intt(x, plan) if inverse else ntt(x, plan)
        err = max_err(kfn(), want, f"K1 {label}")
        if err != 0:
            fail(f"K1 {label}: kernel disagrees with plain (max_abs_err {err})")
        ms = time_ms(kfn, 10)
        b_ms, b_by = k1_bound(x.numel() // N, len(ps), N, inverse)
        print(f"[k1_bgv] {label}: {'inverse' if inverse else 'forward'} "
              f"{tuple(x.shape)}: max_abs_err 0, kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), share {b_ms / ms:.3f}", flush=True)
        del x, want
    sp16 = SchemeParams(ring_dim=N, plaintext_modulus=T16, num_limbs=6, scheme="bgv")
    ms_dev, ms_cpu = BGVContext(sp16, device=dev), BGVContext(sp16, device="cpu")
    ct = Ciphertext(residues((12, 2, 6, N), q16), "bgv", 1)
    got = ms_dev.mod_switch(ct)
    t0 = time.perf_counter()
    want = ms_cpu.mod_switch(Ciphertext(ct.data.cpu(), "bgv", 1))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(got.data.cpu(), want.data, "mod_switch")
    if err != 0 or got.scale != want.scale:
        fail(f"mod_switch on cuda differs from the port on the CPU (max_abs_err {err}, "
             f"scale {got.scale} vs {want.scale})")
    print(f"[mod_switch] (12,2,6,{N}) -> {tuple(got.data.shape)}: cuda bit-equal to the "
          f"CPU port, scale {got.scale}; cuda {time_ms(lambda: ms_dev.mod_switch(ct), 10):.4f} "
          f"ms (CUDA events), CPU {cpu_ms:.1f} ms", flush=True)
    del ct, got, want

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
        prod_ms = int8_products_ms(mplan, x, ntt_mxu.DIGITS)  # the inverse's are alike
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
            b_ms, b_by = k3_bound(x.numel() // N, plan.L, N, mplan.m1, ntt_mxu.DIGITS)
            print(f"[kernel] K3 {name} NTT, {shape}: max_abs_err vs K1 {e_k1}; "
                  f"K3 {ms:.4f} ms (share of the {b_ms:.4f} ms bound {b_ms / ms:.3f}), "
                  f"products alone (torch._int_mm) {prod_ms:.4f} ms, K1 {k1_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms", flush=True)
            results[f"ntt_mxu_{key}_{base}"] = (max(err, e_k1), ms, plain_ms, k1_ms, prod_ms,
                                                b_ms, b_by)
    del k3
    torch.cuda.empty_cache()

    # ---- the probe path (A1-A3): each probe's main at its full shape -----
    # (every variant, and K1 on the probes' input, held against its plain
    # version on the card; any mismatch raises)
    bench_vpu_ops.reset_launches()
    bench_ntt_lazy_probe.reset_launches()
    bench_ntt_anatomy.reset_launches()
    probe_runs = {"vpu": bench_vpu_ops.main([]), "lazy": bench_ntt_lazy_probe.main([]),
                  "anatomy": bench_ntt_anatomy.main([])}
    probe_launches = {"probe_vpu_ops": bench_vpu_ops.launches,
                      "probe_ntt_lazy": bench_ntt_lazy_probe.launches,
                      "probe_ntt_anatomy": bench_ntt_anatomy.launches}
    print(f"[probe] the probe path's launches {probe_launches}", flush=True)
    if min(probe_launches.values()) <= 0:
        fail(f"the probe path did not launch every probe kernel: {probe_launches}")
    anat = probe_runs["anatomy"]
    print(f"[probe] A3 at (512, 6, 16384): stages {anat['stages']['ms']:.4f} ms, moves "
          f"{anat['moves']['ms']:.4f} ms, full (K1) {anat['k1_ms']:.4f} ms; stages / full "
          f"{anat['stages']['ms'] / anat['k1_ms']:.3f}, moves / full "
          f"{anat['moves']['ms'] / anat['k1_ms']:.3f}", flush=True)
    torch.cuda.empty_cache()

    # ---- the main path: three protocol runs ----------------------------
    launches, runs = {"ntt_fwd": 0, "ntt_inv": 0, "pie_ip": 0}, {}

    def drive(label, flags):
        """One protocol run through the user entry points, the launch counts
        set to 0 just before it and read just after; prints its [main] line
        and fails unless it verified with the expected intersection."""
        ntt_cuda.reset_launches()
        pie_kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        psi, ht, device = cli.parse_args(flags)
        t0 = time.perf_counter()
        client, server, ok = run_in_process(psi, ht, device=device)
        wall = time.perf_counter() - t0
        got = {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
               "pie_ip": pie_kernels.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        found = len(client.intersection_calculated)
        Q, m, pie = psi.num_queries, client.measurements, server.pie
        noise = "n/a (device decrypt)" if client.noise_bits is None else f"{client.noise_bits:.1f}"
        print(f"[main] {label} ring={psi.ring_dim} scheme={server.ctx.default_form} "
              f"L={server.ctx.L} leveled={getattr(pie, 'leveled', None)} "
              f"mul_limbs={getattr(pie, 'mul_limbs', None)} "
              f"ship_limbs={getattr(pie, 'ship_limbs', None)} "
              f"table_pt={tuple(pie.table_pt.shape)} host_table={pie.host_table} "
              f"found={found} noise_bits={noise} wall {wall:.2f} s | "
              f"setup {m['Setup'].duration_us / 1e6:.3f} s offline "
              f"{m['Offline'].duration_us / 1e6:.3f} s online "
              f"{m['Online'].duration_us / 1e6:.3f} s | server offline "
              f"{server.offline_computation_us / 1e6:.3f} s online "
              f"{server.online_computation_us / 1e3:.3f} ms = "
              f"{server.online_computation_us / 1e3 / Q:.3f} ms/query | launches {got} "
              f"| peak device memory {peak:.3f} GiB", flush=True)
        if not ok or found != psi.intersection_set_size:
            fail(f"main path ({label}) did not verify: ok={ok} found={found}")
        for k in launches:
            launches[k] += got[k]
        runs[label] = (client, server)
        return client, server, got

    for label, extra in RUNS:
        client, _, got = drive(label, MAIN_FLAGS + extra)
        if len(client.intersection_calculated) != EXPECTED_FOUND:
            fail(f"main path ({label}) found {len(client.intersection_calculated)}")
        if min(got.values()) <= 0:
            fail(f"the main path ({label}) did not launch every kernel: {got}")
        if not client._decryptors:
            fail(f"the client ({label}) did not decrypt on the device")
    print(f"[main] kernel launches over the three runs {launches}", flush=True)

    # ---- steady-state online step, traced --------------------------------
    def traced(label, k1_bound_note="", timed=20, n_traced=10, warm=3):
        """trace_online of a run's one-query server, printed."""
        client, server = runs[label]
        if hasattr(client, "minus_ct"):  # BatchedFHE
            tr = trace_online(lambda: server.pie.run(client.idx_ct, client.minus_ct),
                              timed, n_traced, warm)
        else:
            tr = trace_online(lambda: server.pie.run(client.idx_ct), timed, n_traced, warm)
        device_ms = sum(tr[f"{g}_ms_per_query"] for g in ("K1", "K2", "plain"))
        print(f"[trace] {label}: online step, one query, steady state: wall median "
              f"{tr['wall_ms_median']:.3f} ms (min {tr['wall_ms_min']:.3f}, max "
              f"{tr['wall_ms_max']:.3f}) over {timed} queries; traced {n_traced}: device "
              f"{device_ms:.3f} ms/query, K1 {tr['K1_ms_per_query']:.4f} ms/query "
              f"({tr['K1_launches_per_query']:.0f} launches{k1_bound_note}), K2 "
              f"{tr['K2_ms_per_query']:.4f} ms/query ({tr['K2_launches_per_query']:.0f}), "
              f"plain PyTorch {tr['plain_ms_per_query']:.3f} ms/query "
              f"({tr['plain_launches_per_query']:.0f}); busy share {tr['busy_share']:.3f}",
              flush=True)
        print(f"[trace] {label}: K1 by kernel, per query: " + "; ".join(
            f"{k} {ms:.4f} ms ({n:.0f})" for k, (ms, n) in sorted(tr["k1_kernels"].items())),
            flush=True)

    traced("queries=1", f"; bound {k1_query['bound_ms']:.4f} ms")
    client, server = runs["queries=1"]

    # ---- device decrypt vs host decrypt on the one-query result ---------
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
    # ---- --bgv (flat, then leveled) and SimpleFHE -----------------------
    client, server, got = drive("bgv flat", BGV_FLAGS)
    if server.ctx.L != 9 or server.pie.leveled or len(client.intersection_calculated) != 1024:
        fail(f"flat --bgv: L={server.ctx.L} leveled={server.pie.leveled}, expected L = 9 flat")
    if min(got.values()) <= 0:
        fail(f"flat --bgv did not launch K1 and K2: {got}")
    if client._decryptors or client.noise_bits is None:
        fail("the flat --bgv client did not decrypt on the host")
    client, server, got = drive("bgv leveled", LEVELED_FLAGS)
    shipped = server.pie.run(client.idx_ct, client.minus_ct).data.shape[-2]
    print(f"[main] bgv leveled: the result ships {shipped} limbs", flush=True)
    if server.ctx.L != 6 or not server.pie.leveled or shipped != 5:
        fail(f"leveled --bgv: L={server.ctx.L} leveled={server.pie.leveled} shipped {shipped}")
    if min(got.values()) <= 0:
        fail(f"leveled --bgv did not launch K1 and K2: {got}")
    if client._decryptors or client.noise_bits is None:
        fail("the leveled --bgv client did not decrypt on the host")
    traced("bgv flat")
    traced("bgv leveled")
    client, server, got = drive("SimpleFHE", SIMPLE_FLAGS)
    if server.ctx.L != 7 or server.pie._pie_chunk() != simple_chunk:
        fail(f"SimpleFHE: L={server.ctx.L}, pie chunk {server.pie._pie_chunk()}")
    if got["ntt_fwd"] <= 0 or got["ntt_inv"] <= 0:
        fail(f"SimpleFHE did not launch K1: {got}")
    if client.decryptor is None:
        fail("the SimpleFHE client did not decrypt on the device")
    traced("SimpleFHE", timed=3, n_traced=2, warm=1)
    print(f"[main] kernel launches over all six runs {launches}", flush=True)

    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "nested_hashing_psi_tpu" or m.startswith("nested_hashing_psi_tpu."))
    if loaded:
        fail(f"the port loaded jax or the JAX package: {loaded[:10]}")

    def entry(name, source, replaces, key, launched, **extra):
        err, ms, plain_ms = results[key][:3]
        bound_ms, bound_by = results[key][-2:]
        # no PyTorch call computes an exact NTT mod a 31-bit prime or K2's
        # Montgomery position sum: library_ms is null (K3's int8_products_ms
        # times its matrix products alone, not the NTT)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, **extra}

    csrc = "nested_hashing_psi_tpu_torch/csrc"
    k3_note = "own phase: K3 has no caller on the protocol path"
    kernels = [
        entry("ntt_fwd", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:631",
              "ntt_q", launches["ntt_fwd"]),
        entry("ntt_inv", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:645",
              "intt_q", launches["ntt_inv"]),
        entry("pie_ip", f"{csrc}/pie_ip.cu", "nested_hashing_psi_tpu/ops/pie_kernels.py:48",
              "pie_ip", launches["pie_ip"], **dict(zip(
                  ("l9_max_abs_err", "l9_ms", "l9_plain_ms", "l9_bound_ms", "l9_bound_by"),
                  results["pie_ip_l9"]))),
        entry("ntt_mxu_fwd", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:323",
              "ntt_mxu_fwd_q", k3_launches["ntt_mxu_fwd"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_fwd_q"][3], int8_products_ms=results["ntt_mxu_fwd_q"][4]),
        entry("ntt_mxu_inv", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:330",
              "ntt_mxu_inv_q", k3_launches["ntt_mxu_inv"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_inv_q"][3], int8_products_ms=results["ntt_mxu_inv_q"][4]),
    ]
    vpu_run = probe_runs["vpu"]
    # the 11 K = 64 launches: the larger of their summed bytes and operations
    elems = int(np.prod(bench_vpu_ops.SHAPE))
    t_ops = sum(vpu_sass[m]["arith"] for m in vpu_run) * elems * bench_vpu_ops.K / INT32_OPS_S * 1e3
    t_bytes = len(vpu_run) * 8 * elems / HBM_BYTES_S * 1e3
    vpu_extra = {}
    for m, r in vpu_run.items():
        vpu_extra.update({
            f"{m}_k64_ms": r["ms"], f"{m}_rate_k": r["rate_k"], f"{m}_rate_ms": r["rate_ms"],
            f"{m}_rate_bound_ms": r["bound_ms"], f"{m}_rate_bound_by": r["bound_by"],
            f"{m}_sass_fma_per_app": vpu_sass[m]["fma"],
            f"{m}_sass_alu_per_app": vpu_sass[m]["alu"],
            f"{m}_T_instructions_s": r["apps_per_s"] * vpu_sass[m]["arith"] / 1e12})
    kernels.append({
        "name": "probe_vpu_ops", "route": "cuda", "source": f"{csrc}/probe_vpu_ops.cu",
        "replaces": "benchmarks/bench_vpu_ops.py:101", "launches": probe_launches["probe_vpu_ops"],
        "max_abs_err": max(r["max_abs_err"] for r in vpu_run.values()),
        "ms": sum(r["ms"] for r in vpu_run.values()),
        "plain_ms": sum(r["plain_ms"] for r in vpu_run.values()), "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "measured_as": "the 11 mixes at (64, 128, 128), K = 64, one launch each, summed",
        **vpu_extra})

    def probe_entry(name, source, replaces, main_v, others, run, **extra):
        r = run[main_v]
        fields = {}
        for v in others:
            fields.update({f"{v}_{k}": run[v][k]
                           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        for v in (main_v, *others):
            if v != "moves":  # moves has no butterflies
                fields[f"{v}_sass_arith_per_butterfly"] = run[v]["sass"]["arith"]
            fields[f"{v}_limb_transforms_s"] = run[v]["transforms_per_s"]
        return {"name": name, "route": "cuda", "source": f"{csrc}/{source}",
                "replaces": replaces, "launches": probe_launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                "variant": main_v, **fields, "k1_max_abs_err": run["k1_max_abs_err"],
                "k1_ms": run["k1_ms"], "k1_limb_transforms_s": run["k1_transforms_per_s"], **extra}

    kernels.append(probe_entry("probe_ntt_lazy", "probe_ntt_lazy.cu",
                               "benchmarks/bench_ntt_lazy_probe.py:142", "exact",
                               ("lazy", "lazy_ps"), probe_runs["lazy"]))
    kernels.append(probe_entry("probe_ntt_anatomy", "probe_ntt_anatomy.cu",
                               "benchmarks/bench_ntt_anatomy.py:100", "stages", ("moves",),
                               anat, moves_sass_lds_static=moves_ops.get("LDS", 0),
                               moves_sass_sts_static=moves_ops.get("STS", 0),
                               stages_over_full=anat["stages"]["ms"] / anat["k1_ms"],
                               moves_over_full=anat["moves"]["ms"] / anat["k1_ms"]))
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
