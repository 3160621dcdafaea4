#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from nested_hashing_psi_tpu_torch/csrc
   (one nvcc per source, in parallel, sm_90a) and holds each against its
   plain PyTorch version on the card at the main path's shapes (bit-exact),
   timing both with CUDA events: K1 (NTT, q and aux bases, then the nine K1
   launches of one server query, each also replayed from a CUDA graph, in
   the form the kernel chose and in both forced forms, with its bound and
   share of it), K2 (position sum: whole table, an in-place slice p0 = 3,
   w = 3 of P = 12, the host-resident path's position-major table, a
   running sum acc updated in place, and the whole table at L = 6..10, each
   beside its bound) and K3 (the int8 tensor-core NTT, q and aux
   bases, also held against K1, beside its digit products alone as
   torch._int_mm from a CUDA graph; K3 has no caller on the protocol path,
   so its launches come from this phase). The [sass] step counts K3's
   wgmma (IGMMA) and bulk-copy (UBLKCP, UTMALDG) instructions and fails
   without them. Then K2 at flat --bgv's L = 9 and at [multihost]'s shapes
   (L = 8, P = 8, D = 8 and 16), K1 at the BGV paths' shapes (the
   full-basis relin decompose at L = 9, the leveled chain's switches and
   relin at 6 and 5 limbs, the SimpleFHE Galois key switches, [multihost]'s
   relin at L = 8 over 8 and 16 depths), and
   ``mod_switch`` on the card against the port on the CPU (bit-equal).
   The [sass] step also counts the three probes' instructions (A1 per
   application of each op mix, by pipe, failing if a chain was folded:
   fewer than one application can take; A2's and A3's stages' per
   butterfly, failing below the fewest a butterfly of the form can take,
   ``MIN_ARITH`` of their modules; LDS/STS in A3's moves, failing without
   them) and prints every A2 and A3 instance's registers and spill bytes
   (ptxas), failing if A2 or A3's stages spills. The [probe] phase drives
   the probe path, the three probes' ``main`` (benchmarks/ of the port) at
   their full shapes, with their launch counts set to 0 just before and
   read just after: A1 the uint32 op mixes at (64, 128, 128), K = 64, then
   at K = 2^15 for the rates; A2 the lazy butterfly forms and A3 the NTT
   anatomy at (512, 6, 16384), each beside K1 on the same input, with
   A2's forms' and A3's stages' ms, bound by pipe and share. Each
   ``main`` holds every variant, and K1, against its plain version on the
   card, bit-exact (fmul: NaNs as one class), and raises otherwise;
2. drives the port's main path through its user entry points
   (``cli.parse_args`` + ``protocol.runner.run_in_process``): BatchedFHE
   with BFV at the 2^20-server x 2048-client geometry, ring 16384, three
   times -- one query, ``--queries 4`` and ``--streamChunks 4`` -- each
   self-verifying "Set matches!" with 1024 items found; the client decrypts
   on the device. Launch counters are reset just before each run and read
   just after it; each run must have launched K1, K2 and the decrypt kernel;
3. times the one-query server's online step at steady state (host clock,
   20 queries) and traces 10 more with torch.profiler: device time per
   query by kernel (K1, K2, the plain PyTorch kernels; K1 also by kernel
   instance) and the device's busy share of the traced span;
4. decrypts the one-query server's result and the --queries 4 server's
   (Q, D) result with the decrypt kernel (zero mask), the plain version and
   the host decrypt, which must agree bit for bit, and times each (the
   kernel beside its bound); after 6 the flat and the leveled --bgv runs'
   results and the SimpleFHE client's first decrypt chunk the same way;
5. builds the one-query server's table twice more with one mask seed, on
   the device and host-resident (pinned, uploaded in position slices), and
   checks that run() is bit-equal, with the default slice rule and with
   pos_chunk = 3, timing each; then traces one streamed query (4 chunks)
   and one host-table query (4 slices): K2 adds each chunk's or slice's sum
   to the running sum and reads the position-major slices in place, so
   each must launch 4 K2 kernels and no add or transpose of its own.
   [checkpoint]: the one-query server's PIE and its client sidecar are
   saved (bench_e2e_psi.save_artifact, the v3 checkpoint) and resumed by
   ``python -m ...bench_e2e_psi --resume`` in a fresh process, with jax
   and the JAX package made unimportable: it must print "Set matches!"
   with 1024 found, launch K1 and K2 (counted in that process) and write a
   result bit-equal with this process's pie.run on the same query; the
   host-resident PIE is saved and resumed here, and must stay
   host-resident, position-major and pinned and answer bit-equal with the
   device table. Save and load seconds and file sizes are printed; the
   resumed runs' launches add into the kernel line;
6. drives three more paths the same way: ``--bgv`` at the main geometry
   (flat BGV, L = 9; 1024 found, the client decrypts on the device), ``--bgv
   -B 16`` leveled on the main geometry's table with a 4096-item server
   (L = 6, the result ships 5 limbs; 128 found), both launching K1, K2 and
   the decrypt kernel and traced as in 3, and SimpleFHE at full width and
   reduced scale (32 inner tables at L = 7; 8 found, K1 and the decrypt
   kernel launched; traced over 3 timed and 2 traced queries). The kernel
   line's launches sum all six runs, and its decrypt entry holds each
   decrypt reading of 4;
7. [elgamal]: SimpleElGamal and PrecompElGamal (P-256, -B 128, --nThreads 2)
   at 2^14 server x 32 client items, and SimpleElGamal on K-163, through
   the same entry points with device cuda, each verifying with the
   expected intersection and launching no kernel (both packages compute
   these protocols on the host); prints each party's phase times, the
   server's compute times and the phase's seconds, as host timings beside
   the host CPU's model and the card's name and power limit.
8. [parallel]: ``parallel/`` at full width on the rows above (main BFV,
   flat --bgv, SimpleFHE): NCCL at world size 1 in this process (the dp x
   tp and pipelined steps, the ring-sharded step at D = 1, the four-step
   and ring-exchange NTTs at L = 6, n = 16384), then four rank processes
   on the one card through gloo staged via host memory (dp x tp 2 x 2 BFV
   and 4 x 1 flat BGV, ring-sharded D = 4 BFV and flat BGV, pipelined k = 4
   BFV, SimpleFHE over 4 ranks, both NTTs). Every gathered result is held
   bit-equal with the unsharded port on the card (full basis), the 2 x 2
   BFV result decrypted on the device to 1024 found, and each rank must
   launch K1 and K2 where its step runs them; per step it prints the ms
   per query, the bytes each rank sent, the launches per rank and the
   transport. The kernel line's ``parallel_launches`` sum both runs.
9. [bench] (run after 6, before 7 and 8, in a process of its own): the
   port's bench and eval tools (benchmarks/ of the port) at full size,
   with the K1 and K2 counts set to 0 just before and read just after
   (the kernel line's ``bench_wrapper_calls``: calls of the wrappers; a
   CUDA graph's capture counts each of its calls once, its replays not):
   bench.py's headline (K1's limb-transforms/s at (512, 6, 16384) against
   3.35 TB/s, the plain NTT, K1 in L2, and the 2^20 x 2048 online query in
   four readings, Q = 32 with query 0's packed device mask held to the
   host decrypt), profile_online's six parts and hps_parts' eight with
   their kernel counts, bench_pie_online at 2^20 and 2^24 (K2 held
   bit-exact to its plain version at each table's shape, P = 14 and P =
   58, then its share of its bound at P = 58, the kernel line's
   ``p58_*``) and bench_ntt_kernel, whose chained K1 is held to the plain
   chain.
10. [goldens] (run after 6, before 9): the reference's three golden tests
   through the port at ring 16384 (``tests/torch_golden_cases.py``, the
   JAX package's ``tests/test_goldens_reference_scale.py`` line for line):
   TestFHEPIE (15,000 items, SimpleFHE: one zero slot), TestBatchedFHEPIE
   (BatchedFHE: two zeros, both batch slots) and TestFHEInnerP (slots [0,
   1, 0, 1]), within the reference's noise bounds, each launching K1 (the
   batched one K2 too); then ``BasisExtension`` at the main path's q ->
   aux, bit-exact with an exact CRT on sampled coefficients, its lazy
   variant within [0, L) q, timed beside ``extend_q_to_aux``.
12. [hps] (run after 10): BFV's HPS kernels (csrc/hps.cu) at both BFV
   cells' shapes (D = 12 and 48, L = 6 rescaled to 5, aux 8, the ship
   rescale 5 -> 4) and the full basis' (6 limbs, aux 9): the rescale with
   the extension, the tensor products, scale-and-round with the return to
   q, each bit-exact with its plain version on the CPU, timed beside its
   bound and the plain version's time on the card. The three BFV main runs
   (2) must each have launched them; the traced steps count them as HPS.
11. [multihost] (run after 8): the port's scaling report in its
   multi-process mode (``benchmarks/scaling_report.py --num-processes 2``),
   two processes launched on their own (``tests/torch_processes.py``), joined at
   ``tcp://127.0.0.1:<free port>`` through gloo on the one card, at ring
   16384, L = 8, D = 16, dp 2 x tp 1; each loads the kernel library built
   here. Row (c) must be bit-equal with the unsharded step and each
   process must launch K1 (both directions) and K2 over its timed queries
   (the kernel line's ``multihost_launches``, summed over both); prints
   the rows' ms per query beside the card's name and power limit.

The A1 probe's bound counts each mix's busier pipe (bench_vpu_ops.ops_per_app:
64 lanes per clock per SM each, a wide product two FMA-pipe slots); the
[a1_bound] line prints each mix's share at K = 64 and at K = 2^15. A2's
and A3's stages' bounds count their butterflies the same way
(bench_ntt_lazy_probe.bound_ms); their kernel entries carry it as
``bound_by_pipe``, with each variant's ``registers``.

It fails if jax, the JAX package nested_hashing_psi_tpu or cryptography
was imported. It prints the card's name and power limit, one JSON line
listing the kernels (each with its bound: the larger of its bytes over 3.35
TB/s and its operations over the card's peak rate for their type), and as
its last line {"ok": true, "device": {...}}. Any failure exits non-zero without that line;
so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CUDA = "cuda"  # the device the timing helpers take
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
# The ElGamal protocols (no -F; the CLI's default is SimpleElGamal, -P
# PrecompElGamal) at the reference sweep's item width (-B 128) and 2HF
# equal-block geometry, -e scaled from the 2^20 row's 8022 to a 2^14-item
# server (126); 32 client items, 16 in common; P-256, --nThreads 2. Then
# SimpleElGamal on the binary curve K-163 at the JAX tests' geometry. Both
# packages compute these protocols on the host: no kernel launches.
ELGAMAL_FLAGS = [
    "-B", "128", "-S", "16384", "-C", "32", "-I", "16", "-e", "126", "-E", "12", "-b", "12",
    "-k", "2", "-K", "2", "--nThreads", "2", "--curve", "P-256", "--device", "cuda",
]
ELGAMAL_RUNS = (
    ("SimpleElGamal P-256", ELGAMAL_FLAGS),
    ("PrecompElGamal P-256", ELGAMAL_FLAGS + ["-P"]),
    ("SimpleElGamal K-163", ["-B", "16", "-S", "60", "-C", "4", "-I", "2", "-e", "8", "-E",
                             "6", "-b", "3", "-k", "2", "-K", "2", "--curve", "K-163",
                             "--device", "cuda"]),
)

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


if ROOT not in sys.path:  # behind a tree that k2_sweep.py put first
    sys.path.append(ROOT)
try:  # the card's peaks, the kernels' bounds and the timing, shared with the port's tools
    from nested_hashing_psi_tpu_torch.benchmarks.card import (
        decrypt_bound,
        k1_bound,
        k2_bound,
        k3_bound,
    )
    from nested_hashing_psi_tpu_torch.benchmarks.timing import graph_ms, time_ms, wall_ms
except ImportError as e:
    fail(f"the port is not importable here ({e}); run from the repository root")


def ptxas_summary(instances: dict) -> str:
    """Registers and spills per kernel family, the most of its instances
    (``benchmarks.common.ptxas_instances`` of `nvcc -Xptxas -v`)."""
    regs, spills = {}, {}
    for name, r in instances.items():
        fam = next((f for f in ("ntt_fwd", "ntt_inv", "ntt_mxu", "pie_ip", "vpu_ops",
                                "ntt_lazy", "anatomy_stages", "anatomy_moves") if f in name),
                   "other")
        regs[fam] = max(regs.get(fam, 0), r["registers"])
        spills[fam] = max(spills.get(fam, 0), r["spill_stores"])
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
    return graph_ms(run, CUDA, iters=10)


PAR_WORLD = 4          # ranks sharing the one card through the staged gloo transport
PAR_TIMEOUT = 600.0    # s: the four ranks' start, their PIE builds and every case
PAR_TIMING = dict(warm=1, iters=3)
PAR_SIMPLE_TIMING = dict(warm=0, iters=2)


def parallel_phase(runs: dict, smi_line: str) -> dict:
    """[parallel]: the sharded online steps and distributed NTTs of
    ``parallel/`` at full width, on inputs of the rows driven above: the
    main BFV row (one-query server), the flat --bgv row and the SimpleFHE
    row. First NCCL at world size 1 in this process (the dp x tp and
    pipelined steps, the ring-sharded step at D = 1 and both NTTs at L = 6,
    n = 16384), then four rank processes on the one card through gloo
    staged via host memory (NCCL refuses two ranks on one device): dp x tp
    at 2 x 2 (BFV) and 4 x 1 (flat BGV, L = 9), the ring-sharded step at D
    = 4 (BFV, flat BGV), the pipelined step at k = 4 (BFV), the SimpleFHE
    step over 4 ranks and both NTTs. Every gathered result must be
    bit-equal with the unsharded port on the card (the batched rows on the
    full basis: ``batched_pie_forward`` without mul_limbs), the 2 x 2 BFV
    result must decrypt to EXPECTED_FOUND items, and each rank must launch
    K1 and K2 where the step runs them. Prints per step the ms per query
    (per timed query the slowest rank, host clock around a synchronised
    step after a barrier), the bytes each rank sent, the launches per rank
    and the transport. -> the launches summed over both runs, by kernel."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
    from nested_hashing_psi_tpu_torch.ops import ntt_cuda
    from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
    from nested_hashing_psi_tpu_torch.parallel.multihost import init_distributed
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
    from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE

    sys.path.append(os.path.join(ROOT, "tests"))  # the rank program, shared with the tests
    from torch_parallel_cases import run_cases, summarize

    def median_ms(fn, iters: int = 3) -> float:
        """Median host-clock ms of fn() to a synchronise, after one warm call."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    t_phase = time.perf_counter()
    rows, want, unsharded = {}, {}, {}
    for key, label in (("bfv", "queries=1"), ("bgv", "bgv flat")):
        client, server = runs[label]
        data = dict(idx=client.idx_ct.data, minus=client.minus_ct.data,
                    table=server.pie.table_pt, mask=server.pie.mask_pt,
                    rlk_b=server.rlk.b_mont, rlk_a=server.rlk.a_mont)

        def step(server=server, data=data):
            return batched_pie_forward(server.ctx, server.rlk, *(data[k] for k in
                                                                 ("idx", "minus", "table", "mask")))

        want[key] = convert.to_numpy(step().data)
        unsharded[key] = median_ms(step)
        rows[key] = dict(params=server.ctx.params,
                         inputs={k: convert.to_numpy(v) for k, v in data.items()})
    client, server = runs["SimpleFHE"]
    ref = SimpleFHEPIE(server.ctx, server.server_table, server.gks, mask_seed=MASK_SEED)
    t0 = time.perf_counter()
    want["simple"] = convert.to_numpy(ref.run(client.idx_ct).data)
    unsharded["simple"] = (time.perf_counter() - t0) * 1e3
    simple_table_bytes = ref.table_pt.numel() * ref.table_pt.element_size()
    del ref
    simple = dict(kind="simple", params=server.ctx.params, mesh=(PAR_WORLD, 1),
                  inputs={"idx": convert.to_numpy(client.idx_ct.data)},
                  hct=server.server_table, galois_keys=convert.galois_keys_to_numpy(server.gks),
                  mask_seed=MASK_SEED, **PAR_SIMPLE_TIMING)
    ps = runs["queries=1"][1].ctx.q_primes
    n = runs["queries=1"][1].ctx.n
    x = np.random.default_rng(10).integers(0, min(ps), size=(len(ps), n)).astype(np.uint32)
    xt = convert.from_numpy(x, "cuda")
    plan = runs["queries=1"][1].ctx.plan
    want["ntt"] = convert.to_numpy(ntt_cuda.ntt(xt, plan))
    unsharded["ntt"] = median_ms(lambda: ntt_cuda.ntt(xt, plan), 10)
    print(f"[parallel] the unsharded port on the card, ms per query (median of 3 after a warm "
          f"call; SimpleFHE one call): BFV row, full basis {unsharded['bfv']:.3f}; flat BGV "
          f"{unsharded['bgv']:.3f}; SimpleFHE {unsharded['simple']:.1f}; K1 forward at "
          f"({len(ps)}, {n}) {unsharded['ntt']:.3f} (median of 10)", flush=True)
    m1 = 1 << ((n.bit_length() - 1 + 1) // 2)
    ntts = [dict(name="four-step NTT", kind="dist_ntt", params=(n, ps, m1),
                 inputs={"x": x.reshape(len(ps), m1, n // m1)}, **PAR_TIMING),
            dict(name="ring-exchange NTT", kind="ring_ntt", params=(n, ps, 0),
                 inputs={"x": x}, **PAR_TIMING)]

    def batched(name, kind, key, **kw):
        return dict(name=name, kind=kind, params=rows[key]["params"], inputs=rows[key]["inputs"],
                    want=key, **PAR_TIMING, **kw)

    nccl_cases = [batched("dp x tp 1 x 1, BFV", "dp_tp", "bfv", mesh=(1, 1)),
                  batched("pipelined k = 1, BFV", "pp", "bfv"),
                  batched("ring-sharded D = 1, BFV", "sp", "bfv"), *ntts]
    staged_cases = [batched("dp x tp 2 x 2, BFV", "dp_tp", "bfv", mesh=(2, 2)),
                    batched("dp x tp 4 x 1, flat BGV", "dp_tp", "bgv", mesh=(4, 1)),
                    batched("ring-sharded D = 4, BFV", "sp", "bfv"),
                    batched("ring-sharded D = 4, flat BGV", "sp", "bgv"),
                    batched("pipelined k = 4, BFV", "pp", "bfv"),
                    dict(name="SimpleFHE over 4 ranks", want="simple", **simple), *ntts]
    # what each step must launch in every rank: K1 where it transforms on
    # one device, K2 where it sums positions (the ring-sharded step's
    # transforms are the distributed butterfly, plain PyTorch)
    must = {"dp_tp": ("ntt_fwd", "ntt_inv", "pie_ip"), "pp": ("ntt_fwd", "ntt_inv", "pie_ip"),
            "sp": ("pie_ip",), "simple": ("ntt_fwd", "ntt_inv"), "dist_ntt": (), "ring_ntt": ()}

    def check(label, cases, summary):
        totals = {"ntt_fwd": 0, "ntt_inv": 0, "pie_ip": 0}
        for case, s in zip(cases, summary):
            got = s["results"]
            if case["kind"] in ("dist_ntt", "ring_ntt"):
                ok = (got[0].reshape(want["ntt"].shape) == want["ntt"]).all() and \
                    (got[1] == case["inputs"]["x"]).all()
            else:
                ok = got[0].shape == want[case["want"]].shape and \
                    (got[0] == want[case["want"]]).all()
            counts = [c[0] for c in s["counts"]]
            lacking = [k for k in must[case["kind"]] for c in counts if c[k] <= 0]
            times = "; ".join(f"{t['median']:.3f} ms/query (min {t['min']:.3f}, max "
                              f"{t['max']:.3f})" for t in s["ms"] if t)
            print(f"[parallel] {label} {case['name']}: mesh {s['mesh']}, transport "
                  f"{s['transport']}: {'bit-equal' if ok else 'DIFFERS'} with the unsharded "
                  f"port; {times}; bytes sent per rank per query "
                  f"{[c['bytes_sent'] for c in counts]}; launches per rank "
                  f"K1 fwd {[c['ntt_fwd'] for c in counts]}, K1 inv "
                  f"{[c['ntt_inv'] for c in counts]}, K2 {[c['pie_ip'] for c in counts]}; "
                  f"device bytes held per rank once built {s['held']}", flush=True)
            if not ok:
                fail(f"[parallel] {label} {case['name']}: the gathered result differs from "
                     "the unsharded port")
            if lacking:
                fail(f"[parallel] {label} {case['name']}: a rank did not launch {lacking}")
            for c in s["counts"]:
                for k in totals:
                    totals[k] += sum(stage[k] for stage in c)
        return totals

    t0 = time.perf_counter()
    init_distributed(None, 1, 0, "nccl")
    try:
        nccl = summarize([run_cases(0, 1, nccl_cases, "cuda")])
    finally:
        dist.destroy_process_group()
    nccl_s = time.perf_counter() - t0
    totals = check("nccl, world 1:", nccl_cases, nccl)
    print(f"[parallel] nccl, world 1: {nccl_s:.2f} s", flush=True)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    staged = summarize(run_ranks(run_cases, PAR_WORLD, "gloo", (staged_cases, "cuda"),
                                 timeout=PAR_TIMEOUT))
    staged_s = time.perf_counter() - t0
    for k, v in check(f"gloo staged, {PAR_WORLD} ranks on one card:", staged_cases,
                      staged).items():
        totals[k] += v

    # the 2 x 2 BFV result on the full basis (6 limbs) decrypts to the intersection
    client = runs["queries=1"][0]
    res = convert.from_numpy(staged[0]["results"][0], "cuda")
    mask = DeviceDecryptor(client.ctx).zero_mask(res, client.sk.s_mont, client.ht.batch_slots)
    found = len(client.client_ops.extract_intersection_mask(mask.cpu().numpy()))
    # the SimpleFHE ranks hold their quarter of the table, not the whole
    held = staged[[c["kind"] for c in staged_cases].index("simple")]["held"]
    print(f"[parallel] SimpleFHE: the unsharded table {simple_table_bytes} B; held per rank "
          f"{held} B", flush=True)
    if max(held) >= simple_table_bytes:
        fail(f"[parallel] a SimpleFHE rank holds {max(held)} B, not less than the whole "
             f"table's {simple_table_bytes} B")
    print(f"[parallel] dp x tp 2 x 2 BFV result {tuple(res.shape)} decrypted on the device "
          f"({client.ctx.L} limbs): {found} found", flush=True)
    if found != EXPECTED_FOUND:
        fail(f"[parallel] the dp x tp result decrypts to {found} items, not {EXPECTED_FOUND}")
    out = {"launches": totals, "nccl_s": nccl_s, "staged_s": staged_s,
           "phase_s": time.perf_counter() - t_phase, "unsharded_ms": unsharded,
           "ms": {f"{label} {case['name']}": s["ms"]
                  for label, cs, ss in (("nccl", nccl_cases, nccl),
                                        ("staged", staged_cases, staged))
                  for case, s in zip(cs, ss)},
           "bytes_sent": {f"{label} {case['name']}": [c[0]["bytes_sent"] for c in s["counts"]]
                          for label, cs, ss in (("nccl", nccl_cases, nccl),
                                                ("staged", staged_cases, staged))
                          for case, s in zip(cs, ss)}}
    print(f"[parallel] phase {out['phase_s']:.2f} s (nccl world 1 {nccl_s:.2f} s, "
          f"{PAR_WORLD} staged ranks {staged_s:.2f} s, their start included); launches "
          f"{totals}; the four ranks share one card, so their times measure the "
          f"transport and the per-rank compute, not scale-out | card {smi_line}", flush=True)
    return out


# [multihost]: the scaling report's multi-process mode, the README's row:
# two processes on the one card, joined over TCP, gloo staged through host
# memory (NCCL refuses two ranks on one card)
MULTIHOST_ARGS = ["--device", "cuda", "--backend", "gloo", "--ring", "16384", "--limbs", "8",
                  "--depths", "16", "--tp", "1"]
MULTIHOST_PROCESSES = 2
MULTIHOST_TIMEOUT = 300.0  # s, for both processes together
MULTIHOST_LABEL = f"{MULTIHOST_PROCESSES} processes, dp {MULTIHOST_PROCESSES} x tp 1, gloo"


def multihost_phase(smi_line: str) -> dict:
    """[multihost]: ``benchmarks/scaling_report.py`` of the port as two
    processes launched on their own (``tests/torch_processes.py``, one
    ``--process-id`` each), joined at ``tcp://127.0.0.1:<free port>``
    through gloo, at ring 16384, L = 8, D = 16, dp 2 x tp 1. They load the
    kernel library this process built. Fails unless both exit 0, process
    0's report has row (c) bit-equal with the unsharded step, each process
    launched K1 (both directions) and K2 over its timed queries, and the
    report's card line names an H100. K1 and K2 are held against their
    plain versions at this phase's shapes in the kernel section.
    -> the rows, the launches, seconds."""
    sys.path.append(os.path.join(ROOT, "tests"))  # the process harness, shared with the tests
    from torch_processes import free_port, run_processes

    t_phase = time.perf_counter()
    coord = f"tcp://127.0.0.1:{free_port()}"  # taken just before the processes start
    with tempfile.TemporaryDirectory(prefix="nhpsi_multihost_") as tmp:
        codes, outs, timed_out = run_processes(
            [[sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.scaling_report",
              *MULTIHOST_ARGS, "--coordinator", coord, "--num-processes",
              str(MULTIHOST_PROCESSES), "--process-id", str(i)]
             for i in range(MULTIHOST_PROCESSES)], tmp, MULTIHOST_TIMEOUT, ROOT)
    if codes != [0] * MULTIHOST_PROCESSES:
        for i, out in enumerate(outs):
            sys.stderr.write(f"--- [multihost] process {i} (exit {codes[i]}):\n{out[-4000:]}\n")
        fail(f"[multihost] the processes exited with {codes}"
             + (f" (killed at the {MULTIHOST_TIMEOUT:.0f} s limit)" if timed_out else ""))
    lines = [line for line in outs[0].splitlines() if line.startswith("{")]
    if len(lines) != 1 or any(line.startswith("{") for line in outs[1].splitlines()):
        fail("[multihost] process 0, and it alone, must print one report line")
    report = json.loads(lines[0])
    cfg = report["config"]
    rows = {r["label"]: r for r in report["rows"]}
    row = rows.get(MULTIHOST_LABEL)
    if row is None or row.get("bit_equal") is not True:
        fail(f"[multihost] row (c) {MULTIHOST_LABEL!r} is missing or not bit-equal with the "
             f"unsharded step: {report['rows']}")
    launches = row["launches"]
    lacking = [i for i, c in enumerate(launches) if min(c.values()) <= 0]
    if len(launches) != MULTIHOST_PROCESSES or lacking:
        fail(f"[multihost] processes {lacking} did not launch K1 and K2: {launches}")
    if "H100" not in report["card"]:
        fail(f"[multihost] the report's card line names no H100: {report['card']!r}")
    out = {"phase_s": time.perf_counter() - t_phase, "coordinator": coord,
           "rows": [{k: r[k] for k in ("label", "ranks", "transport", "ms_per_query", "rate",
                                       "efficiency") if k in r} for r in report["rows"]],
           "launches": launches, "card": report["card"]}
    print("[multihost] " + "; ".join(
        f"{r['label']}: {r['ms_per_query']:.3f} ms/query, {r['rate']:.1f} depth rows/s, "
        f"efficiency {r['efficiency']:.3f}" + (f", bit-equal {r['bit_equal']}"
                                               if "bit_equal" in r else "")
        for r in report["rows"]) + f"; launches per process over the timed queries {launches}"
        f" | ring {cfg['ring']}, L = {cfg['limbs']}, D = {cfg['depths']}, two processes on one "
        f"card over {coord} | {smi_line}",
        flush=True)
    print(f"[multihost] phase {out['phase_s']:.2f} s (both processes' start and build "
          "included)", flush=True)
    return out


BENCH_PIE_CONFIGS = ("2^20", "2^24")  # bench_pie_online's sweep rows run in [bench]


def bench_phase(smi_line: str) -> dict:
    """[bench]: the port's bench and eval tools at full size, the K1 and K2
    wrapper calls counted from 0 (a CUDA graph's capture counts each of its
    calls once, its replays not): the headline bench (K1 at (512, 6, 16384),
    the plain NTT and K1 in L2, the 2^20 x 2048 online query in four
    readings with Q = 32, query 0's packed mask held to the host decrypt),
    profile_online's six parts and hps_parts' eight on the same PIE,
    bench_pie_online at 2^20 and 2^24 (K2 held bit-exact to its plain
    version at each table's shape, then its share of its bound, P = 58 at
    2^24) and bench_ntt_kernel at (512, 6, 16384), whose chained output is
    held to the plain chain. Fails on any mismatch or if the phase called
    no K1 or no K2."""
    import torch

    from nested_hashing_psi_tpu_torch.benchmarks import (
        bench,
        bench_ntt_kernel,
        bench_pie_online,
        profile_online,
        small_pie,
    )
    from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels
    from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
    from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    print(f"[bench] the port's bench and eval tools on {smi_line}", flush=True)
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    rates = bench.ntt_rates(dev)
    built = small_pie.bench_row(device=dev)
    try:
        pie = bench.pie_online(built, dev)
    except RuntimeError as e:  # query 0's packed mask differs from the host decrypt
        fail(f"[bench] {e}")
    line = bench.headline(rates, pie, dev)
    print(f"[bench] {json.dumps(line)}", flush=True)
    rows = {"profile_online": profile_online.main_rows(built, dev),
            "hps_parts": profile_online.hps_rows(built, dev)}
    for tag, res in rows.items():
        profile_online.print_rows(tag, res)
    profile_online.print_sum(rows["profile_online"])
    del built
    torch.cuda.empty_cache()
    pie_runs = {}
    for c in BENCH_PIE_CONFIGS:
        try:
            pie_runs[c] = bench_pie_online.run(c, dev)
        except RuntimeError as e:  # K2 differs from its plain version
            fail(f"[bench] bench_pie_online {c}: {e}")
        torch.cuda.empty_cache()
    ntt_runs = bench_ntt_kernel.main([])
    ps = ntt_primes(bench_ntt_kernel.LIMBS, 31, 2 * bench_ntt_kernel.N)
    plan = NTTPlan(bench_ntt_kernel.N, ps)
    x = torch.randint(0, min(ps), (512, bench_ntt_kernel.LIMBS, bench_ntt_kernel.N),
                      device=dev, dtype=torch.int32)
    for inverse, plain in ((False, ntt), (True, intt)):
        got = bench_ntt_kernel.run_chain(x, plan, inverse, "auto", 2)
        want = plain(plain(x, plan), plan)  # the plain version, on the card
        if not torch.equal(got, want):
            fail(f"[bench] bench_ntt_kernel's chained K1 (inverse={inverse}) differs from the "
                 "plain chain")
    del x, got, want
    torch.cuda.synchronize()
    calls = {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
             "pie_ip": pie_kernels.launches}
    out = {"wrapper_calls": calls, "phase_s": time.perf_counter() - t_phase, "headline": line,
           "profile_online": rows["profile_online"], "hps_parts": rows["hps_parts"],
           "bench_pie_online": pie_runs, "bench_ntt_kernel": ntt_runs}
    print(f"[bench] K1 and K2 wrapper calls {calls} (CUDA graph replays not counted); phase "
          f"{out['phase_s']:.2f} s", flush=True)
    if min(calls.values()) <= 0:
        fail(f"[bench] the phase did not launch K1 and K2: {calls}")
    return out


def bench_phase_fresh(smi_line: str) -> dict:
    """``bench_phase`` in a fresh process (its lines passed through, its
    result returned; any failure there fails this run). In a process that
    had already traced the online steps, torch.profiler recorded no kernel
    for the bench's rows on an H100 (torch 2.11), and their kernel counts
    come from the profiler."""
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"out = chip_smoke.bench_phase({smi_line!r}); "
            "print('[bench] result ' + json.dumps(out), flush=True)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.splitlines()
    sys.stdout.write("".join(f"{line}\n" for line in lines
                             if not line.startswith("[bench] result ")))
    sys.stdout.flush()
    result = [line for line in lines if line.startswith("[bench] result ")]
    if proc.returncode != 0 or not result:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"the [bench] phase failed in its own process (exit {proc.returncode})")
    return json.loads(result[-1][len("[bench] result "):])


GOLDEN_SAMPLE = 4096  # coefficients held to the exact CRT in the BasisExtension check


def goldens_phase(smi_line: str) -> dict:
    """[goldens]: the reference's three golden tests through the port at
    their own scale (``tests/torch_golden_cases.py``, ring 16384, on the
    card): TestFHEPIE (15,000 items, SimpleFHE: exactly one zero slot),
    TestBatchedFHEPIE (BatchedFHE: exactly two zeros, both batch slots
    matching) and TestFHEInnerP (merged slots [0, 1, 0, 1]), each with the
    reference's noise bound; each must launch K1, the batched one K2 too.
    Then ``BasisExtension`` at the main path's q -> aux (the L = 6
    context's mul_limbs primes to BFVMulConverter's aux base) on the HPS
    multiply's stacked operands (2, 12, 2, 5, 16384): bit-exact against an
    exact Python-integer CRT on a seeded sample of coefficients (the
    centered value), the lazy variant x + u*q with u in [0, L), timed
    beside ``extend_q_to_aux`` on the same input. Any failed criterion
    fails the run. -> seconds and launches per golden, the conversion's ms."""
    import numpy as np
    import torch

    from nested_hashing_psi_tpu_torch.benchmarks.card import HBM_BYTES_S
    from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
    from nested_hashing_psi_tpu_torch.ops.basis import BasisExtension, BFVMulConverter
    from nested_hashing_psi_tpu_torch.ops.primes import crt_reconstruct, ntt_primes

    sys.path.append(os.path.join(ROOT, "tests"))  # the goldens, shared with the tests
    import torch_golden_cases as goldens

    t_phase = time.perf_counter()
    out = {}
    for name, fn in (("TestFHEPIE", goldens.golden_fhe_pie),
                     ("TestBatchedFHEPIE", goldens.golden_batched_fhe_pie),
                     ("TestFHEInnerP", goldens.golden_inner_product)):
        try:
            r = fn(CUDA)
        except AssertionError as e:
            fail(f"[goldens] {name} at ring {goldens.RING}: {e}")
        got, zeros = r["launches"], r["zeros"]
        if name == "TestFHEInnerP":
            result = f"merged slots {r['slots']}"
        else:
            where = [tuple(int(i) for i in w) for w in np.argwhere(zeros)]
            result = f"{int(zeros.sum())} zero slot(s) at {where} of {zeros.shape}"
        online = f", online {r['online_s']:.3f} s" if "online_s" in r else ""
        print(f"[goldens] {name} ring {r['ring']} L={r['L']}: {result}; noise "
              f"{r['noise']:.1f} bits (bound {r['noise_bound']}); {r['seconds']:.2f} s"
              f"{online} | launches {got}", flush=True)
        if got["ntt_fwd"] <= 0 or got["ntt_inv"] <= 0:
            fail(f"[goldens] {name} did not launch K1: {got}")
        if name == "TestBatchedFHEPIE" and got["pie_ip"] <= 0:
            fail(f"[goldens] {name} did not launch K2: {got}")
        out[name] = {"seconds": r["seconds"], "online_s": r.get("online_s"),
                     "noise": r["noise"], "noise_bound": r["noise_bound"], "launches": got}
        del r
        torch.cuda.empty_cache()

    T, N, L = goldens.T_33, goldens.RING, 6
    q = ntt_primes(L, 31, 2 * N, avoid=(T,))
    q = q[:bfv_mul_limbs(T.bit_length(), L, 1, ring_dim=N)]
    mc = BFVMulConverter(q, T, N)
    be = BasisExtension(q, mc.aux_primes)
    rng = np.random.default_rng(15)
    shape = (2, 12, 2, len(q), N)
    x_np = (rng.integers(0, 1 << 62, size=shape)
            % np.array(q, np.int64).reshape(len(q), 1)).astype(np.int32)
    x = torch.from_numpy(x_np).to(CUDA)
    exact, lazy = be.convert(x).cpu().numpy(), be.convert(x, correction=False).cpu().numpy()
    if not torch.equal(mc.extend_q_to_aux(x).cpu(), torch.from_numpy(exact)):
        fail("[goldens] extend_q_to_aux differs from BasisExtension.convert on the card")
    cols = x_np.reshape(-1, len(q), N)
    pick = rng.integers(0, cols.shape[0] * N, size=GOLDEN_SAMPLE)
    aux = list(mc.aux_primes)
    ex, lz = exact.reshape(-1, len(aux), N), lazy.reshape(-1, len(aux), N)
    us, bad = set(), 0
    for k in pick:
        row, j = divmod(int(k), N)
        v = crt_reconstruct([int(r) for r in cols[row, :, j]], q)
        vc = v - be.q if v > be.q // 2 else v
        bad += any(int(ex[row, i, j]) != vc % b for i, b in enumerate(aux))
        u, rem = divmod(crt_reconstruct([int(r) for r in lz[row, :, j]], aux) - v, be.q)
        if rem or not 0 <= u < len(q):
            fail(f"[goldens] lazy BasisExtension at column {k}: {v} + {u} q + {rem}")
        us.add(u)
    if bad:
        fail(f"[goldens] BasisExtension differs from the exact CRT at {bad} of "
             f"{GOLDEN_SAMPLE} sampled coefficients")
    be_ms = time_ms(lambda: be.convert(x), CUDA, 20)
    lazy_ms = time_ms(lambda: be.convert(x, correction=False), CUDA, 20)
    ext_ms = time_ms(lambda: mc.extend_q_to_aux(x), CUDA, 20)
    bytes_ms = (x.numel() + exact.size) * 4 / HBM_BYTES_S * 1e3
    print(f"[goldens] BasisExtension q ({len(q)} limbs) -> aux ({len(aux)} limbs) at "
          f"{shape}: bit-exact with the exact CRT on {GOLDEN_SAMPLE} sampled coefficients "
          f"(the centered value); lazy x + u*q with u in {sorted(us)}; {be_ms:.4f} ms "
          f"(lazy {lazy_ms:.4f} ms), extend_q_to_aux {ext_ms:.4f} ms on the same input "
          f"(CUDA events); bytes bound {bytes_ms:.4f} ms | {smi_line}", flush=True)
    out["basis_extension"] = {"ms": be_ms, "lazy_ms": lazy_ms, "extend_q_to_aux_ms": ext_ms,
                              "bytes_bound_ms": bytes_ms, "sample": GOLDEN_SAMPLE}
    del x
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[goldens] phase {out['phase_s']:.2f} s", flush=True)
    return out


HPS_DEPTHS = (12, 48)  # the BFV cells' depths: the 2^20 x 2048 row and the north star
HPS_T = (1 << 32) + (1 << 20) + (1 << 19) + 1  # the cells' plaintext modulus


def hps_phase(smi_line: str, depths=HPS_DEPTHS) -> dict:
    """[hps]: BFV's HPS kernels (csrc/hps.cu, ops/hps_cuda.py) at both BFV
    cells' shapes (ring 16384, L = 6 rescaled to 5 limbs, aux 8, the result
    shipped on 4; D depths of two operands) and at the full basis' (6 limbs,
    aux 9, D = 12): each call must launch one kernel and equal its plain
    version run on the CPU bit for bit; then its device time (CUDA events
    over 20 calls replayed from a CUDA graph) beside its bound
    (benchmarks/card.py), the wrapper's pace (20 calls back to back) and the
    plain version's time on the card. -> {"<kernel>_<shape>": {...}}"""
    import numpy as np
    import torch

    from nested_hashing_psi_tpu_torch.benchmarks.card import (
        hps_rescale_extend_bound,
        hps_scale_exact_bound,
        hps_tensor_bound,
    )
    from nested_hashing_psi_tpu_torch.benchmarks.timing import graph_ms, time_ms
    from nested_hashing_psi_tpu_torch.fhe.bgv import tensor_product
    from nested_hashing_psi_tpu_torch.ops import hps_cuda
    from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter, RNSRescale
    from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants
    from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

    N = 16384
    q = list(ntt_primes(6, 31, 2 * N, avoid=(HPS_T,)))
    rng = np.random.default_rng(22)
    out = {}

    def res(shape, primes):
        p = np.array(primes, np.int64).reshape(len(primes), 1)
        return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))

    def mont(ps, device):
        cols = [torch.tensor(c, dtype=torch.int64, device=device).reshape(-1, 1)
                for c in zip(*[(p, *mont_constants(p)) for p in ps])]
        return cols  # p, pinv, r2

    def check(name, label, kernel, plain_cpu, plain_card, bound):
        before = hps_cuda.launches
        got = kernel()
        torch.cuda.synchronize()
        if hps_cuda.launches != before + 1:
            fail(f"[hps] {name} {label} launched {hps_cuda.launches - before} kernels")
        got = got if isinstance(got, tuple) else (got,)
        want = plain_cpu()
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w):
                bad = int((g.cpu() != w).sum())
                fail(f"[hps] {name} {label} differs from its plain version at {bad} residues")
        del got, want
        ms = graph_ms(kernel, CUDA, 20)
        wrapper_ms = time_ms(kernel, CUDA, 20)
        plain_ms = time_ms(plain_card, CUDA, 3)
        b_ms, b_by = bound
        out[f"{name}_{label}"] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                                  "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        print(f"[hps] {name} {label}: bit-exact with the plain version on the CPU; "
              f"{ms:.4f} ms from a CUDA graph (the wrapper's pace {wrapper_ms:.4f}), bound "
              f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}; plain on the card "
              f"{plain_ms:.3f} ms ({plain_ms / ms:.0f}x) | {smi_line}", flush=True)
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    for L, mul, D in [(6, 5, D) for D in depths] + [(6, 6, 12)]:
        label = f"D{D}_L{L}" + (f"to{mul}" if mul < L else "")
        mc = BFVMulConverter(q[:mul], HPS_T, N)
        aux, KA = list(mc.aux_primes), mc.K + 1
        if mul < L:
            rs = RNSRescale(q, L - mul)
            x = res((2, D, 2, L, N), q)
            xg = x.to(CUDA)
            check("rescale_extend", label, lambda: rs.rescale_extend(xg, mc.q_to_aux),
                  lambda: rs.rescale_extend(x, mc.q_to_aux),
                  lambda: mc.q_to_aux.convert_plain(rs.rescale_plain(xg)),
                  hps_rescale_extend_bound(4 * D, N, L, mul, KA))
            ship = RNSRescale(q[:mul], 1)
            s = res((D, 2, mul, N), q[:mul])
            sg = s.to(CUDA)
            check("ship_rescale", f"D{D}_L{mul}to{mul - 1}", lambda: ship.rescale(sg),
                  lambda: ship.rescale(s), lambda: ship.rescale_plain(sg),
                  hps_rescale_extend_bound(2 * D, N, mul, mul - 1, 0))
            del x, xg, s, sg
        else:
            x = res((2, D, 2, L, N), q)
            xg = x.to(CUDA)
            check("extension", label, lambda: mc.extend_q_to_aux(xg),
                  lambda: mc.extend_q_to_aux(x), lambda: mc.q_to_aux.convert_plain(xg),
                  hps_rescale_extend_bound(4 * D, N, L, 0, KA))
            del x, xg
        a, b = res((D, 2, mul, N), q[:mul]), res((D, 2, mul, N), q[:mul])
        ea, eb = res((D, 2, KA, N), aux), res((D, 2, KA, N), aux)
        ag, bg, eag, ebg = (t.to(CUDA) for t in (a, b, ea, eb))
        mq, ma, mqg, mag = mont(q[:mul], "cpu"), mont(aux, "cpu"), mont(q[:mul], CUDA), \
            mont(aux, CUDA)
        check("tensor", label, lambda: hps_cuda.tensor_products(ag, bg, eag, ebg, mc),
              lambda: (tensor_product(a, b, *mq), tensor_product(ea, eb, *ma)),
              lambda: (tensor_product(ag, bg, *mqg), tensor_product(eag, ebg, *mag)),
              hps_tensor_bound(D, N, mul, KA))
        del a, b, ea, eb, ag, bg, eag, ebg
        d_q, d_aux = res((D, 3, mul, N), q[:mul]), res((D, 3, KA, N), aux)
        dqg, dag = d_q.to(CUDA), d_aux.to(CUDA)
        check("scale_exact", label, lambda: mc.scale_round_to_q(dqg, dag),
              lambda: mc.scale_round_to_q(d_q, d_aux),
              lambda: mc.exact_to_q_plain(mc.scale_round_plain(dqg, dag)),
              hps_scale_exact_bound(3 * D, N, mul, KA))
        del d_q, d_aux, dqg, dag
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[hps] phase {out['phase_s']:.2f} s", flush=True)
    return out


def decrypt_check(label: str, ctx, sk, result, length: int) -> dict:
    """The decrypt kernel on one result (its own form, leading shape and
    shipped limbs, decrypted in the context of its limb count): its mask
    against the plain version's and the host decrypt's, bit for bit; the
    kernel's CUDA-event time on the phase, the whole ``zero_mask`` call
    (the phase's mont_mul, K1's inverse NTT, the kernel) by CUDA events and
    by the host clock with the mask's download, the plain version and the
    host decrypt, and the kernel's bound."""
    import numpy as np

    from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    L = result.data.shape[-2]
    dctx, dsk = ctx.context_for_limbs(L), ctx.shrink_key_to(sk, L)
    t0 = time.perf_counter()
    dec = DeviceDecryptor(dctx, result.form)
    build_ms = (time.perf_counter() - t0) * 1e3
    cuda = result.data.device
    before = decrypt_cuda.launches
    mask = dec.zero_mask(result.data, dsk.s_mont, length)
    if decrypt_cuda.launches != before + 1:
        fail(f"[decrypt] {label}: zero_mask launched {decrypt_cuda.launches - before} kernels")
    lo, hi = dec._slot_planes(result.data, dsk.s_mont)
    plain = ((lo == 0) & (hi == 0))[..., :length]
    slots, _ = dctx.decrypt(result, dsk, length=length)
    host = np.asarray(slots, dtype=object) == 0
    err = int((mask != plain).sum()) + int((mask.cpu().numpy() != host).sum())
    if err:
        fail(f"the decrypt kernel's mask ({label}) differs from the plain version's "
             f"or the host decrypt's in {err} slots")
    phase = dec._phase(result.data, dsk.s_mont)
    rows = phase.numel() // (L * dctx.n)
    args = (phase.reshape(rows, L, dctx.n), *dec.kernel_tables, result.form == "bgv", length)
    kernel_ms = time_ms(lambda: decrypt_cuda.zero_mask(*args), cuda, 50)
    call_ms = time_ms(lambda: dec.zero_mask(result.data, dsk.s_mont, length), cuda, 20)
    call_wall = wall_ms(lambda: dec.zero_mask(result.data, dsk.s_mont, length).cpu(), cuda, 10)
    plain_ms = time_ms(lambda: dec._slot_planes(result.data, dsk.s_mont), cuda, 3)
    host_ms = wall_ms(lambda: dctx.decrypt(result, dsk, length=length), cuda, 3)
    b_ms, b_by = decrypt_bound(rows, L, dctx.n, length, result.form == "bgv")
    print(f"[decrypt] {label}: {result.form} result {tuple(result.data.shape)}, t = {dctx.t}: "
          f"the kernel's mask == the plain version's == the host decrypt's "
          f"({int(host.sum())} zero slots of {host.size}); kernel {kernel_ms:.4f} ms (CUDA "
          f"events; bound {b_ms:.4f} ms by {b_by}, share {b_ms / kernel_ms:.3f}); zero_mask "
          f"call {call_ms:.4f} ms, {call_wall:.4f} ms with the mask's copy to the host; plain "
          f"{plain_ms:.3f} ms; host decrypt {host_ms:.3f} ms; decryptor built in "
          f"{build_ms:.1f} ms", flush=True)
    return {"max_abs_err": err, "shape": list(result.data.shape), "t": int(dctx.t),
            "ms": kernel_ms, "call_ms": call_ms, "call_wall_ms": call_wall,
            "plain_ms": plain_ms, "host_ms": host_ms, "bound_ms": b_ms, "bound_by": b_by}


def max_err(got, want, name: str) -> int:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    return int((got.long() - want.long()).abs().max().item())


def compare(name, kernel_fn, plain_fn, iters=20, plain_iters=3):
    """Run kernel and plain version on the same inputs; exact comparison."""
    err = max_err(kernel_fn(), plain_fn(), name)
    ms = time_ms(kernel_fn, CUDA, iters)
    plain_ms = time_ms(plain_fn, CUDA, plain_iters)
    print(f"[kernel] {name}: max_abs_err {err} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms", flush=True)
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain version (max_abs_err {err})")
    return err, ms, plain_ms


HPS_KERNELS = ("rescale_extend_kernel", "tensor_kernel", "scale_exact_kernel")  # csrc/hps.cu


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
    groups = {"K1": [0.0, 0], "K2": [0.0, 0], "HPS": [0.0, 0], "plain": [0.0, 0]}
    k1_kernels = {}  # K1 by kernel instance <log2 n, window's low bit, width>
    for e in kernels:
        name = e["name"]
        g = ("K1" if "ntt_fwd" in name or "ntt_inv" in name
             else "K2" if "pie_ip" in name
             else "HPS" if any(k in name for k in HPS_KERNELS) else "plain")
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


def k2_path_queries(pie_dev, pie_host, idx_ct, minus_ct, parts: int = 4) -> dict:
    """trace_online of the two paths whose running sums K2 carries: one
    ``--streamChunks`` query (``run_streamed`` over ``parts`` equal
    contiguous chunks of the index, as the wire delivers them) on the device
    table, and one host-table query in ``parts`` slices
    (``_run_host_table``)."""
    w = pie_dev.P // parts
    chunks = [(p0, idx_ct.data[:, p0:p0 + w].contiguous()) for p0 in range(0, pie_dev.P, w)]
    return {
        f"streamChunks {parts}": trace_online(
            lambda: pie_dev.run_streamed(iter(chunks), minus_ct)),
        f"host table, {parts} slices": trace_online(
            lambda: pie_host._run_host_table(idx_ct, minus_ct, w)),
    }


def print_k2_paths(paths: dict, tag: str = "k2_paths") -> None:
    for label, tr in paths.items():
        print(f"[{tag}] {label}: one query, steady state: wall median "
              f"{tr['wall_ms_median']:.3f} ms; traced: K2 {tr['K2_ms_per_query']:.4f} ms/query "
              f"({tr['K2_launches_per_query']:.0f} kernels), plain PyTorch "
              f"{tr['plain_ms_per_query']:.3f} ms/query ({tr['plain_launches_per_query']:.0f} "
              f"kernels), K1 {tr['K1_ms_per_query']:.4f} ms/query "
              f"({tr['K1_launches_per_query']:.0f}); busy share {tr['busy_share']:.3f}",
              flush=True)


def host_cpu() -> str:
    """The host CPU as lscpu names it: its model name, and its vendor,
    family and model number (a host may withhold the name), with the
    logical CPUs."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        return f"lscpu unavailable, {os.cpu_count()} logical CPUs"
    f = {k.strip(): v.strip() for k, _, v in (ln.partition(":") for ln in out.splitlines())}
    return (f"model name {f.get('Model name', '?')} ({f.get('Vendor ID', '?')} family "
            f"{f.get('CPU family', '?')} model {f.get('Model', '?')}), "
            f"{os.cpu_count()} logical CPUs")


def elgamal_phase(cli, run_in_process, reset_counts, read_counts, smi_line: str) -> dict:
    """[elgamal]: each run of ELGAMAL_RUNS through cli.parse_args and
    run_in_process on device cuda, with every kernel count set to 0 just
    before (reset_counts) and read just after (read_counts: the path
    launches none); fails unless it verifies with the expected
    intersection. The server's phases are timed by wrapping its phase
    methods. Returns {label: times}."""
    from nested_hashing_psi_tpu_torch.protocol import elgamal

    print(f"[elgamal] host timings (the ElGamal parties compute on the host in both "
          f"packages; no kernel runs): host CPU {host_cpu()} | card {smi_line}", flush=True)
    server_s: dict[str, float] = {}

    def timed(fn, phase):
        def run(self):
            t0 = time.perf_counter()
            fn(self)
            server_s[phase] = time.perf_counter() - t0
        return run

    out, t_phase = {}, time.perf_counter()
    for label, flags in ELGAMAL_RUNS:
        psi, ht, device = cli.parse_args(flags)
        reset_counts()
        server_s.clear()
        cls = elgamal.PrecompElGamalPSIServer if psi.precomp else elgamal.SimpleElGamalPSIServer
        saved = {ph: getattr(cls, f"run_{ph}_phase") for ph in ("setup", "offline", "online")}
        try:
            for ph, fn in saved.items():
                setattr(cls, f"run_{ph}_phase", timed(fn, ph))
            t0 = time.perf_counter()
            client, server, ok = run_in_process(psi, ht, device=device)
            wall = time.perf_counter() - t0
        finally:
            for ph, fn in saved.items():
                setattr(cls, f"run_{ph}_phase", fn)
        launched = read_counts()
        found = len(client.intersection_calculated)
        m = {k: v.duration_us / 1e6 for k, v in client.measurements.items()}
        times = {"wall_s": wall, **{f"client_{k.lower()}_s": v for k, v in m.items()},
                 **{f"server_{k}_s": v for k, v in server_s.items()},
                 "server_offline_compute_s": server.offline_computation_us / 1e6,
                 "server_online_compute_s": server.online_computation_us / 1e6}
        print(f"[elgamal] {label}: {' '.join(flags)} | {client.protocol_name} found={found} "
              f"ok={ok} native={server.enc.group._native is not None}/"
              f"{client.enc.group._native is not None} (server/client) | client setup "
              f"{m['Setup']:.3f} s, offline {m['Offline']:.3f} s, online {m['Online']:.3f} s | "
              f"server setup {server_s['setup']:.3f} s, offline {server_s['offline']:.3f} s, "
              f"online {server_s['online']:.3f} s; offline compute "
              f"{times['server_offline_compute_s']:.3f} s, online compute (sum over its "
              f"jobs) {times['server_online_compute_s']:.3f} s | wall {wall:.3f} s | "
              f"kernel launches {launched}", flush=True)
        if not ok or found != psi.intersection_set_size:
            fail(f"[elgamal] {label} did not verify: ok={ok} found={found}")
        if any(launched.values()):
            fail(f"[elgamal] {label} launched kernels on a host-only path: {launched}")
        if (server.enc.group._native is None or client.enc.group._native is None
                or client.device.type != "cuda"):
            fail(f"[elgamal] {label}: a party ran without the native EC library, or the "
                 "device was not resolved")
        out[label] = times
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[elgamal] phase {out['phase_s']:.2f} s", flush=True)
    return out


def fresh_resume(artifact: str, workdir: str) -> tuple[dict, "np.ndarray", float]:
    """``python -m ...bench_e2e_psi --resume artifact`` in a fresh process on
    the GPU, with jax and the JAX package made unimportable (stubs that
    raise shadow them). Fails unless it exits 0 and prints "Set matches!"
    with EXPECTED_FOUND found. -> (its printed times and kernel launches,
    its result array, the process's wall seconds)."""
    import numpy as np

    stub = os.path.join(workdir, "stub")
    for mod in ("jax", "nested_hashing_psi_tpu"):
        os.makedirs(os.path.join(stub, mod), exist_ok=True)
        with open(os.path.join(stub, mod, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('the resume must not import {mod}')\n")
    result = os.path.join(workdir, "resumed_result.npy")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([stub, ROOT]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi",
         "--resume", artifact, "--device", "cuda", "--resultOut", result],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[checkpoint] fresh process: {line}", flush=True)
    if (proc.returncode != 0 or "RESUME RESULT: Set matches!" not in proc.stdout
            or f"|intersection| {EXPECTED_FOUND})" not in proc.stdout):
        fail(f"[checkpoint] the fresh-process resume did not verify (rc {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    m = re.search(r"load ([0-9.]+)s, online query ([0-9.]+)s, decrypt ([0-9.]+)s", proc.stdout)
    info = {"load_s": float(m.group(1)), "query_s": float(m.group(2)),
            "decrypt_s": float(m.group(3)),
            "launches": json.loads(proc.stdout.split("kernel launches ", 1)[1].splitlines()[0])}
    return info, np.load(result), wall


def checkpoint_phase(server, client, pie_host, want, launches: dict, smi_line: str) -> dict:
    """[checkpoint]: save the one-query server's PIE and its client sidecar
    (bench_e2e_psi.save_artifact), resume them in a fresh process that must
    verify with EXPECTED_FOUND found, launch K1 and K2 and answer bit-equal
    with this process's pie.run; then save phase 5's host-resident PIE,
    resume it here, and check that it stayed host-resident, position-major
    and pinned, and that run() is bit-equal with the device table's result
    ``want``. Adds the resumed runs' launches to ``launches``."""
    import numpy as np
    import torch

    from nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi import save_artifact
    from nested_hashing_psi_tpu_torch.convert import to_numpy
    from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels
    from nested_hashing_psi_tpu_torch.utils.checkpoint import load_batched_pie, save_batched_pie

    out = {}
    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "main_row.npz")
        out["save_s"], out["bytes"], out["sidecar_bytes"] = save_artifact(art, server, client)
        built = to_numpy(server.pie.run(client.idx_ct, client.minus_ct).data)
        info, resumed, out["fresh_process_s"] = fresh_resume(art, d)
        out.update({f"fresh_{k}": v for k, v in info.items()})
        if resumed.dtype != built.dtype or not np.array_equal(resumed, built):
            fail(f"[checkpoint] the fresh process's result {resumed.shape}/{resumed.dtype} differs "
                 f"from the building process's {built.shape}/{built.dtype}")
        if min(info["launches"].values()) <= 0:
            fail(f"[checkpoint] the fresh-process resume did not launch K1 and K2: "
                 f"{info['launches']}")
        for k, v in info["launches"].items():
            launches[k] += v

        host_art = os.path.join(d, "main_row_host.npz")
        t0 = time.perf_counter()
        save_batched_pie(host_art, pie_host)
        out["host_save_s"] = time.perf_counter() - t0
        out["host_bytes"] = os.path.getsize(host_art)
        t0 = time.perf_counter()
        rh = load_batched_pie(host_art, device="cuda")
        out["host_load_s"] = time.perf_counter() - t0
        if not (rh.host_table and rh.table_pt.is_pinned() and rh._host_positions().is_contiguous()
                and rh.table_pt.device.type == "cpu"):
            fail(f"[checkpoint] the host-resident artifact resumed with host_table="
                 f"{rh.host_table}, pinned {rh.table_pt.is_pinned()}, position-major "
                 f"{rh._host_positions().is_contiguous()}, on {rh.table_pt.device}")
        ntt_cuda.reset_launches()
        pie_kernels.reset_launches()
        got = rh.run(client.idx_ct, client.minus_ct).data
        torch.cuda.synchronize()
        host_launched = {"ntt_fwd": ntt_cuda.launches["ntt"],
                         "ntt_inv": ntt_cuda.launches["intt"], "pie_ip": pie_kernels.launches}
        if not torch.equal(got, want):
            fail("[checkpoint] the resumed host-resident PIE's run() differs from the device "
                 "table's")
        if min(host_launched.values()) <= 0:
            fail(f"[checkpoint] the resumed host-resident run did not launch K1 and K2: "
                 f"{host_launched}")
        for k, v in host_launched.items():
            launches[k] += v
        out["host_launches"] = host_launched
    print(f"[checkpoint] main row: artifact {out['bytes']} B + sidecar {out['sidecar_bytes']} B, "
          f"saved in {out['save_s']:.3f} s; fresh process {out['fresh_process_s']:.2f} s wall "
          f"(load {info['load_s']:.3f} s, query {info['query_s']:.3f} s, decrypt "
          f"{info['decrypt_s']:.3f} s), Set matches! with {EXPECTED_FOUND} found, launches "
          f"{info['launches']}, result bit-equal with this process's | host-resident artifact "
          f"{out['host_bytes']} B: save {out['host_save_s']:.3f} s, load {out['host_load_s']:.3f} "
          f"s, resumed host-resident, position-major, pinned, run() bit-equal, launches "
          f"{host_launched} | host CPU {host_cpu()} | card {smi_line}", flush=True)
    return out


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
        from nested_hashing_psi_tpu_torch.benchmarks import common as bench_common
        from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext
        from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, bfv_mul_limbs
        from nested_hashing_psi_tpu_torch.ops import (
            cuda_lib,
            decrypt_cuda,
            hps_cuda,
            ntt_cuda,
            ntt_mxu,
            pie_kernels,
        )
        from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
        from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan
        from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
        from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE
        from nested_hashing_psi_tpu_torch.protocol import simple_fhe
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
    ptxas = bench_common.ptxas_instances(cuda_lib.build(verbose=True))
    cuda_lib.get_lib()
    print(f"[build] {len(cuda_lib.sources())} sources -> {cuda_lib.LIB_PATH} in "
          f"{time.perf_counter() - t0:.2f} s; {ptxas_summary(ptxas)}", flush=True)
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
    vpu_regs = {m: bench_common.instance(ptxas, f"vpu_ops_kernelILi{i}E")
                for i, m in enumerate(bench_vpu_ops.MIXES)}
    print("[sass] A1 registers / spill-store bytes per instance: " + "; ".join(
        f"{m} {r['registers']}/{r['spill_stores']}" for m, r in vpu_regs.items()), flush=True)
    spilled = {m: r["spill_stores"] + r["spill_loads"] for m, r in vpu_regs.items()
               if r["spill_stores"] or r["spill_loads"]}
    if spilled:
        fail(f"A1 instances spill (bytes of spill stores and loads): {spilled}")
    probe_plan = SplitNTTPlan(16384, ntt_primes(6, 31, 2 * 16384))
    # the redesigned probe kernels (A2's three forms, A3's stages) by name
    probe_kernels = {v: bench_ntt_lazy_probe.kernel_name(128, v)
                     for v in bench_ntt_lazy_probe.VARIANTS}
    probe_kernels["stages"] = bench_ntt_anatomy.kernel_name(128, "stages")
    probe_floor = {**bench_ntt_lazy_probe.MIN_ARITH, **bench_ntt_anatomy.MIN_ARITH}
    probe_sass = {v: bench_ntt_lazy_probe.sass_per_butterfly(k, probe_plan)
                  for v, k in probe_kernels.items()}
    moves_ops = bench_ntt_anatomy.moves_sass(probe_plan)["opcodes"]
    print("[sass] A2 and A3 at n = 16384, per butterfly, FMA pipe (slots) + ALU + memory: "
          + "; ".join(f"{v} {s['fma']:.2f} ({s['fma_slots']:.2f}) + {s['alu']:.2f} + "
                      f"{s['memory']:.2f}" for v, s in probe_sass.items())
          + f"; A3 moves, its row loop (static): LDS {moves_ops.get('LDS', 0):.0f}, STS "
          f"{moves_ops.get('STS', 0):.0f}", flush=True)
    if not (moves_ops.get("LDS") and moves_ops.get("STS")):
        fail("A3's moves kernel has no LDS/STS: it does not move the data through shared memory")
    folded = {v: (s["arith"], probe_floor[v]) for v, s in probe_sass.items()
              if s["arith"] < probe_floor[v]}
    if folded:
        fail(f"A2/A3 butterflies below their floor (FMA + ALU per butterfly, floor): {folded}")
    probe_regs = {}
    for m in bench_ntt_lazy_probe.KERNEL_M:
        for v in (*bench_ntt_lazy_probe.VARIANTS, *bench_ntt_anatomy.VARIANTS):
            mod = bench_ntt_lazy_probe if v in bench_ntt_lazy_probe.VARIANTS else bench_ntt_anatomy
            probe_regs[(m, v)] = bench_common.instance(ptxas, mod.kernel_name(m, v))
    print("[sass] A2 and A3 registers / spill-store bytes per instance: " + "; ".join(
        f"{v} m={m} {r['registers']}/{r['spill_stores']}" for (m, v), r in probe_regs.items()),
        flush=True)
    spilled = {f"{v} m={m}": r["spill_stores"] for (m, v), r in probe_regs.items()
               if v != "moves" and r["spill_stores"]}
    if spilled:
        fail(f"redesigned probe instances spill (bytes of spill stores): {spilled}")

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
    time_ms(lambda: ntt_cuda.ntt(warm, warm_plan), CUDA, 500)
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
            forms[form] = graph_ms(ffn, CUDA)
        if err != 0:
            fail(f"K1 launch {label} {shape}: kernel disagrees with plain (max_abs_err {err})")
        ms, dev_ms = time_ms(kfn, CUDA, 50), graph_ms(kfn, CUDA)
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
    # the host-resident path's position-major buffer, read in place through
    # its (H, D, P, L, N) view
    pm = pt.permute(2, 0, 1, 3, 4).contiguous().permute(1, 2, 0, 3, 4)
    results["pie_ip_position_major"] = compare(
        f"K2 position sum over the position-major ({P},{H},{D},{L},{N}) table",
        lambda: pie_kernels.indexed_inner_product(idx, pm, tb["p_u32"], tb["pinv_u32"]),
        lambda: pie_kernels.indexed_inner_product_plain(idx, pm, tb["p"], tb["pinv"]),
        plain_iters=2) + k2_bound(H, D, P, L, N)
    del pm
    # a running sum, updated in place (the streamed chunks' and the host
    # table's slices' sums): positions [3, 6) added to acc
    acc0 = residues((H, D, 2, L, N), q)
    acc = acc0.clone()
    got = pie_kernels.indexed_inner_product(idx_s, pt, tb["p_u32"], tb["pinv_u32"], p0=3,
                                            acc=acc)
    want = pie_kernels.indexed_inner_product_plain(idx_s, pt, tb["p"], tb["pinv"], p0=3,
                                                   acc=acc0)
    err = max_err(got, want, "K2 with acc")
    if err != 0 or got.data_ptr() != acc.data_ptr():
        fail(f"K2 with acc: max_abs_err {err}, in place {got.data_ptr() == acc.data_ptr()}")
    ms = time_ms(lambda: pie_kernels.indexed_inner_product(
        idx_s, pt, tb["p_u32"], tb["pinv_u32"], p0=3, acc=acc), CUDA, 20)
    plain_ms = time_ms(lambda: pie_kernels.indexed_inner_product_plain(
        idx_s, pt, tb["p"], tb["pinv"], p0=3, acc=acc0), CUDA, 2)
    results["pie_ip_acc"] = (err, ms, plain_ms) + k2_bound(H, D, 3, L, N, acc=True)
    print(f"[kernel] K2 position sum over positions [3, 6) added to acc in place: max_abs_err "
          f"{err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    # K2's launch alone: how much of the wrapper's event time above is the
    # host preparing each call
    lib, stream = cuda_lib.get_lib(), torch.cuda.current_stream().cuda_stream
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=dev)
    for key, ii, view in (("pie_ip", idx, pt), ("pie_ip_slice", idx_s, pt[:, :, 3:6])):
        raw_ms = time_ms(lambda: lib.nhpsi_pie_ip(
            ii.data_ptr(), view.data_ptr(), None, out.data_ptr(), tb["p_u32"].data_ptr(),
            tb["pinv_u32"].data_ptr(), H, D, ii.shape[1], L, N, ii.stride(0),
            *view.stride()[:4], stream), CUDA, 20)
        err, ms, _, b_ms, b_by = results[key]
        print(f"[kernel] K2 {key}: wrapper {ms:.4f} ms, launch alone {raw_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), share of the bound {b_ms / raw_ms:.3f} "
              f"(launch) {b_ms / ms:.3f} (wrapper)", flush=True)
    del idx, pt, idx_s, out, acc, acc0
    # K2 at L = 6..10 (the flat --bgv path runs L = 9): time and share of
    # the bound at each, bit-exact with the plain version
    k2_sweep = {}
    for Ls in range(6, 11):
        qs = ntt_primes(Ls, 31, 2 * N, avoid=(T,))
        tbs = NTTPlan(N, qs).tensors(dev)
        ii, tt = residues((H, P, 2, Ls, N), qs), residues((H, D, P, Ls, N), qs)
        err = max_err(pie_kernels.indexed_inner_product(ii, tt, tbs["p_u32"], tbs["pinv_u32"]),
                      pie_kernels.indexed_inner_product_plain(ii, tt, tbs["p"], tbs["pinv"]),
                      f"K2 at L = {Ls}")
        if err != 0:
            fail(f"K2 at L = {Ls}: kernel disagrees with its plain version (max_abs_err {err})")
        ms = time_ms(lambda: pie_kernels.indexed_inner_product(
            ii, tt, tbs["p_u32"], tbs["pinv_u32"]), CUDA, 20)
        b_ms, b_by = k2_bound(H, D, P, Ls, N)
        k2_sweep[Ls] = ms
        print(f"[k2_sweep] ({H},{D},{P},{Ls},{N}): max_abs_err 0, kernel {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}", flush=True)
        del ii, tt

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
    # [multihost]'s shapes (the scaling report at ring 16384, L = 8, t = 65537,
    # H = 2, P = 8): K2 at D = 8 (each process's dp half) and D = 16 (its
    # unsharded row); K1's relin shapes at the same depths are in the list below
    qm = SchemeParams(ring_dim=N, plaintext_modulus=T16, num_limbs=8).q_primes
    tbm = NTTPlan(N, qm).tensors(dev)
    for Dm in (8, 16):
        idx, pt = residues((2, 8, 2, 8, N), qm), residues((2, Dm, 8, 8, N), qm)
        results[f"pie_ip_multihost_d{Dm}"] = compare(
            f"K2 position sum, [multihost] (H,D,P,L,N)=(2,{Dm},8,8,{N})",
            lambda: pie_kernels.indexed_inner_product(idx, pt, tbm["p_u32"], tbm["pinv_u32"]),
            lambda: pie_kernels.indexed_inner_product_plain(idx, pt, tbm["p"], tbm["pinv"]),
            plain_iters=2) + k2_bound(2, Dm, 8, 8, N)
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
        *((f"[multihost] relin at D = {Dm}, iNTT of d2", True, (Dm,), qm) for Dm in (8, 16)),
        *((f"[multihost] relin at D = {Dm}, decompose digits", False, (Dm, 8), qm)
          for Dm in (8, 16)),
    ):
        plan = NTTPlan(N, ps)
        x = residues((*lead, len(ps), N), ps)
        kfn = (lambda: ntt_cuda.intt(x, plan)) if inverse else (lambda: ntt_cuda.ntt(x, plan))
        want = intt(x, plan) if inverse else ntt(x, plan)
        err = max_err(kfn(), want, f"K1 {label}")
        if err != 0:
            fail(f"K1 {label}: kernel disagrees with plain (max_abs_err {err})")
        ms = time_ms(kfn, CUDA, 10)
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
    dev_ms = time_ms(lambda: ms_dev.mod_switch(ct), CUDA, 10)
    print(f"[mod_switch] (12,2,6,{N}) -> {tuple(got.data.shape)}: cuda bit-equal to the "
          f"CPU port, scale {got.scale}; cuda {dev_ms:.4f} ms (CUDA events), CPU "
          f"{cpu_ms:.1f} ms", flush=True)
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
            k1_ms = time_ms(k1fn, CUDA, 20)
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
    redesigned = {**probe_runs["lazy"], **anat}
    print("[probe] redesigned A2 and A3 at (512, 6, 16384), ms / bound by pipe (by) / share: "
          + "; ".join(f"{v} {redesigned[v]['ms']:.4f} / {redesigned[v]['bound_ms']:.4f} "
                      f"({redesigned[v]['bound_by']}) / "
                      f"{redesigned[v]['bound_ms'] / redesigned[v]['ms']:.3f}"
                      for v in probe_kernels), flush=True)
    torch.cuda.empty_cache()

    # ---- the main path: three protocol runs ----------------------------
    launches, runs = {"ntt_fwd": 0, "ntt_inv": 0, "pie_ip": 0, "decrypt_mask": 0}, {}
    hps_launches = {}  # the HPS kernels (csrc/hps.cu) each run launched

    def drive(label, flags):
        """One protocol run through the user entry points, the launch counts
        set to 0 just before it and read just after; prints its [main] line
        and fails unless it verified with the expected intersection."""
        ntt_cuda.reset_launches()
        pie_kernels.reset_launches()
        decrypt_cuda.reset_launches()
        hps_cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        psi, ht, device = cli.parse_args(flags)
        t0 = time.perf_counter()
        client, server, ok = run_in_process(psi, ht, device=device)
        wall = time.perf_counter() - t0
        got = {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
               "pie_ip": pie_kernels.launches, "decrypt_mask": decrypt_cuda.launches}
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
              f"hps {hps_cuda.launches} | peak device memory {peak:.3f} GiB", flush=True)
        if not ok or found != psi.intersection_set_size:
            fail(f"main path ({label}) did not verify: ok={ok} found={found}")
        for k in launches:
            launches[k] += got[k]
        hps_launches[label] = hps_cuda.launches
        runs[label] = (client, server)
        return client, server, got

    for label, extra in RUNS:
        client, _, got = drive(label, MAIN_FLAGS + extra)
        if len(client.intersection_calculated) != EXPECTED_FOUND:
            fail(f"main path ({label}) found {len(client.intersection_calculated)}")
        if min(got.values()) <= 0:
            fail(f"the main path ({label}) did not launch every kernel: {got}")
        if hps_launches[label] <= 0:
            fail(f"BFV's main path ({label}) did not launch the HPS kernels")
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
        device_ms = sum(tr[f"{g}_ms_per_query"] for g in ("K1", "K2", "HPS", "plain"))
        print(f"[trace] {label}: online step, one query, steady state: wall median "
              f"{tr['wall_ms_median']:.3f} ms (min {tr['wall_ms_min']:.3f}, max "
              f"{tr['wall_ms_max']:.3f}) over {timed} queries; traced {n_traced}: device "
              f"{device_ms:.3f} ms/query, K1 {tr['K1_ms_per_query']:.4f} ms/query "
              f"({tr['K1_launches_per_query']:.0f} launches{k1_bound_note}), K2 "
              f"{tr['K2_ms_per_query']:.4f} ms/query ({tr['K2_launches_per_query']:.0f}), "
              f"HPS {tr['HPS_ms_per_query']:.4f} ms/query ({tr['HPS_launches_per_query']:.0f}), "
              f"plain PyTorch {tr['plain_ms_per_query']:.3f} ms/query "
              f"({tr['plain_launches_per_query']:.0f}); busy share {tr['busy_share']:.3f}",
              flush=True)
        print(f"[trace] {label}: K1 by kernel, per query: " + "; ".join(
            f"{k} {ms:.4f} ms ({n:.0f})" for k, (ms, n) in sorted(tr["k1_kernels"].items())),
            flush=True)

    traced("queries=1", f"; bound {k1_query['bound_ms']:.4f} ms")
    client, server = runs["queries=1"]

    # ---- device decrypt vs host decrypt on the one-query result ---------
    decrypts = {"bfv": decrypt_check("queries=1", client.ctx, client.sk,
                                     server.pie.run(client.idx_ct, client.minus_ct),
                                     client.ht.batch_slots)}
    client4, server4 = runs["queries=4"]
    many = server4.pie.run_many(torch.stack([client4.idx_ct.data] * 4),
                                torch.stack([client4.minus_ct.data] * 4))
    decrypts["queries4"] = decrypt_check("queries=4", client4.ctx, client4.sk,
                                         Ciphertext(many, "bfv", 1), client4.ht.batch_slots)
    del many

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
    ms_dev = wall_ms(lambda: pie_dev.run(i_ct, m_ct), CUDA, 5)
    for pos_chunk in (None, 3):
        got = pie_host._run_host_table(i_ct, m_ct, pos_chunk).data
        if max_err(got, want, "host table") != 0:
            fail(f"host-table PIE (pos_chunk={pos_chunk}) differs from the device table")
        ms_host = wall_ms(lambda: pie_host._run_host_table(i_ct, m_ct, pos_chunk), CUDA, 5)
        print(f"[host_table] pos_chunk={pos_chunk}: run() bit-equal to the device "
              f"table; online {ms_host:.3f} ms vs device table {ms_dev:.3f} ms "
              f"(table {pie_host.table_pt.numel() * 4 / 2**20:.1f} MiB pinned; build "
              f"{t2 - t1:.2f} s host vs {t1 - t0:.2f} s device)", flush=True)
    # ---- the streamed and host-table queries, traced --------------------
    # (each chunk's or slice's K2 adds to the running sum and reads the
    # position-major slices in place: one K2 per part, no add or transpose)
    k2_paths = k2_path_queries(server.pie, pie_host, i_ct, m_ct)
    print_k2_paths(k2_paths)
    for label, tr in k2_paths.items():
        if round(tr["K2_launches_per_query"]) != 4:
            fail(f"{label}: {tr['K2_launches_per_query']} K2 kernels per query, expected 4")
    # ---- the offline artifact: saved, resumed in a fresh process ---------
    checkpoint_times = checkpoint_phase(server, client, pie_host, want, launches, smi_line)
    del pie_dev, pie_host
    torch.cuda.empty_cache()
    # ---- --bgv (flat, then leveled) and SimpleFHE -----------------------
    client, server, got = drive("bgv flat", BGV_FLAGS)
    if server.ctx.L != 9 or server.pie.leveled or len(client.intersection_calculated) != 1024:
        fail(f"flat --bgv: L={server.ctx.L} leveled={server.pie.leveled}, expected L = 9 flat")
    if min(got.values()) <= 0:
        fail(f"flat --bgv did not launch K1 and K2: {got}")
    if not client._decryptors or client.noise_bits is not None:
        fail("the flat --bgv client did not decrypt on the device")
    decrypts["bgv"] = decrypt_check("bgv flat", client.ctx, client.sk,
                                    server.pie.run(client.idx_ct, client.minus_ct),
                                    client.ht.batch_slots)
    client, server, got = drive("bgv leveled", LEVELED_FLAGS)
    leveled = server.pie.run(client.idx_ct, client.minus_ct)
    shipped = leveled.data.shape[-2]
    print(f"[main] bgv leveled: the result ships {shipped} limbs", flush=True)
    if server.ctx.L != 6 or not server.pie.leveled or shipped != 5:
        fail(f"leveled --bgv: L={server.ctx.L} leveled={server.pie.leveled} shipped {shipped}")
    if min(got.values()) <= 0:
        fail(f"leveled --bgv did not launch K1, K2 and the decrypt kernel: {got}")
    if not client._decryptors or client.noise_bits is not None:
        fail("the leveled --bgv client did not decrypt on the device")
    decrypts["bgv_leveled"] = decrypt_check("bgv leveled", client.ctx, client.sk, leveled,
                                            client.ht.batch_slots)
    del leveled
    traced("bgv flat")
    traced("bgv leveled")
    client, server, got = drive("SimpleFHE", SIMPLE_FLAGS)
    if server.ctx.L != 7 or server.pie._pie_chunk() != simple_chunk:
        fail(f"SimpleFHE: L={server.ctx.L}, pie chunk {server.pie._pie_chunk()}")
    if got["ntt_fwd"] <= 0 or got["ntt_inv"] <= 0 or got["decrypt_mask"] <= 0:
        fail(f"SimpleFHE did not launch K1 and the decrypt kernel: {got}")
    if client.decryptor is None:
        fail("the SimpleFHE client did not decrypt on the device")
    # the client's first decrypt chunk of the result, as it decrypts it
    simple = server.pie.run(client.idx_ct).data
    flat = simple.reshape(-1, *simple.shape[-3:])
    chunk = max(1, simple_fhe.DECRYPT_CHUNK_BYTES // (flat[0].numel() * 4))
    decrypts["simple"] = decrypt_check(
        "SimpleFHE chunk", client.ctx, client.sk,
        Ciphertext(flat[:chunk].clone(), client.ctx.default_form, 1),
        client.ht.max_items_per_position)
    del simple, flat
    traced("SimpleFHE", timed=3, n_traced=2, warm=1)
    print(f"[main] kernel launches over all six runs {launches}", flush=True)
    torch.cuda.empty_cache()

    # ---- [goldens]: the reference's golden tests at ring 16384 -----------
    golden_times = goldens_phase(smi_line)

    # ---- [hps]: BFV's HPS kernels at the BFV cells' shapes ---------------
    hps_times = hps_phase(smi_line)

    # ---- [bench]: the port's bench and eval tools at full size -----------
    bench_out = bench_phase_fresh(smi_line)

    # ---- parallel/: the sharded steps, NCCL at world 1, then four ranks ---
    parallel = parallel_phase(runs, smi_line)
    torch.cuda.empty_cache()

    # ---- [multihost]: two processes over TCP, the scaling report's row (c) ---
    multihost = multihost_phase(smi_line)

    # ---- the ElGamal protocols: host-only, no kernel launches -----------
    def kernel_counts():
        return {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
                "pie_ip": pie_kernels.launches, "ntt_mxu_fwd": ntt_mxu.launches["ntt"],
                "ntt_mxu_inv": ntt_mxu.launches["intt"]}

    def reset_all():
        ntt_cuda.reset_launches()
        pie_kernels.reset_launches()
        ntt_mxu.reset_launches()

    elgamal_times = elgamal_phase(cli, run_in_process, reset_all, kernel_counts, smi_line)

    loaded = sorted(m for m in sys.modules if m in ("jax", "nested_hashing_psi_tpu", "cryptography")
                    or m.startswith(("jax.", "nested_hashing_psi_tpu.", "cryptography.")))
    if loaded:
        fail(f"the port loaded jax, the JAX package or cryptography: {loaded[:10]}")

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
              "ntt_q", launches["ntt_fwd"],
              parallel_launches=parallel["launches"]["ntt_fwd"],
              multihost_launches=sum(c["ntt_fwd"] for c in multihost["launches"]),
              bench_wrapper_calls=bench_out["wrapper_calls"]["ntt_fwd"]),
        entry("ntt_inv", f"{csrc}/ntt.cu", "nested_hashing_psi_tpu/ops/ntt_pallas.py:645",
              "intt_q", launches["ntt_inv"],
              parallel_launches=parallel["launches"]["ntt_inv"],
              multihost_launches=sum(c["ntt_inv"] for c in multihost["launches"]),
              bench_wrapper_calls=bench_out["wrapper_calls"]["ntt_inv"]),
        entry("pie_ip", f"{csrc}/pie_ip.cu", "nested_hashing_psi_tpu/ops/pie_kernels.py:48",
              "pie_ip", launches["pie_ip"], parallel_launches=parallel["launches"]["pie_ip"],
              multihost_launches=sum(c["pie_ip"] for c in multihost["launches"]),
              bench_wrapper_calls=bench_out["wrapper_calls"]["pie_ip"],
              p58_max_abs_err=bench_out["bench_pie_online"]["2^24"]["k2_max_abs_err"],
              p58_ms=bench_out["bench_pie_online"]["2^24"]["k2_ms"],
              p58_plain_ms=bench_out["bench_pie_online"]["2^24"]["k2_plain_ms"],
              p58_bound_ms=bench_out["bench_pie_online"]["2^24"]["k2_bound_ms"],
              p58_share=bench_out["bench_pie_online"]["2^24"]["k2_share"],
              **dict(zip(
                  ("l9_max_abs_err", "l9_ms", "l9_plain_ms", "l9_bound_ms", "l9_bound_by"),
                  results["pie_ip_l9"])),
              **{f"{key}_{f}": v for key in ("slice", "position_major", "acc", "multihost_d8",
                                             "multihost_d16")
                 for f, v in zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"),
                                 results[f"pie_ip_{key}"])},
              **{f"l{Ls}_sweep_ms": ms for Ls, ms in k2_sweep.items()},
              **{f"{label.replace(' ', '_').replace(',', '')}_{k}": tr[k]
                 for label, tr in k2_paths.items()
                 for k in ("K2_ms_per_query", "K2_launches_per_query",
                           "plain_ms_per_query", "plain_launches_per_query")}),
        {"name": "decrypt_mask", "route": "cuda", "source": f"{csrc}/decrypt.cu",
         "replaces": None, "launches": launches["decrypt_mask"], "library_ms": None,
         **{f"{form}_{k}" if form != "bfv" else k: v
            for form, d in decrypts.items() for k, v in d.items()}},
        entry("ntt_mxu_fwd", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:323",
              "ntt_mxu_fwd_q", k3_launches["ntt_mxu_fwd"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_fwd_q"][3], int8_products_ms=results["ntt_mxu_fwd_q"][4]),
        entry("ntt_mxu_inv", f"{csrc}/ntt_mxu.cu", "nested_hashing_psi_tpu/ops/ntt_mxu.py:330",
              "ntt_mxu_inv_q", k3_launches["ntt_mxu_inv"], launches_from=k3_note,
              k1_ms=results["ntt_mxu_inv_q"][3], int8_products_ms=results["ntt_mxu_inv_q"][4]),
    ]
    vpu_run, vpu_sum = probe_runs["vpu"]["mixes"], probe_runs["vpu"]["summed"]
    # the 11 K = 64 launches: device time from a CUDA graph of chained calls,
    # the wrapper's pace beside it, against the sum of each launch's own bound
    # (bench_vpu_ops.summed_bound_ms; each mix's operations: its busier
    # pipe's issue slots, bench_vpu_ops.ops_per_app)
    vpu_extra = {}
    for m, r in vpu_run.items():
        vpu_extra.update({
            f"{m}_k64_ms": r["ms"], f"{m}_k64_wrapper_ms": r["wrapper_ms"],
            f"{m}_k64_bound_ms": r["k_bound_ms"], f"{m}_k64_share": r["share"],
            f"{m}_rate_k": r["rate_k"], f"{m}_rate_ms": r["rate_ms"],
            f"{m}_rate_wrapper_ms": r["rate_wrapper_ms"], f"{m}_rate_bound_ms": r["bound_ms"],
            f"{m}_rate_bound_by": r["bound_by"], f"{m}_rate_share": r["rate_share"],
            f"{m}_sass_fma_per_app": vpu_sass[m]["fma"],
            f"{m}_sass_fma_slots_per_app": vpu_sass[m]["fma_slots"],
            f"{m}_sass_alu_per_app": vpu_sass[m]["alu"],
            f"{m}_T_instructions_s": r["apps_per_s"] * vpu_sass[m]["arith"] / 1e12,
            f"{m}_registers": vpu_regs[m]})
    print("[a1_bound] per mix, bound by pipe / device time = share: K = 64 at (64,128,128); "
          "K = 2^15: " + "; ".join(
              f"{m} {r['share']:.3f}, {r['rate_share']:.3f}" for m, r in vpu_run.items())
          + f"; the 11 K = 64 launches summed: bound {vpu_sum['bound_ms']:.4f} ms (each "
          f"launch's own) / device {vpu_sum['ms']:.4f} ms = {vpu_sum['share']:.3f}; the "
          f"wrapper's pace {vpu_sum['wrapper_ms']:.4f} ms", flush=True)
    kernels.append({
        "name": "probe_vpu_ops", "route": "cuda", "source": f"{csrc}/probe_vpu_ops.cu",
        "replaces": "benchmarks/bench_vpu_ops.py:101", "launches": probe_launches["probe_vpu_ops"],
        "max_abs_err": max(r["max_abs_err"] for r in vpu_run.values()),
        "ms": vpu_sum["ms"], "wrapper_ms": vpu_sum["wrapper_ms"], "plain_ms": vpu_sum["plain_ms"],
        "bound_ms": vpu_sum["bound_ms"], "bound_by": vpu_sum["bound_by"],
        "share": vpu_sum["share"], "library_ms": None,
        "measured_as": "the 11 mixes at (64, 128, 128), K = 64, one launch each, summed: ms "
                       "the device's time per call from a CUDA graph of chained calls, "
                       "wrapper_ms calls back to back",
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
        # the butterfly variants' bounds by pipe, and every variant's
        # registers and spills at n = 16384
        fields["bound_by_pipe"] = {v: run[v]["bound_by_pipe"] for v in (main_v, *others)
                                   if "bound_by_pipe" in run[v]}
        fields["registers"] = {v: probe_regs[(128, v)] for v in (main_v, *others)}
        return {"name": name, "route": "cuda", "source": f"{csrc}/{source}",
                "replaces": replaces, "launches": probe_launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                "variant": main_v, **fields, "k1_max_abs_err": run["k1_max_abs_err"],
                "k1_ms": run["k1_ms"], "k1_limb_transforms_s": run["k1_transforms_per_s"], **extra}

    kernels.append({"name": "hps", "route": "cuda", "source": f"{csrc}/hps.cu",
                    "replaces": None, "launches": sum(hps_launches.values()),
                    "library_ms": None, **{k: v for k, v in hps_times.items()
                                           if k != "phase_s"}})
    kernels.append(probe_entry("probe_ntt_lazy", "probe_ntt_lazy.cu",
                               "benchmarks/bench_ntt_lazy_probe.py:142", "exact",
                               ("lazy", "lazy_ps"), probe_runs["lazy"]))
    kernels.append(probe_entry("probe_ntt_anatomy", "probe_ntt_anatomy.cu",
                               "benchmarks/bench_ntt_anatomy.py:100", "stages", ("moves",),
                               anat, moves_sass_lds_static=moves_ops.get("LDS", 0),
                               moves_sass_sts_static=moves_ops.get("STS", 0),
                               stages_over_full=anat["stages"]["ms"] / anat["k1_ms"],
                               moves_over_full=anat["moves"]["ms"] / anat["k1_ms"]))
    print(f"[elgamal] times {json.dumps(elgamal_times)}", flush=True)
    print(f"[checkpoint] times {json.dumps(checkpoint_times)}", flush=True)
    print(f"[goldens] times {json.dumps(golden_times)}", flush=True)
    print(f"[hps] phase {hps_times['phase_s']:.2f} s", flush=True)
    print(f"[parallel] times {json.dumps({k: v for k, v in parallel.items() if k != 'launches'})}",
          flush=True)
    print(f"[multihost] times {json.dumps(multihost)}", flush=True)
    print(f"[bench] phase {bench_out['phase_s']:.2f} s, wrapper calls "
          f"{bench_out['wrapper_calls']}",
          flush=True)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
