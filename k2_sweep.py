#!/usr/bin/env python3
"""K2 (the position sum) on the card, beside an earlier tree's K2.

    python3 k2_sweep.py [--parent DIR] [--paths]

Builds, each into a library of its own under build/k2_sweep/ (ignored by
git), with the flags of ops/cuda_lib.py and the register report of
``-Xptxas -v``:

- ``K2``: the port's kernel, nested_hashing_psi_tpu_torch/csrc/pie_ip.cu;
- ``K2_loads``: a copy of it whose products and reductions are XORs (the
  same loads and stores, almost no arithmetic);
- with ``--parent DIR`` (a checkout of an earlier tree, e.g. from
  ``git archive``): ``parent``, that tree's csrc/pie_ip.cu, and
  ``parent_loads``, a copy of it whose Montgomery products and adds are
  XORs.

Then times each at (H, D, P, L, N) = (2, 12, 12, L, 16384) for L = 6..10 and
over table positions [3, 6) of P = 12 at L = 6 (in place), and the port's
two kernels also over the position-major (12, 2, 12, 6, 16384) table and
with a running sum (acc, in place). Each time is a mean over launches: cold
(a 256 MB read fills the 50 MB L2 with other lines before each launch,
outside the CUDA events around the launch: what the protocol path finds) and back to back (as
chip_smoke.py times K2); the variants take turns, in one order and then in
the reverse one. Each line gives the byte bound (chip_smoke.k2_bound) and
the share of it. Every variant but the load-only ones is held bit-exact
against indexed_inner_product_plain on the card; a mismatch fails the run.
Writes everything to build/k2_sweep/k2_sweep.json as well.

Then, in a process of its own for each tree, importing that tree's package
(the parent, this tree, this tree again, the parent, when ``--parent`` is
given): the [3, 6) slice and the whole table at L = 6 through the tree's
wrapper ``indexed_inner_product``, back to back (the streamed path's calls),
with the host's time per call; and with ``--paths``, on each tree's first
turn, one 2^20 x 2048 BFV query through the user entry points, then the
streamed query (4 chunks) and the host-resident table's query (4 slices)
traced as chip_smoke.py traces them (chip_smoke.k2_path_queries): K2's and
the plain PyTorch kernels' milliseconds and counts per query. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "k2_sweep")
CSRC = os.path.join(ROOT, "nested_hashing_psi_tpu_torch", "csrc")
N, H, D, P = 16384, 2, 12, 12

# (text of the parent's source, its load-only replacement)
PARENT_LOADS = [(
    "using nhpsi::add_mod;\nusing nhpsi::mont_mul;",
    "__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t) {\n"
    "  return a ^ b;\n}\n"
    "__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t,\n"
    "                                             uint32_t) {\n  return a ^ b;\n}",
)]
# the same for the port's kernel: a group's products and each output's
# reduction become XORs
K2_LOADS = [
    ("  g[0] += static_cast<uint64_t>(a.x) * b.x;\n"
     "  g[1] += static_cast<uint64_t>(a.y) * b.y;\n"
     "  g[2] += static_cast<uint64_t>(a.z) * b.z;\n"
     "  g[3] += static_cast<uint64_t>(a.w) * b.w;",
     "  g[0] ^= a.x ^ b.x;\n  g[1] ^= a.y ^ b.y;\n  g[2] ^= a.z ^ b.z;\n  g[3] ^= a.w ^ b.w;"),
    ("  const uint32_t u = redc((static_cast<uint64_t>(s.w2) << 32) | s.w1, q, qinv);\n"
     "  return redc(static_cast<uint64_t>(u) * r2 + s.w0, q, qinv);",
     "  return s.w0 ^ s.w1 ^ s.w2 ^ q ^ qinv ^ r2;"),
]

# one tree's wrapper over the [3, 6) slice and the whole table at L = 6,
# and with --paths its streamed and host-table queries, traced (argv: tree
# root, the path of this tree's chip_smoke.py, "paths" or "wrapper")
TREE = """
import importlib.util, sys, time
root, smoke, mode = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("k2_chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import numpy as np
import torch
from nested_hashing_psi_tpu_torch.ops import cuda_lib, pie_kernels
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
H, D, P, L, N = 2, 12, 12, 6, 16384
q = ntt_primes(L, 31, 2 * N)
tb = NTTPlan(N, q).tensors(torch.device("cuda"))
rng = np.random.default_rng(0)
mods = np.array(q, np.int64).reshape(L, 1)
res = lambda shape: torch.from_numpy(
    (rng.integers(0, 1 << 62, size=shape) % mods).astype(np.int32)).cuda()
pt, idx = res((H, D, P, L, N)), res((H, P, 2, L, N))


def host_us(fn, n=200):  # the host's time per call of fn(), launches queued
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


fn, stream = cuda_lib.get_lib().nhpsi_pie_ip, torch.cuda.current_stream().cuda_stream
out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device="cuda")
for label, ii, p0 in (("slice [3,6)", idx[:, 3:6].contiguous(), 3), ("whole table", idx, None)):
    call = lambda: pie_kernels.indexed_inner_product(ii, pt, tb["p_u32"], tb["pinv_u32"], p0)
    ms = [cs.time_ms(call, "cuda", 200) for _ in range(5)]
    wrapper = [host_us(call) for _ in range(3)]
    # the C entry alone, with its arguments made once (the parent's
    # signature has 13, this tree's 17)
    s = 0 if p0 is None else p0
    view = pt[:, :, s : s + ii.shape[1]]
    args = ((ii.data_ptr(), pt.data_ptr(), out.data_ptr(), tb["p_u32"].data_ptr(),
             tb["pinv_u32"].data_ptr(), H, D, ii.shape[1], L, N, s, P, stream)
            if len(fn.argtypes) == 13 else
            (ii.data_ptr(), view.data_ptr(), None, out.data_ptr(), tb["p_u32"].data_ptr(),
             tb["pinv_u32"].data_ptr(), H, D, ii.shape[1], L, N, ii.stride(0),
             *view.stride()[:4], stream))
    entry = [host_us(lambda: fn(*args)) for _ in range(3)]
    empty = host_us(lambda: torch.empty((H, D, 2, L, N), dtype=torch.int32, device="cuda"))
    cur = host_us(lambda: torch.cuda.current_stream(idx.device).cuda_stream)
    print(f"[k2_wrapper {root}] {label}: through the wrapper, back to back, "
          f"{sum(ms) / len(ms):.4f} ms ({', '.join(f'{m:.4f}' for m in ms)}); host us per "
          f"call: wrapper {min(wrapper):.1f} ({', '.join(f'{u:.1f}' for u in wrapper)}), C "
          f"entry alone {min(entry):.1f} ({', '.join(f'{u:.1f}' for u in entry)}), "
          f"torch.empty of the output {empty:.1f}, torch.cuda.current_stream {cur:.1f}",
          flush=True)
del pt, idx, out
torch.cuda.empty_cache()
if mode == "paths":
    from nested_hashing_psi_tpu_torch import cli
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process
    psi, ht, device = cli.parse_args(cs.MAIN_FLAGS)
    client, server, ok = run_in_process(psi, ht, device=device)
    assert ok and len(client.intersection_calculated) == cs.EXPECTED_FOUND
    host = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=cs.MASK_SEED,
                         host_table=True)
    cs.print_k2_paths(cs.k2_path_queries(server.pie, host, client.idx_ct, client.minus_ct),
                      tag="k2_paths " + root)
"""


def patched(name: str, patches, src: str) -> str:
    """Copies `src` to build/k2_sweep/<name>/ with each (text, replacement)
    applied, and returns the copy's path."""
    text = open(src).read()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"k2_sweep: {name}: {src} lacks the text it replaces")
        text = text.replace(old, new)
    out = os.path.join(OUT_DIR, name, os.path.basename(src))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(text)
    return out


def build(variants: dict) -> dict:
    """{name: (source, include dir)} -> {name: loaded library}; prints the
    register report of each."""
    from nested_hashing_psi_tpu_torch.ops import cuda_lib

    nvcc = cuda_lib.find_nvcc()
    libs = {name: os.path.join(OUT_DIR, f"lib{name}.so") for name in variants}
    out = cuda_lib._run_all([
        [nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", inc, "-o", libs[name], src]
        for name, (src, inc) in variants.items()])
    for line in out.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fn = lib.nhpsi_pie_ip
        fn.restype = ctypes.c_int
        V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([V] * 5 + [I] * 7 + [V]) if name.startswith("parent") \
            else ([V] * 6 + [I] * 5 + [LL] * 5 + [V])
        loaded[name] = fn
    return loaded


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of an earlier tree whose K2 to time beside this one")
    ap.add_argument("--paths", action="store_true",
                    help="also trace the streamed and host-table queries of each tree")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from nested_hashing_psi_tpu_torch.benchmarks.timing import time_ms
    from nested_hashing_psi_tpu_torch.ops import pie_kernels
    from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
    from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

    if not torch.cuda.is_available():
        raise SystemExit("k2_sweep: needs a GPU")
    os.makedirs(OUT_DIR, exist_ok=True)
    k2 = os.path.join(CSRC, "pie_ip.cu")
    variants = {"K2": (k2, CSRC), "K2_loads": (patched("K2_loads", K2_LOADS, k2), CSRC)}
    if args.parent:
        psrc = os.path.join(args.parent, "nested_hashing_psi_tpu_torch", "csrc")
        variants["parent"] = (os.path.join(psrc, "pie_ip.cu"), psrc)
        variants["parent_loads"] = (
            patched("parent_loads", PARENT_LOADS, os.path.join(psrc, "pie_ip.cu")), psrc)
    fns = build(variants)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2

    def residues(shape, ps):
        p = np.array(ps, np.int64).reshape(len(ps), 1)
        return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32)).to(dev)

    def launcher(name, case):
        fn, c = fns[name], case
        tb = c["tb"]
        Hc, Pc, _, Lc, Nc = c["idx"].shape
        if name.startswith("parent"):
            full = c["pt"]
            return lambda: fn(c["idx"].data_ptr(), full.data_ptr(), c["out"].data_ptr(),
                              tb["p_u32"].data_ptr(), tb["pinv_u32"].data_ptr(), Hc, D, Pc, Lc,
                              Nc, c["p0"], full.shape[2], stream)
        view, acc = c["view"], c.get("acc")
        out = c["out"] if acc is None else acc
        return lambda: fn(c["idx"].data_ptr(), view.data_ptr(),
                          None if acc is None else acc.data_ptr(), out.data_ptr(),
                          tb["p_u32"].data_ptr(), tb["pinv_u32"].data_ptr(), Hc, D, Pc, Lc, Nc,
                          c["idx"].stride(0), *view.stride()[:4], stream)

    def cold_ms(fn, iters=10):
        fn()  # the first launch from a library loads its module
        total = 0.0
        for _ in range(iters):
            flush.max()  # reads: leaves the L2 full of clean lines, nothing to write back
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn()
            b.record()
            if rc:
                raise SystemExit(f"k2_sweep: launch failed, cudaError {rc}")
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    results = []
    # bring the card to its working clocks first
    warm_q = ntt_primes(6, 31, 2 * N)
    warm = {"idx": residues((H, P, 2, 6, N), warm_q), "pt": residues((H, D, P, 6, N), warm_q),
            "tb": NTTPlan(N, warm_q).tensors(dev), "p0": 0}
    warm.update(view=warm["pt"], out=torch.empty((H, D, 2, 6, N), dtype=torch.int32, device=dev))
    time_ms(launcher("K2", warm), dev, 500)
    del warm
    cases = [(f"L = {L}", L, "full") for L in range(6, 11)] + [
        ("slice [3,6) of P = 12, L = 6", 6, "slice"),
        ("position-major (12,2,12,6,16384)", 6, "position-major"),
        ("acc, in place, L = 6", 6, "acc")]
    for label, L, kind in cases:
        q = ntt_primes(L, 31, 2 * N)
        tb = NTTPlan(N, q).tensors(dev)
        case = {"tb": tb, "p0": 0}
        if kind == "position-major":
            pm = residues((P, H, D, L, N), q)
            case.update(idx=residues((H, P, 2, L, N), q), pt=None, view=pm.permute(1, 2, 0, 3, 4))
            names = [n for n in fns if not n.startswith("parent")]
            want = pie_kernels.indexed_inner_product_plain(
                case["idx"], case["view"], tb["p"], tb["pinv"])
        else:
            full = residues((H, D, P, L, N), q)
            w, p0 = (3, 3) if kind == "slice" else (P, 0)
            case.update(idx=residues((H, w, 2, L, N), q), pt=full, p0=p0,
                        view=full[:, :, p0:p0 + w])
            names = [n for n in fns if kind != "acc" or not n.startswith("parent")]
            want = pie_kernels.indexed_inner_product_plain(
                case["idx"], full, tb["p"], tb["pinv"], p0 if kind == "slice" else None)
        case["out"] = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=dev)
        Pc = case["idx"].shape[1]
        b_ms, b_by = chip_smoke.k2_bound(H, D, Pc, L, N)
        if kind == "acc":
            acc0 = residues((H, D, 2, L, N), q)
            want = pie_kernels.indexed_inner_product_plain(
                case["idx"], case["pt"], tb["p"], tb["pinv"], acc=acc0)
            b_ms, b_by = chip_smoke.k2_bound(H, D, Pc, L, N, acc=True)
        errs = {}
        for name in names:
            if name.endswith("_loads"):
                continue
            if kind == "acc":
                case["acc"] = acc0.clone()
            case["out"].fill_(-1)
            rc = launcher(name, case)()
            got = case["acc"] if kind == "acc" else case["out"]
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"k2_sweep: {name} at {label}: launch failed, cudaError {rc}")
            errs[name] = int((got.long() - want.long()).abs().max().item())
        times = {n: {"cold": [], "warm": []} for n in names}
        for order in (names, names[::-1]):
            for name in order:
                fn = launcher(name, case)
                times[name]["cold"].append(cold_ms(fn))
                times[name]["warm"].append(time_ms(fn, dev, 20))
        for name in names:
            cold = sum(times[name]["cold"]) / 2
            warm_ms = sum(times[name]["warm"]) / 2
            err = errs.get(name, "n/a (load-only)")
            print(f"[k2_sweep] {label}: {name}: cold {cold:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times[name]['cold'])}), back to back "
                  f"{warm_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), share {b_ms / cold:.3f} cold, "
                  f"{b_ms / warm_ms:.3f} back to back; max_abs_err {err}", flush=True)
            results.append({"case": label, "variant": name, "cold_ms": cold,
                            "cold_ms_rounds": times[name]["cold"], "warm_ms": warm_ms,
                            "warm_ms_rounds": times[name]["warm"], "bound_ms": b_ms,
                            "bound_by": b_by, "max_abs_err": errs.get(name)})
        bad = {n: e for n, e in errs.items() if e != 0}
        if bad:
            raise SystemExit(f"k2_sweep: {label}: kernels disagree with the plain version: {bad}")
        del case, want
        torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, "k2_sweep.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "results": results}, f, indent=1)
    del flush
    torch.cuda.empty_cache()
    trees = [args.parent, ROOT, ROOT, args.parent] if args.parent else [ROOT, ROOT]
    for turn, root in enumerate(trees):
        first = root not in trees[:turn]
        subprocess.run([sys.executable, "-c", TREE, os.path.abspath(root),
                        os.path.join(ROOT, "chip_smoke.py"),
                        "paths" if args.paths and first else "wrapper"], check=True)


if __name__ == "__main__":
    main()
