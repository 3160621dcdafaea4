"""A1: uint32 op-rate probe, the port's counterpart of
``benchmarks/bench_vpu_ops.py`` (``make(name)``'s ``call``, ``pallas_call``
at :102, kernel at :93-99).

The function: c = x + 12345 and p = 2^31 - 2^20 + 1 per element of a
uint32 array, then x <- f(x, c, p) applied K times (K = 64 in the JAX
probe), for one of the eleven op mixes of ``MIXES``. Every mix wraps mod
2^32 and compares unsigned; ``fmul`` multiplies the float32 views of x and
c with subnormal inputs and results flushed to signed zero, as the JAX
package computes it (XLA flushes them on the CPU and on the TPU), and its
NaNs compare as one class (the payload is the platform's).

``vpu_ops`` launches the CUDA kernel (csrc/probe_vpu_ops.cu) on a CUDA
tensor and takes ``vpu_ops_plain`` on a CPU tensor only; ``launches``
counts wrapper calls that launch the kernel (a CUDA graph's capture counts
each call once, its replays not). ``main`` runs every mix at the JAX
probe's shape, (64, 128, 128) with K = 64, against the plain version, then
reads each mix at K = 64 and at RATE_K = 2^15 on the card: the device's
time per call from replays of a CUDA graph of calls that each take the
last one's output (``timing.graph_ms`` over ``timing.chain``, as the JAX
probe's ``_rate`` chains y = fn(y)), and beside it the wrapper's pace, the
same call issued back to back (``timing.time_ms``). The shares of the
bound by pipe come from the device time; the 11 launches at K = 64 are
summed against the sum of each launch's own bound (``summed_bound_ms``).

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_vpu_ops [--device cpu] [--shape B M N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.benchmarks import card, common, timing, u32
from nested_hashing_psi_tpu_torch.ops import cuda_lib

MIXES = ("add", "mul", "addmul", "where_ge", "mulhi", "shoup", "shoup_lazy", "mont",
         "addmod", "fmul", "mul4_ilp")
P = (1 << 31) - 2**20 + 1
C_OFFSET = 12345
SHAPE = (64, 128, 128)
K = 64
RATE_K = 1 << 15
# applications per element per pass of the kernel's unrolled inner loop,
# elements per thread and tile (one 16-byte vector), and threads per block
# (csrc/probe_vpu_ops.cu kUnroll, kElems, kThreads): a tile is TILE elements
UNROLL, ELEMS, THREADS = 16, 4, 256
TILE = THREADS * ELEMS
# The fewest SASS arithmetic instructions one application of each mix can
# take when no instruction serves two applications, with one exception: a
# three-input IADD3 takes two applications of ``add`` (x + c + c), which the
# hardware does in full. A mix below its floor had its chain folded by the
# compiler (64 adds into one multiply-add, two multiplies by c into one by
# c^2). ``shoup`` is IMAD.WIDE (w == wq == c: the low and high product in
# one), IMAD and a conditional subtract; ``mont`` a wide product, a low and
# a high multiply, a subtract and a correction; ``mul4_ilp`` four IMADs and
# two three-input LOP3s.
MIN_ARITH = {"add": 0.5, "mul": 1, "addmul": 1, "where_ge": 1, "mulhi": 1, "shoup": 3,
             "shoup_lazy": 2, "mont": 5, "addmod": 2, "fmul": 1, "mul4_ilp": 6}
FLT_MIN = 2.0**-126

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _ftz(f: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values -> zero of the same sign."""
    return torch.where((f.abs() < FLT_MIN) & (f != 0), f * 0.0, f)


def _fmul(x, c):
    xf = _ftz(u32.to_bits(x).view(torch.float32))
    cf = _ftz(u32.to_bits(c).view(torch.float32))
    return u32.from_bits(_ftz(xf * cf).view(torch.int32))


def _apply(name: str, x, c):
    if name == "add":
        return u32.add(x, c)
    if name == "mul":
        return u32.mullo(x, c)
    if name == "addmul":
        return u32.add(u32.mullo(x, c), c)
    if name == "where_ge":
        return u32.csub(x, P)
    if name == "mulhi":
        return u32.mulhi(x, c)
    if name == "shoup":
        return u32.shoup_mul(x, c, c, P)
    if name == "shoup_lazy":
        return u32.shoup_lazy(x, c, c, P)
    if name == "mont":
        return u32.mont_mul(x, c, P, c | 1)
    if name == "addmod":
        return u32.add_mod(x, c, P)
    if name == "fmul":
        return _fmul(x, c)
    if name == "mul4_ilp":
        out = u32.mullo(x, c)
        for d in (1, 2, 3):
            out = out ^ u32.mullo(x, u32.add(c, d))
        return out
    raise ValueError(f"unknown mix {name}")


def vpu_ops_plain(x: torch.Tensor, name: str, k: int = K) -> torch.Tensor:
    """Plain PyTorch version: int32 bit views in and out."""
    v = u32.from_bits(x)
    c = u32.add(v, C_OFFSET)
    for _ in range(k):
        v = _apply(name, v, c)
    return u32.to_bits(v)


def vpu_ops(x: torch.Tensor, name: str, k: int = K) -> torch.Tensor:
    """K applications of mix ``name`` to the uint32 bits of int32 ``x``."""
    global launches
    if x.dtype != torch.int32:
        raise TypeError(f"x must be int32 bit views of uint32, got {x.dtype}")
    if name not in MIXES:
        raise ValueError(f"unknown mix {name}; the mixes are {MIXES}")
    if k < 0 or x.numel() >= 1 << 31:
        raise ValueError(f"k = {k} and {x.numel()} elements: need k >= 0, < 2^31 elements")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no probe for device {x.device}")
        return vpu_ops_plain(x, name, k)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies 16-byte vectors
        x = x.clone()
    y = torch.empty_like(x)
    rc = cuda_lib.get_lib().nhpsi_probe_vpu_ops(
        x.data_ptr(), y.data_ptr(), x.numel(), MIXES.index(name), k,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, f"vpu_ops {name}")
    launches += 1
    return y


def same(got: torch.Tensor, want: torch.Tensor, name: str) -> int:
    """Elements that differ, under the stated rule: bit-exact, except that
    fmul's NaNs compare as one class."""
    diff = got != want
    if name == "fmul":
        diff &= ~(got.view(torch.float32).isnan() & want.view(torch.float32).isnan())
    return int(diff.sum().item())


def chain_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The kernel's chain pass: the largest loop, then the largest loop
    inside it, down to one that holds none (the tile loop holds the pass
    loop and the shorter loop over the rest of K)."""
    body = common.loop_body(instrs)
    while True:
        try:
            body = common.loop_body(body)
        except RuntimeError:  # no loop inside
            return body


def sass_per_application(name: str) -> dict:
    """SASS instructions per application of one mix, from the chain pass
    of its kernel (UNROLL applications to each of ELEMS elements)."""
    body = chain_loop(common.find_function(f"vpu_ops_kernelILi{MIXES.index(name)}E"))
    return common.by_pipe(body, UNROLL * ELEMS)


# one 64-lane pipe of every SM: 64 x 132 SMs x 1.98 GHz = 16.7 T lanes/s
PIPE_OPS_S = 64 * 132 * 1.98e9


def ops_per_app(sass: dict) -> float:
    """Issue slots of one application on its busier pipe: the FMA pipe's
    slots (a wide product two, an FP32 instruction half) or the ALU pipe's
    instructions, each pipe 64 lanes per clock per SM. A mix balanced over
    both pipes reaches 128 lanes per clock; a one-pipe mix 64."""
    return max(sass["fma_slots"], sass["alu"])


def bound_ms(elems: int, k: int, sass: dict) -> tuple[float, str]:
    """The larger of the bytes (x read, the result written, 4 bytes each at
    3.35 TB/s) and the busier pipe's issue slots (``ops_per_app``) at
    PIPE_OPS_S."""
    t_bytes = 2 * 4 * elems / 3.35e12 * 1e3
    t_ops = elems * k * ops_per_app(sass) / PIPE_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def summed_bound_ms(sass_by_mix: dict, elems: int, k: int) -> tuple[float, str]:
    """The least time of one launch of each mix, summed: each launch is
    bound by its own larger term (``bound_ms``), so the sum is the sum of
    those, not the larger of the summed bytes and the summed operations.
    Named by the term that bounds the launches that make up most of it."""
    parts = [bound_ms(elems, k, s) for s in sass_by_mix.values()]
    ops = sum(t for t, by in parts if by == "operations")
    total = sum(t for t, _ in parts)
    return total, "operations" if ops >= total - ops else "bytes"


def run(device: str = "cuda", shape=SHAPE, mixes=MIXES, iters: int = 5) -> dict:
    """Every mix: the kernel (or, on the CPU, the plain version) at K
    against the plain version, then read at K and at RATE_K. Returns
    {"mixes": {name: r}, "summed": the K launches of every mix summed};
    raises if any mix disagrees.

    r: mismatches, max_abs_err, ms (the device's time per call at K: a CUDA
    graph of chained calls), wrapper_ms (calls back to back, the wrapper's
    pace), plain_ms, share (k_bound_ms / ms); on the card also rate_k,
    rate_ms and rate_wrapper_ms (the same two readings at RATE_K), sass,
    bound_ms and bound_by (at RATE_K), rate_share; apps_per_s. On the CPU
    every time is the host's clock around the plain version and no bound
    or share exists (no SASS): they are None."""
    dev = common.resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 1 << 31, size=shape, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    elems, out = x.numel(), {}
    for name in mixes:
        bad = same(vpu_ops(x, name), vpu_ops_plain(x, name), name)
        if bad:
            raise RuntimeError(f"vpu_ops {name}: {bad} of {elems} elements differ from the "
                               "plain version")

        def read(k):  # (device ms from a graph of chained calls, the wrapper's pace)
            return (timing.graph_ms(timing.chain(lambda v: vpu_ops(v, name, k), x), dev),
                    timing.time_ms(lambda: vpu_ops(x, name, k), dev, iters))
        # no element differs under the rule, so the largest difference is 0
        r = {"mismatches": bad, "max_abs_err": 0,
             "plain_ms": timing.time_ms(lambda: vpu_ops_plain(x, name), dev, 1),
             "k_bound_ms": None, "share": None}
        r["ms"], r["wrapper_ms"] = read(K)
        if dev.type == "cuda":
            r["rate_k"] = RATE_K
            r["rate_ms"], r["rate_wrapper_ms"] = read(RATE_K)
            r["sass"] = sass_per_application(name)
            r["bound_ms"], r["bound_by"] = bound_ms(elems, RATE_K, r["sass"])
            r["k_bound_ms"] = bound_ms(elems, K, r["sass"])[0]
            r["share"] = r["k_bound_ms"] / r["ms"]
            r["rate_share"] = r["bound_ms"] / r["rate_ms"]
            r["apps_per_s"] = elems * RATE_K / (r["rate_ms"] * 1e-3)
        else:
            r["apps_per_s"] = elems * K / (r["ms"] * 1e-3)
        out[name] = r
    summed = {key: sum(r[key] for r in out.values()) for key in ("ms", "wrapper_ms", "plain_ms")}
    summed.update(bound_ms=None, bound_by=None, share=None)
    if dev.type == "cuda":
        summed["bound_ms"], summed["bound_by"] = summed_bound_ms(
            {m: r["sass"] for m, r in out.items()}, elems, K)
        summed["share"] = summed["bound_ms"] / summed["ms"]
    return {"mixes": out, "summed": summed}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=3, default=list(SHAPE))
    ap.add_argument("--mixes", nargs="*", default=list(MIXES))
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    res = run(a.device, tuple(a.shape), a.mixes, a.iters)
    where = (f"cuda: {card.card_line()}" if a.device != "cpu"
             else "cpu: the plain PyTorch version (no device rate)")
    print(f"[vpu_ops] {where}; shape {tuple(a.shape)}, K = {K} equal to the plain version",
          flush=True)
    for name, r in res["mixes"].items():
        line = (f"[vpu_ops] {name:>10}: {r['apps_per_s'] / 1e9:10.3f} G applications/s")
        if "sass" in r:
            s = r["sass"]
            line += (f" at K = {r['rate_k']} (device {r['rate_ms']:.4f} ms, wrapper "
                     f"{r['rate_wrapper_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']}, share {r['rate_share']:.3f}); SASS per application: "
                     f"FMA pipe {s['fma']:.2f} ({s['fma_slots']:.2f} slots), ALU {s['alu']:.2f} "
                     f"-> {r['apps_per_s'] * s['arith'] / 1e12:.2f} T instructions/s; K = {K}: "
                     f"device {r['ms']:.4f} ms, wrapper {r['wrapper_ms']:.4f} ms (bound "
                     f"{r['k_bound_ms']:.4f} ms, share {r['share']:.3f}), plain "
                     f"{r['plain_ms']:.4f} ms; opcodes per application: " + ", ".join(
                         f"{op} {v:.2f}" for op, v in s["opcodes"].items() if v >= 0.05))
        else:
            line += f" (K = {K}, {r['ms']:.3f} ms)"
        print(line, flush=True)
    sm = res["summed"]
    if sm["share"] is None:
        print(f"[vpu_ops] the {len(res['mixes'])} mixes at K = {K} summed: {sm['ms']:.4f} ms "
              "(host clock, the plain version)", flush=True)
    else:
        print(f"[vpu_ops] the {len(res['mixes'])} launches at K = {K} summed: device "
              f"{sm['ms']:.4f} ms, wrapper {sm['wrapper_ms']:.4f} ms; bound {sm['bound_ms']:.4f} "
              f"ms by {sm['bound_by']} (each launch's own), share {sm['share']:.3f}", flush=True)
    return res


if __name__ == "__main__":
    main()
