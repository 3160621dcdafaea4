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
counts kernel launches. ``main`` runs every mix at the JAX probe's shape,
(64, 128, 128) with K = 64 against the plain version, then at a K large
enough that one launch takes about a millisecond, and prints the rates in
applications/s and in SASS instructions/s by pipe.

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
# and elements per thread (csrc/probe_vpu_ops.cu kUnroll, kElems)
UNROLL, ELEMS = 16, 4
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


def sass_per_application(name: str) -> dict:
    """SASS instructions per application of one mix, from the loop body of
    its kernel (UNROLL applications to each of ELEMS elements)."""
    body = common.loop_body(common.find_function(f"vpu_ops_kernelILi{MIXES.index(name)}E"))
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


def run(device: str = "cuda", shape=SHAPE, mixes=MIXES, iters: int = 5) -> dict:
    """Every mix: the kernel (or, on the CPU, the plain version) at K
    against the plain version, then its rate at RATE_K. Returns per mix
    {mismatches, max_abs_err, ms, plain_ms, rate_ms, apps_per_s, sass,
    bound_ms, bound_by}; raises if any mix disagrees."""
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
        # no element differs under the rule, so the largest difference is 0
        r = {"mismatches": bad, "max_abs_err": 0,
             "ms": timing.time_ms(lambda: vpu_ops(x, name), dev, iters),
             "plain_ms": timing.time_ms(lambda: vpu_ops_plain(x, name), dev, 1)}
        if dev.type == "cuda":
            r["rate_ms"] = timing.time_ms(lambda: vpu_ops(x, name, RATE_K), dev, iters)
            r["rate_k"] = RATE_K
            r["sass"] = sass_per_application(name)
            r["bound_ms"], r["bound_by"] = bound_ms(elems, RATE_K, r["sass"])
            r["k_bound_ms"] = bound_ms(elems, K, r["sass"])[0]
            r["apps_per_s"] = elems * RATE_K / (r["rate_ms"] * 1e-3)
        else:
            r["apps_per_s"] = elems * K / (r["ms"] * 1e-3)
        out[name] = r
    return out


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
    for name, r in res.items():
        line = (f"[vpu_ops] {name:>10}: {r['apps_per_s'] / 1e9:10.3f} G applications/s")
        if "sass" in r:
            s = r["sass"]
            line += (f" at K = {r['rate_k']} ({r['rate_ms']:.4f} ms; bound {r['bound_ms']:.4f} "
                     f"ms by {r['bound_by']}, share {r['bound_ms'] / r['rate_ms']:.3f}); SASS "
                     f"per application: FMA pipe {s['fma']:.2f} ({s['fma_slots']:.2f} slots), "
                     f"ALU {s['alu']:.2f} -> {r['apps_per_s'] * s['arith'] / 1e12:.2f} T "
                     f"instructions/s; K = {K}: {r['ms']:.4f} ms (bound {r['k_bound_ms']:.4f} "
                     f"ms, share {r['k_bound_ms'] / r['ms']:.3f}), plain {r['plain_ms']:.4f} ms; "
                     "opcodes per application: " + ", ".join(
                         f"{op} {v:.2f}" for op, v in s["opcodes"].items() if v >= 0.05))
        else:
            line += f" (K = {K}, {r['ms']:.3f} ms)"
        print(line, flush=True)
    return res


if __name__ == "__main__":
    main()
