"""A2: lazy-butterfly probe, the port's counterpart of
``benchmarks/bench_ntt_lazy_probe.py`` (``make_variant(plan, which)``'s
``call`` at :142, ``pallas_call`` at :145, kernel at :124-140, the stage
forms at :89-122).

The function, per limb row of x (B, L, n) viewed as (m1, m2) with the
prime of its limb: the log2 m1 stages of the split NTT's first half down
the columns with the plan's ``s1_v2`` tables, a swap of the last two axes,
the log2 m2 stages of the second half with ``s2_v2``, and the swap back.
Stage k pairs rows at distance ``u32.pair_distance``. The tables are the
regrouped ones but the data is not regrouped, so the result is not an NTT.
The butterfly forms: ``exact`` (Shoup product, add_mod / sub_mod),
``lazy`` (u reduced below 2p, outputs u + w and u + 2p - w unreduced,
wrapping mod 2^32: meaningless with 31-bit primes, the JAX probe's own
caveat) and ``lazy_ps`` (lazy with mulhi built from pre-split 16-bit
quotient halves: the same function as lazy).

``lazy_probe`` launches the CUDA kernel (csrc/probe_ntt_lazy.cu) on a CUDA
tensor and takes ``lazy_probe_plain`` on a CPU tensor only; ``launches``
counts kernel launches. ``main`` runs the three forms at the JAX probe's
shape, (512, 6, 16384), against the plain version, with the port's K1
(ops/ntt_cuda.ntt, held against the plain ``ntt``) on the same input as
the reference line, and prints ms, limb-transforms/s and SASS
instructions per butterfly.

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_lazy_probe [--device cpu] [--n N] [--limbs L] [--batch B]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.benchmarks import common, u32
from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan

VARIANTS = ("exact", "lazy", "lazy_ps")
N, LIMBS, BATCH = 1 << 14, 6, 512
KERNEL_M = (32, 64, 128)  # the kernel's tile sides: n = 2^10, 2^12, 2^14

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _ct_lazy(u, v, w, wq, p):
    p2 = p + p
    u = u32.csub(u, p2)
    x = u32.shoup_lazy(v, w, wq, p)
    return u32.add(u, x), u32.sub(u32.add(u, p2), x)


def _ct_lazy_ps(u, v, w, wq, p):
    p2 = p + p
    u = u32.csub(u, p2)
    x = u32.sub(u32.mullo(v, w), u32.mullo(u32.mulhi_presplit(v, wq & u32.M16, wq >> 16), p))
    return u32.add(u, x), u32.sub(u32.add(u, p2), x)


FORMS = {"exact": u32.ct_exact, "lazy": _ct_lazy, "lazy_ps": _ct_lazy_ps}


def _plain_tables(plan: SplitNTTPlan, device):
    tb = plan.tensors(device)
    return (u32.from_bits(tb["s1_v2"])[..., 0], u32.from_bits(tb["s2_v2"])[..., 0],
            u32.from_bits(tb["p"]).reshape(-1, 1, 1, 1))


def lazy_probe_plain(x: torch.Tensor, plan: SplitNTTPlan, which: str) -> torch.Tensor:
    """Plain PyTorch version: int32 (B, L, n) in and out."""
    bf = FORMS[which]
    B, L, n = x.shape
    m1, m2 = plan.m1, plan.m2
    sa, sb, p = _plain_tables(plan, x.device)
    X = u32.from_bits(x).reshape(B, L, m1, m2)
    for k in range(plan.log1):
        X = u32.split_stage(X, sa[:, 0, k], sa[:, 1, k], u32.pair_distance(m1, k), p, bf)
    X = X.transpose(-1, -2)
    for k in range(plan.log2):
        X = u32.split_stage(X, sb[:, 0, k], sb[:, 1, k], u32.pair_distance(m2, k), p, bf)
    return u32.to_bits(X.transpose(-1, -2).reshape(B, L, n))


def check_input(x: torch.Tensor, plan: SplitNTTPlan) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"x must be int32 residues, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (plan.L, plan.n):
        raise ValueError(f"x {tuple(x.shape)} is not (B, {plan.L}, {plan.n})")
    if x.is_cuda and not (plan.m1 == plan.m2 and plan.m1 in KERNEL_M):
        raise ValueError(f"the probe kernels take n = 2^10, 2^12 or 2^14, got {plan.n}")


def lazy_probe(x: torch.Tensor, plan: SplitNTTPlan, which: str) -> torch.Tensor:
    """The probe's function in form ``which`` on x (B, L, n) int32."""
    global launches
    if which not in VARIANTS:
        raise ValueError(f"unknown form {which}; the forms are {VARIANTS}")
    check_input(x, plan)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no probe for device {x.device}")
        return lazy_probe_plain(x, plan, which)
    x = x.contiguous()
    y = torch.empty_like(x)
    tb = plan.tensors(x.device)
    rc = cuda_lib.get_lib().nhpsi_probe_ntt_lazy(
        x.data_ptr(), y.data_ptr(), tb["s1_v2"].data_ptr(), tb["s2_v2"].data_ptr(),
        tb["p"].data_ptr(), x.shape[0], plan.L, plan.m1, VARIANTS.index(which),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, f"lazy_probe {which}")
    launches += 1
    return y


def bound_ms(rows: int, n: int, arith_per_butterfly: float, table_bytes: int) -> tuple[float, str]:
    """The larger of the bytes (each row read and written once, the tables
    once, at 3.35 TB/s) and n/2 log2 n butterflies per row at the given
    arithmetic instructions each, at 33.5 T/s (128 lanes per clock per SM,
    132 SMs, 1.98 GHz)."""
    t_bytes = (rows * n * 8 + table_bytes) / 3.35e12 * 1e3
    ops = rows * (n // 2) * (n.bit_length() - 1) * arith_per_butterfly
    t_ops = ops / (128 * 132 * 1.98e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sass_per_butterfly(kernel: str, plan: SplitNTTPlan, variant: int) -> dict:
    """SASS instructions per butterfly of one kernel's row loop at the
    plan's tile side (a thread runs (log2 m1 + log2 m2) m1 / 2 butterflies
    per row)."""
    body = common.loop_body(common.find_function(f"{kernel}ILi{plan.m1}ELi{variant}E"))
    return common.by_pipe(body, (plan.log1 + plan.log2) * plan.m1 // 2)


def inputs(n: int, limbs: int, batch: int, device):
    """The primes, the split plan and x (batch, limbs, n) of residues, from
    seed 0."""
    ps = ntt_primes(limbs, 31, 2 * n)
    plan = SplitNTTPlan(n, ps)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, min(ps), size=(batch, limbs, n), dtype=np.int64)
                         .astype(np.int32)).to(device)
    return ps, plan, x


def k1_line(x: torch.Tensor, ps, dev, iters: int) -> tuple[int, float]:
    """The port's K1 forward NTT (ops/ntt_cuda.ntt) on the same (B, L, n)
    input: its max_abs_err against the plain ``ops.ntt.ntt`` (raises unless
    0) and its ms."""
    k1 = NTTPlan(x.shape[-1], ps)
    err = int((ntt_cuda.ntt(x, k1).long() - ntt(x, k1).long()).abs().max().item())
    if err:
        raise RuntimeError(f"K1 at {tuple(x.shape)} differs from the plain ntt (max_abs_err {err})")
    return err, common.time_ms(lambda: ntt_cuda.ntt(x, k1), dev, iters)


def run(device: str = "cuda", n: int = N, limbs: int = LIMBS, batch: int = BATCH,
        iters: int = 10) -> dict:
    """Each form against the plain version, timed, with its rate; and K1 on
    the same input. Raises if a form disagrees."""
    dev = common.resolve_device(device)
    ps, plan, x = inputs(n, limbs, batch, dev)
    rows, out = batch * limbs, {}
    table_bytes = plan.s1_v2.nbytes + plan.s2_v2.nbytes
    for name in VARIANTS:
        err = int((lazy_probe(x, plan, name).long() - lazy_probe_plain(x, plan, name).long())
                  .abs().max().item())
        if err:
            raise RuntimeError(f"lazy_probe {name} differs from the plain version (max_abs_err {err})")
        r = {"max_abs_err": err, "ms": common.time_ms(lambda: lazy_probe(x, plan, name), dev, iters),
             "plain_ms": common.time_ms(lambda: lazy_probe_plain(x, plan, name), dev, 1)}
        r["transforms_per_s"] = rows / (r["ms"] * 1e-3)
        if dev.type == "cuda":
            r["sass"] = sass_per_butterfly("ntt_lazy_kernel", plan, VARIANTS.index(name))
            r["bound_ms"], r["bound_by"] = bound_ms(rows, n, r["sass"]["arith"], table_bytes)
        out[name] = r
    out["k1_max_abs_err"], out["k1_ms"] = k1_line(x, ps, dev, iters)
    out["k1_transforms_per_s"] = rows / (out["k1_ms"] * 1e-3)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--limbs", type=int, default=LIMBS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    res = run(a.device, a.n, a.limbs, a.batch, a.iters)
    where = (f"cuda: {common.card_line()}" if a.device != "cpu"
             else "cpu: the plain PyTorch version (no device rate)")
    print(f"[ntt_lazy] {where}; ({a.batch}, {a.limbs}, {a.n}), every form equal to the "
          "plain version", flush=True)
    for name in VARIANTS:
        r = res[name]
        line = (f"[ntt_lazy] {name:>8}: {r['ms']:.4f} ms, {r['transforms_per_s']:,.0f} "
                f"limb-transforms/s")
        if "sass" in r:
            s = r["sass"]
            line += (f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
                     f"{r['bound_ms'] / r['ms']:.3f}; SASS per butterfly: FMA pipe "
                     f"{s['fma']:.2f}, ALU {s['alu']:.2f}, memory {s['memory']:.2f}; plain "
                     f"{r['plain_ms']:.2f} ms")
        print(line, flush=True)
    print(f"[ntt_lazy]       K1: {res['k1_ms']:.4f} ms, {res['k1_transforms_per_s']:,.0f} "
          "limb-transforms/s (ops/ntt_cuda.ntt, forward; equal to the plain ntt)", flush=True)
    return res


if __name__ == "__main__":
    main()
