"""A3: NTT-anatomy probe, the port's counterpart of
``benchmarks/bench_ntt_anatomy.py`` (``make_variant(plan, which)``'s
``call`` at :100, ``pallas_call`` at :103, kernel at :71-98).

Two functions of x (B, L, n), each limb row viewed as (m, m) (even log2 n:
the second half's tables run along the first axis), with the prime of its
limb:
  ``stages``: the log2 m Cooley-Tukey stages of the split NTT's first half
      with the plan's ``s1_v2`` tables, then log2 m Gentleman-Sande stages
      with ``s2_v2``, all down the columns (``ct_stage`` / ``gs_stage`` of
      the JAX package's ops/ntt_pallas.py; their roll form below pair
      distance 8 is the same function as the split form): K1's butterflies
      without its data movement;
  ``moves``: a regroup and its undoing, the Shoup product by ``tw``, a swap
      of the last two axes, a regroup and its undoing, and the swap back:
      K1's data movement without its butterflies, as a function only the
      Shoup product.
The JAX probe's third line, ``full``, is K1 itself (ops/ntt_cuda.ntt).

``anatomy_probe`` launches the CUDA kernel (csrc/probe_ntt_anatomy.cu) on a
CUDA tensor and takes ``anatomy_probe_plain`` on a CPU tensor only;
``launches`` counts kernel launches. ``main`` runs both at the JAX probe's
shape, (512, 6, 16384), against the plain version, then K1 on the same
input (held against the plain ``ntt``), and prints ms, limb-transforms/s
and each one's share of ``full``. The ``stages`` kernel holds one class
of residues per thread (``u32.class_stride``), as A2's does.

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_anatomy [--device cpu] [--n N] [--limbs L] [--batch B]
"""

from __future__ import annotations

import argparse

import torch

from nested_hashing_psi_tpu_torch.benchmarks import card, common, timing, u32
from nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_lazy_probe import (
    BATCH,
    LIMBS,
    N,
    bound_by_pipe,
    bound_ms,
    check_input,
    inputs,
    k1_line,
    sass_per_butterfly,
)
from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

VARIANTS = ("stages", "moves")
# The fewest FMA-pipe plus ALU instructions of one stages butterfly (a
# Cooley-Tukey or a Gentleman-Sande one: each a Shoup product, its
# conditional subtract, an add_mod and a sub_mod;
# bench_ntt_lazy_probe.MIN_ARITH's exact).
MIN_ARITH = {"stages": 8}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _regroup(X):
    """Rows (..., M, W): blk*8 + off -> off*(M/8) + blk."""
    *lead, M, W = X.shape
    return X.reshape(*lead, M // 8, 8, W).transpose(-3, -2).reshape(*lead, M, W)


def _ungroup(X):
    *lead, M, W = X.shape
    return X.reshape(*lead, 8, M // 8, W).transpose(-3, -2).reshape(*lead, M, W)


def anatomy_probe_plain(x: torch.Tensor, plan: SplitNTTPlan, which: str) -> torch.Tensor:
    """Plain PyTorch version: int32 (B, L, n) in and out."""
    if plan.m1 != plan.m2:
        raise ValueError(f"the anatomy probe needs m1 == m2 (even log2 n), got n = {plan.n}")
    B, L, n = x.shape
    m = plan.m1
    tb = plan.tensors(x.device)
    p = u32.from_bits(tb["p"]).reshape(-1, 1, 1, 1)
    X = u32.from_bits(x).reshape(B, L, m, m)
    if which == "stages":
        sa = u32.from_bits(tb["s1_v2"])[..., 0]
        sb = u32.from_bits(tb["s2_v2"])[..., 0]
        for k in range(plan.log1):
            X = u32.split_stage(X, sa[:, 0, k], sa[:, 1, k], u32.pair_distance(m, k), p,
                                u32.ct_exact)
        for k in range(plan.log2):
            X = u32.split_stage(X, sb[:, 0, k], sb[:, 1, k], u32.pair_distance(m, k), p,
                                u32.gs_exact)
    elif which == "moves":
        tw = u32.from_bits(tb["tw"])
        X = _ungroup(_regroup(X))
        X = u32.shoup_mul(X, tw[:, 0], tw[:, 1], p.reshape(-1, 1, 1))
        X = _ungroup(_regroup(X.transpose(-1, -2))).transpose(-1, -2)
    else:
        raise ValueError(f"unknown variant {which}; the variants are {VARIANTS}")
    return u32.to_bits(X.reshape(B, L, n))


def anatomy_probe(x: torch.Tensor, plan: SplitNTTPlan, which: str) -> torch.Tensor:
    """The probe's function ``which`` on x (B, L, n) int32."""
    global launches
    if which not in VARIANTS:
        raise ValueError(f"unknown variant {which}; the variants are {VARIANTS}")
    check_input(x, plan)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no probe for device {x.device}")
        return anatomy_probe_plain(x, plan, which)
    x = x.contiguous()
    y = torch.empty_like(x)
    tb = plan.tensors(x.device)
    rc = cuda_lib.get_lib().nhpsi_probe_ntt_anatomy(
        x.data_ptr(), y.data_ptr(), tb["s1_v2"].data_ptr(), tb["s2_v2"].data_ptr(),
        tb["tw"].data_ptr(), tb["p"].data_ptr(), x.shape[0], plan.L, plan.m1,
        VARIANTS.index(which), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, f"anatomy_probe {which}")
    launches += 1
    return y


def kernel_name(m: int, which: str) -> str:
    """A fragment of the mangled name of variant ``which``'s kernel at tile side m."""
    return f"anatomy_{which}_kernelILi{m}E"


def moves_sass(plan: SplitNTTPlan) -> dict:
    """Static SASS instruction counts of the moves kernel's row loop (its
    global-memory loops are unrolled 16 times, so these are not counts per
    element); test_anatomy_moves_go_through_shared_memory checks that it
    has LDS and STS."""
    body = common.loop_body(common.find_function(kernel_name(plan.m1, "moves")))
    return common.by_pipe(body, 1)


def run(device: str = "cuda", n: int = N, limbs: int = LIMBS, batch: int = BATCH,
        iters: int = 10) -> dict:
    """Each variant against the plain version, timed, beside K1 on the same
    input. Raises if a variant disagrees."""
    dev = resolve_device(device)
    ps, plan, x = inputs(n, limbs, batch, dev)
    rows, out = batch * limbs, {}
    for name in VARIANTS:
        err = int((anatomy_probe(x, plan, name).long()
                   - anatomy_probe_plain(x, plan, name).long()).abs().max().item())
        if err:
            raise RuntimeError(f"anatomy_probe {name} differs from the plain version "
                               f"(max_abs_err {err})")
        r = {"max_abs_err": err,
             "ms": timing.time_ms(lambda: anatomy_probe(x, plan, name), dev, iters),
             "plain_ms": timing.time_ms(lambda: anatomy_probe_plain(x, plan, name), dev, 1)}
        r["transforms_per_s"] = rows / (r["ms"] * 1e-3)
        if dev.type == "cuda":
            if name == "stages":
                tables = plan.s1_v2.nbytes + plan.s2_v2.nbytes
                r["sass"] = sass_per_butterfly(kernel_name(plan.m1, name), plan)
                r["bound_ms"], r["bound_by"] = bound_ms(rows, n, r["sass"], tables)
                r["bound_by_pipe"] = bound_by_pipe(rows, n, r["sass"], tables)
            else:
                r["sass"] = moves_sass(plan)
                r["bound_ms"], r["bound_by"] = bound_ms(rows, n, None, plan.tw.nbytes)
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
    where = (f"cuda: {card.card_line()}" if a.device != "cpu"
             else "cpu: the plain PyTorch version (no device rate)")
    print(f"[ntt_anatomy] {where}; ({a.batch}, {a.limbs}, {a.n}), every variant equal to "
          "the plain version", flush=True)
    for name in VARIANTS:
        r = res[name]
        line = (f"[ntt_anatomy] {name:>6}: {r['ms']:.4f} ms, {r['transforms_per_s']:,.0f} "
                f"limb-transforms/s, {name} / full {r['ms'] / res['k1_ms']:.3f}")
        if "sass" in r:
            s = r["sass"]
            line += (f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
                     f"{r['bound_ms'] / r['ms']:.3f}; plain {r['plain_ms']:.2f} ms; ")
            if name == "stages":
                line += (f"operations {r['bound_by_pipe']['operations_ms']:.4f} ms by pipe; "
                         f"SASS per butterfly: FMA pipe {s['fma']:.2f} ({s['fma_slots']:.2f} "
                         f"slots), ALU {s['alu']:.2f}, memory {s['memory']:.2f}")
            else:
                line += (f"SASS in its row loop (static): LDS {s['opcodes'].get('LDS', 0):.0f}, "
                         f"STS {s['opcodes'].get('STS', 0):.0f}, memory {s['memory']:.0f}")
        print(line, flush=True)
    print(f"[ntt_anatomy]   full: {res['k1_ms']:.4f} ms, {res['k1_transforms_per_s']:,.0f} "
          "limb-transforms/s (K1, ops/ntt_cuda.ntt, forward; equal to the plain ntt)", flush=True)
    return res


if __name__ == "__main__":
    main()
