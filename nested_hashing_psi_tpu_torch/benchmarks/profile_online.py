"""The batched-PIE online step, and its HPS multiply, by part.

Counterpart of ``benchmarks/profile_online.py``, at the bench geometry
(``small_pie.bench_row``: the Parameters1.txt 2^20 x 2048 row, BFV):

    python -m nested_hashing_psi_tpu_torch.benchmarks.profile_online [main|hps|trace]
        [--device cuda]

``main`` times the step's parts:

  pos_sum        K2's position sum over the whole table (H, D, 2, L, N)
  hps_mul        one BFV HPS ct x ct at (D, 2, L, N) (``_hps_mul_impl``)
  relin          one relinearisation at (D, 3, L, N) (``_relinearize_impl``)
  ctxpt          one (D, 2, L, N) ct x pt, the masked-minus shape
  full           the whole ``batched_pie_forward`` on the full basis
  full_rescaled  the production pipeline (the rescaled-mult basis)

``hps`` splits the HPS multiply (on the full basis) into its transforms
(K1, ``fhe/bgv.py`` ``_ntt_fast``/``_intt_fast``, ``fhe/bfv.py`` the aux
transforms) and its base conversions (``ops/basis.py``
``extend_q_to_aux``, ``scale_round``, ``exact_to_q``) and tensor
products (``fhe/bgv.py`` ``tensor_product``), under the JAX tool's names.

Each row is the mean ms of 20 calls issued back to back
(``timing.time_ms``: CUDA events on the card) beside the device kernels
one call launches and their device ms, from a torch.profiler trace of one
call (``timing.traced_kernels``). On the card ``main`` then times each
kernel of a set alone at the shapes of the benchmark's three cells
(``SHAPES``): K2, BFV's four HPS kernels (``csrc/hps.cu``) and the decrypt
kernel, from a CUDA graph of 20 calls (the device's time) and through the
wrapper back to back, beside its bound (``benchmarks/card.py``) and the
share of it the graph's time reaches. ``trace`` writes a torch.profiler trace
(``utils.profiling.device_trace``) of 8 steps of the production pipeline,
each followed by the device decrypt's zero mask, into
``eval_results_torch/trace_online``, and prints the top device kernels by
total ms. ``--device cpu`` runs the plain versions (host clocks, no
kernels); the tests call ``main_rows``, ``hps_rows`` and ``capture_trace``
on a small PIE.
"""

from __future__ import annotations

import argparse
import os

import torch

from nested_hashing_psi_tpu_torch.benchmarks import card, small_pie
from nested_hashing_psi_tpu_torch.benchmarks.timing import (
    EVAL_DIR,
    graph_ms,
    time_ms,
    traced_kernels,
)
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, tensor_product
from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, bfv_mul_limbs, bfv_ship_limbs
from nested_hashing_psi_tpu_torch.ops import decrypt_cuda, hps_cuda, pie_kernels
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter, RNSRescale
from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, mont_mul
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward, position_sum
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

MAIN_ROWS = ("pos_sum", "hps_mul", "relin", "ctxpt", "full", "full_rescaled")
# The shapes of the benchmark's three cells (their source: psi_bench/configs):
# H = 2 inner hashes, ring 16384, t = 2^32 + 2^20 + 2^19 + 1, 2 x 8022 batch
# slots; name -> (D = P, L, form)
SHAPES = {"D12_L6_bfv": (12, 6, "bfv"), "D12_L9_bgv": (12, 9, "bgv"),
          "D48_L6_bfv": (48, 6, "bfv")}
SHAPE_T, SHAPE_N, SHAPE_SLOTS = (1 << 32) + (1 << 20) + (1 << 19) + 1, 16384, 2 * 8022
HPS_ROWS = ("intt_q(2xDx2xL)", "extend(VPU)", "ntt_aux(2xDx2xKA)", "tensor_both",
            "intt_dq(Dx3xL)", "intt_daux(Dx3xKA)", "scale+exact(VPU)", "ntt_final(Dx3xL)")


def _measure(rows: dict, device: torch.device, iters: int) -> dict:
    """name -> {ms, kernels, kernel_ms} for rows {name: (step, args)}."""
    out = {}
    for name, (step, args) in rows.items():
        def call():
            return step(*args)
        kernels = kernel_ms = None  # the CPU runs no kernel
        if device.type == "cuda":
            traced = traced_kernels(call, device)
            if not traced:
                raise RuntimeError(f"{name}: the profiler recorded no kernel on the device")
            kernels, kernel_ms = len(traced), sum(ms for _, ms in traced)
        out[name] = {"ms": time_ms(call, device, iters), "kernels": kernels,
                     "kernel_ms": kernel_ms}
    return out


def print_rows(tag: str, res: dict) -> None:
    for name, r in res.items():
        k = ("n/a (cpu)" if r["kernels"] is None
             else f"{r['kernels']:.0f} kernels, {r['kernel_ms']:.4f} ms of kernels")
        print(f"[{tag}] {name:>22}: {r['ms']:9.4f} ms  ({k})", flush=True)


def print_sum(res: dict) -> None:
    parts = sum(res[k]["ms"] for k in MAIN_ROWS[:4])
    print(f"[profile_online] sum(parts) = {parts:.4f} ms (pos_sum + hps_mul + relin + ctxpt) "
          f"vs full = {res['full']['ms']:.4f} ms", flush=True)


def _ip_operands(built: small_pie.SmallPIE):
    """The position sums plus minus, split by hash: a_d, b_d (D, 2, L, N)."""
    ctx, pie, idx_ct, minus_ct = built.ctx, built.pie, built.idx_ct, built.minus_ct
    ip0 = add_mod(position_sum(ctx, idx_ct.data, pie.table_pt), minus_ct.data[None, None], ctx.p)
    return ip0[0].contiguous(), ip0[1].contiguous()


def main_rows(built: small_pie.SmallPIE, device: torch.device, iters: int = 20) -> dict:
    """The step's six parts (``MAIN_ROWS``)."""
    ctx, pie, rlk = built.ctx, built.pie, built.pie.rlk
    idx, minus = built.idx_ct.data, built.minus_ct.data
    table, mask = pie.table_pt, pie.mask_pt
    a_d, b_d = _ip_operands(built)

    def f_hps(a, b):
        return ctx._hps_mul_impl(Ciphertext(a, "bfv", 1), Ciphertext(b, "bfv", 1)).data

    d3 = f_hps(a_d, b_d)  # (D, 3, L, N)

    def f_relin(d):
        return ctx._relinearize_impl(Ciphertext(d, "bfv", 1), rlk).data

    ct2 = f_relin(d3)
    rows = {
        "pos_sum": (lambda i: position_sum(ctx, i, table), (idx,)),
        "hps_mul": (f_hps, (a_d, b_d)),
        "relin": (f_relin, (d3,)),
        "ctxpt": (lambda x: mont_mul(x, mask[:, None], ctx.p, ctx.pinv), (ct2,)),
        "full": (lambda i: batched_pie_forward(ctx, rlk, i, minus, table, mask).data, (idx,)),
    }
    if pie.mul_limbs:
        rows["full_rescaled"] = (
            lambda i: batched_pie_forward(ctx, rlk, i, minus, table, mask,
                                          mul_limbs=pie.mul_limbs,
                                          ship_limbs=pie.ship_limbs).data, (idx,))
    return _measure(rows, device, iters)


def hps_rows(built: small_pie.SmallPIE, device: torch.device, iters: int = 20) -> dict:
    """The HPS multiply's eight parts (``HPS_ROWS``), on the full basis."""
    ctx = built.ctx
    mc = ctx.mulconv
    ta = mc.plan_aux.tensors(ctx.device)
    a_d, b_d = _ip_operands(built)
    ab = torch.stack([a_d, b_d])  # (2, D, 2, L, N)

    def f_tensor_both(eab, ab2):
        d_aux = tensor_product(eab[0], eab[1], ta["p"], ta["pinv"], ta["r2"])
        d_q = tensor_product(ab2[0], ab2[1], ctx.p, ctx.pinv, ctx.r2)
        return d_q, d_aux

    def f_scale_exact(d_q_c, d_aux_c):
        return mc.exact_to_q(mc.scale_round(d_q_c, d_aux_c))

    coeffs = ctx._intt_fast(ab)
    ext = mc.extend_q_to_aux(coeffs)
    eab = ctx._ntt_fast_aux(ext)
    d_q, d_aux = f_tensor_both(eab, ab)
    d_q_c, d_aux_c = ctx._intt_fast(d_q), ctx._intt_fast_aux(d_aux)
    y_q = f_scale_exact(d_q_c, d_aux_c)
    rows = {
        "intt_q(2xDx2xL)": (ctx._intt_fast, (ab,)),
        "extend(VPU)": (mc.extend_q_to_aux, (coeffs,)),
        "ntt_aux(2xDx2xKA)": (ctx._ntt_fast_aux, (ext,)),
        "tensor_both": (f_tensor_both, (eab, ab)),
        "intt_dq(Dx3xL)": (ctx._intt_fast, (d_q,)),
        "intt_daux(Dx3xKA)": (ctx._intt_fast_aux, (d_aux,)),
        "scale+exact(VPU)": (f_scale_exact, (d_q_c, d_aux_c)),
        "ntt_final(Dx3xL)": (ctx._ntt_fast, (y_q,)),
    }
    print(f"[hps_parts] KA={mc.K + 1} L={ctx.L} D={built.pie.D}", flush=True)
    return _measure(rows, device, iters)


def kernel_rows(device: torch.device, shapes: dict = SHAPES, iters: int = 20) -> dict:
    """Each kernel of a set alone at each of ``shapes``, on the card: K2
    over the (2, D, D, L, n) table; under BFV the rescale with the base
    extension (L -> mul_limbs + aux), the tensor products, scale-and-round
    with the return to q (D products) and the ship rescale; the decrypt
    kernel on the (D, shipped limbs, n) phase. Inputs are residues below
    the smallest prime, drawn on the card. -> {"<shape> <kernel>": {shape,
    graph_ms, wrapper_ms, bound_ms, bound_by, share}}"""
    gen = torch.Generator(device=device).manual_seed(23)
    n, out = SHAPE_N, {}

    def res(shape, primes):
        return torch.randint(0, int(min(primes)), shape, generator=gen, device=device,
                             dtype=torch.int32)

    def row(name, shape, fn, bound):
        g_ms, w_ms = graph_ms(fn, device, iters), time_ms(fn, device, iters)
        out[name] = {"shape": list(shape), "graph_ms": g_ms, "wrapper_ms": w_ms,
                     "bound_ms": bound[0], "bound_by": bound[1], "share": bound[0] / g_ms}

    for label, (D, L, form) in shapes.items():
        ctx = make_context(SchemeParams(ring_dim=n, plaintext_modulus=SHAPE_T, num_limbs=L,
                                        scheme=form), seed=0, device=device)
        q = list(ctx.q_primes)
        tb = NTTPlan(n, q).tensors(device)
        idx, pt = res((2, D, 2, L, n), q), res((2, D, D, L, n), q)
        row(f"{label} K2", pt.shape,
            lambda: pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"]),
            card.k2_bound(2, D, D, L, n))
        del idx, pt
        shipped = L
        if form == "bfv":
            mul = bfv_mul_limbs(SHAPE_T.bit_length(), L, 1, ring_dim=n)
            shipped = bfv_ship_limbs(SHAPE_T.bit_length(), mul, ring_dim=n)
            mc, rs, ship = BFVMulConverter(q[:mul], SHAPE_T, n), RNSRescale(q, L - mul), \
                RNSRescale(q[:mul], mul - shipped)
            aux = list(mc.aux_primes)
            x = res((2, D, 2, L, n), q)
            row(f"{label} HPS rescale + extension", x.shape,
                lambda: rs.rescale_extend(x, mc.q_to_aux),
                card.hps_rescale_extend_bound(4 * D, n, L, mul, len(aux)))
            a, b, ea, eb = (res((D, 2, mul, n), q[:mul]), res((D, 2, mul, n), q[:mul]),
                            res((D, 2, len(aux), n), aux), res((D, 2, len(aux), n), aux))
            row(f"{label} HPS tensor products", (D, 2, mul + len(aux), n),
                lambda: hps_cuda.tensor_products(a, b, ea, eb, mc),
                card.hps_tensor_bound(D, n, mul, len(aux)))
            d_q, d_aux = res((D, 3, mul, n), q[:mul]), res((D, 3, len(aux), n), aux)
            row(f"{label} HPS scale + exact return", (D, 3, mul + len(aux), n),
                lambda: mc.scale_round_to_q(d_q, d_aux),
                card.hps_scale_exact_bound(3 * D, n, mul, len(aux)))
            y = res((D, 2, mul, n), q[:mul])
            row(f"{label} HPS ship rescale", y.shape, lambda: ship.rescale(y),
                card.hps_rescale_extend_bound(2 * D, n, mul, shipped, 0))
            del x, a, b, ea, eb, d_q, d_aux, y
        dctx = ctx.context_for_limbs(shipped)
        tables = DeviceDecryptor(dctx, form).kernel_tables
        phase = res((D, shipped, n), dctx.q_primes)
        row(f"{label} decrypt", phase.shape,
            lambda: decrypt_cuda.zero_mask(phase, *tables, form == "bgv", SHAPE_SLOTS),
            card.decrypt_bound(D, shipped, n, SHAPE_SLOTS, form == "bgv"))
        del phase
        torch.cuda.empty_cache()
    return out


def print_kernel_rows(res: dict) -> None:
    line = card.card_line()
    for name, r in res.items():
        print(f"[kernels] {name} {tuple(r['shape'])}: {r['graph_ms']:.4f} ms from a CUDA graph, "
              f"{r['wrapper_ms']:.4f} ms through the wrapper; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), share {r['share']:.3f} | {line}", flush=True)


def capture_trace(built: small_pie.SmallPIE, device: torch.device,
                  outdir: str = os.path.join(EVAL_DIR, "trace_online"), steps: int = 8) -> list:
    """A torch.profiler trace of ``steps`` production steps, each followed by
    the device decrypt's zero mask; -> [(kernel name, total ms)], largest
    first (empty on the CPU)."""
    ctx, sk, rlk, pie, ops, idx_ct, minus_ct = built
    L_ship = pie.ship_limbs or ctx.L
    dec = DeviceDecryptor(ctx.context_for_limbs(L_ship))
    s_mont = ctx.shrink_key_to(sk, L_ship).s_mont

    def step():
        return dec.zero_mask(pie(idx_ct.data, minus_ct.data).data, s_mont).any(dim=0)

    kernels = traced_kernels(step, device, steps, outdir)
    print(f"[trace] written to {os.path.join(outdir, 'trace.json')}", flush=True)
    totals: dict = {}
    for name, ms in kernels:
        totals[name] = totals.get(name, 0.0) + ms
    top = sorted(totals.items(), key=lambda kv: -kv[1])
    print(f"[trace] top device kernels by total ms over {steps} steps:", flush=True)
    for name, ms in top[:24]:
        print(f"  {ms:9.3f} ms  {name[:90]}", flush=True)
    return top


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="main", choices=("main", "hps", "trace"))
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    built = small_pie.bench_row(device=device)
    ctx, pie = built.ctx, built.pie
    print(f"[profile_online] geometry H={pie.H} D={pie.D} P={pie.P} L={ctx.L} n={ctx.n} "
          f"mul_limbs={pie.mul_limbs} ship_limbs={pie.ship_limbs} device {device}", flush=True)
    if a.mode == "trace":
        return capture_trace(built, device)
    if a.mode == "hps":
        res = hps_rows(built, device)
        print_rows("hps_parts", res)
        return res
    res = main_rows(built, device)
    print_rows("profile_online", res)
    print_sum(res)
    if device.type == "cuda":
        del built
        res["kernels"] = kernel_rows(device)
        print_kernel_rows(res["kernels"])
    return res


if __name__ == "__main__":
    main()
