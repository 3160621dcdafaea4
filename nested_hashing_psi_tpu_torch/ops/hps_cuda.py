"""BFV's HPS multiply as CUDA kernels (csrc/hps.cu), coefficient by
coefficient, each limb of a coefficient held in registers.

Three launches, each bit-exact with the plain PyTorch functions it replaces:

- ``rescale_extend``: ``RNSRescale.rescale`` (L -> Lk), then, in the same
  pass, ``BasisExtension.convert`` of its output to the aux base (with the
  float64 overflow count or without it); either step alone too (the ship
  rescale; the full-basis extension);
- ``tensor_products``: ``fhe/bgv.py`` ``tensor_product`` over q' and over
  aux in one launch (private to ``BFVContext._hps_core``);
- ``scale_exact``: ``BFVMulConverter.scale_round`` (its lazy q -> aux
  extension included), then ``exact_to_q``; either alone too.

The wrappers take CUDA tensors only (int32 residues (..., L, N),
contiguous) and raise on anything else: the plain versions in
``ops/basis.py`` and ``fhe/bgv.py`` are the CPU path, and ``ops/basis.py``
calls these wrappers for CUDA tensors. Each converter's constants become
one table (``rescale_table``, ``extension_table``, ``mul_table``,
``tensor_table``; their layouts are hps.cu's ``kR*``, ``kE*``, ``kM*``),
built once per (converter, device). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants

MAX_Q, MAX_AUX = 16, 20  # hps.cu's kMaxQ, kMaxAux: the most limbs a side
# hps.cu's table layouts: word offsets, a Shoup pair two words, a double two
R_KEEP_P, R_DROP_P, R_QDHAT_INV, R_QDHAT_MOD_K = 0, 16, 32, 64
R_QD_MOD_K, R_QDINV_MOD_K, R_INV_DROP, R_WORDS = 576, 608, 640, 672
E_SRC_P, E_DST_P, E_QHAT_INV, E_QHAT_MOD_B = 0, 16, 36, 68
E_Q_MOD_B, E_INV_SRC, E_WORDS = 708, 748, 780
M_T_Q, M_T_AUX, M_QINV_AUX, M_C_MOD_AUX, M_C_MOD_Q = 0, 32, 72, 112, 132
M_BHAT_INV, M_BHAT_MOD_Q, M_BHAT_MOD_MR, M_B_MOD_Q, M_BINV_MR, M_WORDS = (
    148, 188, 828, 868, 900, 904)
T_WORDS = 3 * (MAX_Q + MAX_AUX)
RESCALE, EXTEND, CORRECT = 1, 2, 4  # rescale_extend's flags
SCALE, EXACT = 1, 2                 # scale_exact's flags

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _put_pairs(tab: np.ndarray, off: int, pair, n: int, m: int = 1, stride: int = 1) -> None:
    """Shoup pairs (w, wq), n x m of them, at tab[off:] as [n][stride] pairs."""
    w, wq = (np.asarray(a, np.uint32).reshape(n, m) for a in pair)
    grid = tab[off:off + 2 * n * stride].reshape(n, stride, 2)
    grid[:, :m, 0], grid[:, :m, 1] = w, wq


def _put_doubles(tab: np.ndarray, off: int, vals) -> None:
    vals = np.asarray(vals, np.float64).ravel()
    tab[off:off + 2 * vals.size] = vals.view(np.uint32)


def rescale_table(rs) -> np.ndarray:
    """An ``RNSRescale``'s constants in hps.cu's rescale layout (uint32)."""
    Lk, Ld = len(rs.keep_primes), len(rs.drop_primes)
    tab = np.zeros(R_WORDS, np.uint32)
    tab[R_KEEP_P:R_KEEP_P + Lk] = rs.keep_primes
    tab[R_DROP_P:R_DROP_P + Ld] = rs.drop_primes
    _put_pairs(tab, R_QDHAT_INV, rs.qdhat_inv, Ld)
    _put_pairs(tab, R_QDHAT_MOD_K, rs.qdhat_mod_k, Ld, Lk, MAX_Q)
    _put_pairs(tab, R_QD_MOD_K, rs.qd_mod_k, Lk)
    _put_pairs(tab, R_QDINV_MOD_K, rs.qdinv_mod_k, Lk)
    _put_doubles(tab, R_INV_DROP, rs._inv_drop_np)
    return tab


def extension_table(ext) -> np.ndarray:
    """A ``BasisExtension``'s constants in hps.cu's extension layout."""
    Ls, Kd = len(ext.src_primes), len(ext.dst_primes)
    tab = np.zeros(E_WORDS, np.uint32)
    tab[E_SRC_P:E_SRC_P + Ls] = ext.src_primes
    tab[E_DST_P:E_DST_P + Kd] = ext.dst_primes
    _put_pairs(tab, E_QHAT_INV, ext.qhat_inv, Ls)
    _put_pairs(tab, E_QHAT_MOD_B, ext.qhat_mod_b, Ls, Kd, MAX_AUX)
    _put_pairs(tab, E_Q_MOD_B, ext.q_mod_b, Kd)
    _put_doubles(tab, E_INV_SRC, ext._inv_src_np)
    return tab


def mul_table(mc) -> np.ndarray:
    """A ``BFVMulConverter``'s scale-and-round and return-to-q constants in
    hps.cu's multiply layout (its primes are ``mc.q_to_aux``'s table's)."""
    L, K = len(mc.q_primes), mc.K
    tab = np.zeros(M_WORDS, np.uint32)
    _put_pairs(tab, M_T_Q, mc.t_q, L)
    _put_pairs(tab, M_T_AUX, mc.t_aux, K + 1)
    _put_pairs(tab, M_QINV_AUX, mc.qinv_aux, K + 1)
    tab[M_C_MOD_AUX:M_C_MOD_AUX + K + 1] = mc.c_mod_aux.ravel()
    tab[M_C_MOD_Q:M_C_MOD_Q + L] = mc.c_mod_q.ravel()
    _put_pairs(tab, M_BHAT_INV, mc.bhat_inv, K)
    _put_pairs(tab, M_BHAT_MOD_Q, mc.bhat_mod_q, K, L, MAX_Q)
    _put_pairs(tab, M_BHAT_MOD_MR, mc.bhat_mod_mr, K)
    _put_pairs(tab, M_B_MOD_Q, mc.B_mod_q, L)
    _put_pairs(tab, M_BINV_MR, mc.Binv_mr, 1)
    return tab


def tensor_table(mc) -> np.ndarray:
    """(p, -p^-1 mod 2^32, 2^64 mod p) for each prime of q, then of aux."""
    tab = np.zeros(T_WORDS, np.uint32)
    primes = list(mc.q_primes) + list(mc.aux_primes)
    tab[:3 * len(primes)] = [v for p in primes for v in (p, *mont_constants(p))]
    return tab


def _table(owner, build, device) -> torch.Tensor:
    """``build(owner)`` on ``device`` as int32 bits, built once per device."""
    cache = owner.__dict__.setdefault("_hps_tables", {})
    key = (build.__name__, device)
    if key not in cache:
        cache[key] = torch.from_numpy(build(owner).view(np.int32)).to(device)
    return cache[key]


def _check(x: torch.Tensor, name: str, limbs: int, cap: int) -> None:
    """Raise unless x is a contiguous int32 (..., limbs, N) CUDA tensor with
    1 <= limbs <= cap (the device is checked last)."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must hold int32 residues, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != limbs:
        raise ValueError(f"{name} {tuple(x.shape)} is not (..., {limbs}, N)")
    if not 1 <= limbs <= cap:
        raise ValueError(f"{name} has {limbs} limbs; the HPS kernels take 1 to {cap}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"the HPS kernels take CUDA tensors, got {name} on {x.device}")


def _empty(x: torch.Tensor, limbs: int) -> torch.Tensor:
    return torch.empty((*x.shape[:-2], limbs, x.shape[-1]), dtype=torch.int32, device=x.device)


def _rows(x: torch.Tensor) -> int:
    return int(np.prod(x.shape[:-2], dtype=np.int64))


def _launched(rc: int, what: str, x: torch.Tensor) -> None:
    global launches
    cuda_lib.check(rc, what)
    if x.numel():
        launches += 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rescale_extend(x: torch.Tensor, rescaler=None, extension=None,
                   correction: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(keep, aux): x (..., L, N) rescaled by ``rescaler`` (an
    ``RNSRescale``) to (..., Lk, N), and that (or x itself, without a
    rescaler) extended by ``extension`` (a ``BasisExtension`` from those
    primes) to (..., K, N), with its overflow count when ``correction``.
    A step not asked for gives None."""
    if rescaler is None and extension is None:
        raise ValueError("rescale_extend needs a rescaler, an extension or both")
    L = x.shape[-2] if x.dim() >= 2 else 0
    _check(x, "x", L, MAX_Q)
    flags, Lk, KA, keep, aux, rtab, etab = 0, 0, 0, None, None, None, None
    src = L
    if rescaler is not None:
        Lk = len(rescaler.keep_primes)
        if L != Lk + len(rescaler.drop_primes):
            raise ValueError(f"x has {L} limbs; the rescaler takes "
                             f"{Lk + len(rescaler.drop_primes)}")
        flags, src = RESCALE, Lk
        keep, rtab = _empty(x, Lk), _table(rescaler, rescale_table, x.device)
    if extension is not None:
        if len(extension.src_primes) != src or (
                rescaler is not None and extension.src_primes != rescaler.keep_primes):
            raise ValueError("the extension's source base is not the rescaled (or read) base")
        KA = len(extension.dst_primes)
        if not 1 <= KA <= MAX_AUX:
            raise ValueError(f"the extension has {KA} target limbs; the HPS kernels take "
                             f"1 to {MAX_AUX}")
        flags |= EXTEND | (CORRECT if correction else 0)
        aux, etab = _empty(x, KA), _table(extension, extension_table, x.device)
    rc = cuda_lib.get_lib().nhpsi_hps_rescale_extend(
        x.data_ptr(), _ptr(keep), _ptr(aux), _ptr(rtab), _ptr(etab), _rows(x), L, Lk, KA,
        x.shape[-1], flags, _stream(x))
    _launched(rc, "hps_rescale_extend", x)
    return keep, aux


def tensor_products(a: torch.Tensor, b: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
                    mc) -> tuple[torch.Tensor, torch.Tensor]:
    """``tensor_product(a, b)`` over q (a, b (..., 2, L, N) NTT-domain) and
    ``tensor_product(ea, eb)`` over aux (..., 2, K+1, N), in one launch:
    (..., 3, L, N), (..., 3, K+1, N). ``mc`` is the ``BFVMulConverter``
    whose bases they are."""
    Lq, KA = len(mc.q_primes), len(mc.aux_primes)
    for t, name in ((a, "a"), (b, "b")):
        _check(t, name, Lq, MAX_Q)
    for t, name in ((ea, "ea"), (eb, "eb")):
        _check(t, name, KA, MAX_AUX)
    lead, n = a.shape[:-2], a.shape[-1]
    if (a.dim() < 3 or a.shape[-3] != 2 or b.shape[:-2] != lead or ea.shape[:-2] != lead
            or eb.shape[:-2] != lead or {b.shape[-1], ea.shape[-1], eb.shape[-1]} != {n}):
        raise ValueError(f"operands {tuple(a.shape)}, {tuple(b.shape)}, {tuple(ea.shape)}, "
                         f"{tuple(eb.shape)} are not (..., 2, L, N) and (..., 2, K+1, N)")
    dq = torch.empty((*lead[:-1], 3, Lq, n), dtype=torch.int32, device=a.device)
    daux = torch.empty((*lead[:-1], 3, KA, n), dtype=torch.int32, device=a.device)
    rc = cuda_lib.get_lib().nhpsi_hps_tensor(
        a.data_ptr(), b.data_ptr(), ea.data_ptr(), eb.data_ptr(), dq.data_ptr(),
        daux.data_ptr(), _table(mc, tensor_table, a.device).data_ptr(), _rows(a) // 2, Lq, KA,
        n, _stream(a))
    _launched(rc, "hps_tensor", a)
    return dq, daux


def scale_exact(d_q: torch.Tensor | None, d_in: torch.Tensor, mc, scale: bool = True,
                exact: bool = True) -> torch.Tensor:
    """With ``scale``: y = round(t d / q) over aux from d's residues over q
    (d_q (..., L, N)) and over aux (d_in (..., K+1, N)); without, y is d_in.
    With ``exact``, y's exact residues over q (..., L, N); without, y."""
    if not (scale or exact):
        raise ValueError("scale_exact needs scale, exact or both")
    Lq, KA = len(mc.q_primes), len(mc.aux_primes)
    _check(d_in, "d_in", KA, MAX_AUX)
    if scale:
        _check(d_q, "d_q", Lq, MAX_Q)
        if d_q.shape[:-2] != d_in.shape[:-2] or d_q.shape[-1] != d_in.shape[-1]:
            raise ValueError(f"d_q {tuple(d_q.shape)} and d_in {tuple(d_in.shape)} differ")
    elif not 1 <= Lq <= MAX_Q:
        raise ValueError(f"q has {Lq} limbs; the HPS kernels take 1 to {MAX_Q}")
    out = _empty(d_in, Lq if exact else KA)
    etab = _table(mc.q_to_aux, extension_table, d_in.device)
    rc = cuda_lib.get_lib().nhpsi_hps_scale_exact(
        _ptr(d_q) if scale else None, d_in.data_ptr(), out.data_ptr(), etab.data_ptr(),
        _table(mc, mul_table, d_in.device).data_ptr(), _rows(d_in), Lq, KA, d_in.shape[-1],
        (SCALE if scale else 0) | (EXACT if exact else 0), _stream(d_in))
    _launched(rc, "hps_scale_exact", d_in)
    return out
