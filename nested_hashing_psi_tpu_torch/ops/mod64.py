"""Two-plane arithmetic mod a wide modulus t (32 < bits(t) <= 62), PyTorch.

Counterpart of ``nested_hashing_psi_tpu.ops.mod64``: values in [0, t) are
(lo, hi) pairs of 32-bit planes, and the operations are the ones the
on-device decrypt and the server's packed encode (``fhe.device_encode``)
need -- modular add/sub, the forward and inverse NTT, and multiplication by
PRECOMPUTED constants with a 64-bit Shoup reduction (for a constant w < t
with wq = floor(w * 2**64 / t), q = floor(x * wq / 2**64) underestimates
floor(x*w/t) by at most 1, so r = (x*w - q*t) mod 2**64 lies in [0, 2t)).

Torch on the CPU has no uint32 or uint64 add, shift or compare, so each
plane is an int64 tensor holding a value in [0, 2**32), and every product of
two planes is assembled from 16-bit halves (``modmath.mulhi_u32`` /
``_mullo32``) so that no partial product reaches 2**63. The same code runs
on the CPU and the GPU, and every function returns exactly the planes the
JAX package's uint32 version returns.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops.modmath import MASK32, _mullo32, mulhi_u32


def split_u64(x: int) -> tuple[int, int]:
    """Host: int < 2**64 -> (lo32, hi32)."""
    x = int(x)
    assert 0 <= x < 1 << 64
    return x & MASK32, x >> 32


def shoup64_host(w: int, t: int) -> tuple[int, int]:
    """Host: Shoup quotient floor(w * 2**64 / t) as (lo32, hi32)."""
    return split_u64((int(w) << 64) // int(t))


def _addc(a, b):
    """Wrapping 32-bit add + carry-out (0/1)."""
    s = a + b
    return s & MASK32, s >> 32


def mul64_lo(x0, x1, w0, w1):
    """Low 64 bits of (x0 + 2^32 x1) * (w0 + 2^32 w1), as (lo, hi) planes."""
    l0 = _mullo32(x0, w0)
    l1 = (mulhi_u32(x0, w0) + _mullo32(x0, w1) + _mullo32(x1, w0)) & MASK32
    return l0, l1


def mul64_hi(x0, x1, w0, w1):
    """High 64 bits (bits 64..127) of the full 128-bit product."""
    h00 = mulhi_u32(x0, w0)
    l01, h01 = _mullo32(x0, w1), mulhi_u32(x0, w1)
    l10, h10 = _mullo32(x1, w0), mulhi_u32(x1, w0)
    l11, h11 = _mullo32(x1, w1), mulhi_u32(x1, w1)
    s1, c1a = _addc(h00, l01)
    _, c1b = _addc(s1, l10)
    s2, c2a = _addc(h01, h10)
    s2, c2b = _addc(s2, l11)
    s2, c2c = _addc(s2, c1a + c1b)
    return s2, (h11 + c2a + c2b + c2c) & MASK32


def ge64(a0, a1, b0, b1):
    """(a >= b) for 64-bit plane pairs -> bool tensor."""
    return (a1 > b1) | ((a1 == b1) & (a0 >= b0))


def sub64(a0, a1, b0, b1):
    """Wrapping 64-bit subtract."""
    d0 = a0 - b0
    borrow = (d0 < 0).long()
    return d0 & MASK32, (a1 - b1 - borrow) & MASK32


def add64(a0, a1, b0, b1):
    """Wrapping 64-bit add."""
    s0, c = _addc(a0, b0)
    return s0, (a1 + b1 + c) & MASK32


def csub64(a0, a1, t0, t1):
    """[a]_t for a < 2t (one conditional subtract)."""
    ge = ge64(a0, a1, t0, t1)
    d0, d1 = sub64(a0, a1, t0, t1)
    return torch.where(ge, d0, a0), torch.where(ge, d1, a1)


def add2_mod(a, b, t2):
    """(a + b) mod t for plane pairs a, b < t (t < 2^62: no 64-bit wrap)."""
    s0, s1 = add64(a[0], a[1], b[0], b[1])
    return csub64(s0, s1, t2[0], t2[1])


def sub2_mod(a, b, t2):
    """(a - b) mod t for plane pairs a, b < t."""
    s0, s1 = add64(a[0], a[1], t2[0], t2[1])
    d0, d1 = sub64(s0, s1, b[0], b[1])
    return csub64(d0, d1, t2[0], t2[1])


def shoup_mul2(x, w2, wq2, t2):
    """x * w mod t for x < 2^64 and a precomputed constant w < t
    (wq2 = shoup64_host(w, t) planes). Returns planes < t."""
    q0, q1 = mul64_hi(x[0], x[1], wq2[0], wq2[1])
    xw0, xw1 = mul64_lo(x[0], x[1], w2[0], w2[1])
    qt0, qt1 = mul64_lo(q0, q1, t2[0], t2[1])
    r0, r1 = sub64(xw0, xw1, qt0, qt1)
    return csub64(r0, r1, t2[0], t2[1])


def shoup_quotient2(w, c2, cq2, tinv2, t2):
    """Shoup quotients floor(w * 2**64 / t) of plane pairs w < t that are
    not constants (t odd): r = w * 2**64 mod t is a Shoup product by the
    constant c = 2**64 mod t (c2, cq2), and w * 2**64 - r = t * q exactly
    with q < 2**64, so q = -r * t^-1 mod 2**64 (tinv2 = t^-1 mod 2**64)."""
    r = shoup_mul2(w, c2, cq2, t2)
    neg = sub64(torch.zeros_like(r[0]), torch.zeros_like(r[1]), r[0], r[1])
    return mul64_lo(neg[0], neg[1], tinv2[0], tinv2[1])


def planes_from_u64_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host: uint64/object array -> (lo, hi) uint32 arrays."""
    if x.dtype == object:
        lo = np.array([[int(v) & MASK32 for v in row] for row in np.atleast_2d(x)])
        hi = np.array([[int(v) >> 32 for v in row] for row in np.atleast_2d(x)])
        return lo.astype(np.uint32).reshape(x.shape), hi.astype(np.uint32).reshape(x.shape)
    x = x.astype(np.uint64)
    return (x & np.uint64(MASK32)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def u64_from_planes_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host: (lo, hi) uint32 arrays -> uint64."""
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def planes(x: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host uint64/object array -> (lo, hi) int64 plane tensors on device."""
    lo, hi = planes_from_u64_np(np.asarray(x))
    return (torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(hi.astype(np.int64)).to(device))


def ntt2_mod_t(x2, psi_rev_w, psi_rev_wq, t2):
    """Forward negacyclic NTT mod t over plane pairs: the Cooley-Tukey
    structure and output order of the encoder's ``ntt_numpy`` (which defines
    the slot order). x2 = (lo, hi) with shape (..., n); twiddles are the
    bit-reversed psi powers as plane pairs, Shoup quotients alongside."""
    lo, hi = x2
    n = lo.shape[-1]
    logn = n.bit_length() - 1
    bshape = lo.shape[:-1]
    m, tt = 1, n
    for _ in range(logn):
        tt //= 2
        lo = lo.reshape(*bshape, m, 2, tt)
        hi = hi.reshape(*bshape, m, 2, tt)
        s_w = (psi_rev_w[0][m : 2 * m][:, None], psi_rev_w[1][m : 2 * m][:, None])
        s_wq = (psi_rev_wq[0][m : 2 * m][:, None], psi_rev_wq[1][m : 2 * m][:, None])
        u = (lo[..., 0, :], hi[..., 0, :])
        v = shoup_mul2((lo[..., 1, :], hi[..., 1, :]), s_w, s_wq, t2)
        a = add2_mod(u, v, t2)
        b = sub2_mod(u, v, t2)
        lo = torch.stack([a[0], b[0]], dim=-2)
        hi = torch.stack([a[1], b[1]], dim=-2)
        m *= 2
    return lo.reshape(*bshape, n), hi.reshape(*bshape, n)


def intt2_mod_t(x2, ipsi_rev_w, ipsi_rev_wq, ninv2, ninvq2, t2):
    """Inverse of ``ntt2_mod_t`` over plane pairs: the Gentleman-Sande
    structure of the encoder's ``intt_numpy`` (bit-reversed -> natural),
    twiddles the bit-reversed powers of psi^-1, then times n^-1 mod t
    (ninv2, ninvq2: its planes and Shoup quotient)."""
    lo, hi = x2
    n = lo.shape[-1]
    bshape = lo.shape[:-1]
    m, tt = n, 1
    while m > 1:
        h = m // 2
        lo = lo.reshape(*bshape, h, 2, tt)
        hi = hi.reshape(*bshape, h, 2, tt)
        s_w = (ipsi_rev_w[0][h : 2 * h][:, None], ipsi_rev_w[1][h : 2 * h][:, None])
        s_wq = (ipsi_rev_wq[0][h : 2 * h][:, None], ipsi_rev_wq[1][h : 2 * h][:, None])
        u = (lo[..., 0, :], hi[..., 0, :])
        v = (lo[..., 1, :], hi[..., 1, :])
        a = add2_mod(u, v, t2)
        b = shoup_mul2(sub2_mod(u, v, t2), s_w, s_wq, t2)
        lo = torch.stack([a[0], b[0]], dim=-2)
        hi = torch.stack([a[1], b[1]], dim=-2)
        tt *= 2
        m = h
    return shoup_mul2((lo.reshape(*bshape, n), hi.reshape(*bshape, n)), ninv2, ninvq2, t2)
