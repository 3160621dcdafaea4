"""uint32 arithmetic that wraps mod 2^32, on int64 tensors holding values
in [0, 2^32): the JAX package's formulas (``ops/modmath.py`` there) step by
step, for the probes' plain versions.

The probes feed these functions any 32-bit pattern, not only residues
below p, and JAX's formulas wrap where an exact product would not; the
port's ``ops/modmath.py`` (exact int64 products, canonical residues) gives
other bits on such inputs. So every add, subtract and multiply here is
masked to 32 bits, and every product is built from 16-bit halves so that
no int64 intermediate overflows.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M16 = 0xFFFF


def from_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit view -> int64 values in [0, 2^32)."""
    return x.long() & MASK


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 bit view."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def add(a, b):
    return (a + b) & MASK


def sub(a, b):
    return (a - b) & MASK


def mullo(a, b):
    """a * b mod 2^32 (a, b < 2^32): al b + (ah b mod 2^16) 2^16."""
    return ((a & M16) * b + ((((a >> 16) * b) & M16) << 16)) & MASK


def mulhi(a, b):
    """High 32 bits of a * b, from 16-bit partial products (JAX mulhi_u32)."""
    al, ah, bl, bh = a & M16, a >> 16, b & M16, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & M16) + (hl & M16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def mulhi_presplit(x, wl, wh):
    """mulhi with the constant operand pre-split into 16-bit halves."""
    xl, xh = x & M16, x >> 16
    ll, lh, hl, hh = xl * wl, xl * wh, xh * wl, xh * wh
    mid = (ll >> 16) + (lh & M16) + (hl & M16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def csub(x, p):
    """where(x >= p, x - p, x), unsigned."""
    return torch.where(x >= p, x - p, x)


def add_mod(a, b, p):
    return csub(add(a, b), p)


def sub_mod(a, b, p):
    return csub(add(sub(a, b), p), p)


def shoup_lazy(x, w, wq, p):
    """x w - mulhi(x, wq) p, wrapped (in [0, 2p) when x w < 2^32 p)."""
    return sub(mullo(x, w), mullo(mulhi(x, wq), p))


def shoup_mul(x, w, wq, p):
    return csub(shoup_lazy(x, w, wq, p), p)


def mont_mul(a, b, p, pinv):
    """REDC as the JAX package writes it: lo, hi of a b; m = lo pinv;
    t = hi + mulhi(m, p) + (lo != 0); csub(t, p), all wrapping."""
    lo = mullo(a, b)
    t = add(add(mulhi(a, b), mulhi(mullo(lo, pinv), p)), (lo != 0).long())
    return csub(t, p)


def split_stage(X, sw, sq, te: int, p, butterfly):
    """One split-form stage down axis -2 of X (B, L, M, W): rows r and
    r + te of each 2te-row group are a butterfly's u and v, and each takes
    the table entry (sw, sq: (L, M)) of its v row; p: (L, 1, 1, 1).
    ``butterfly(u, v, w, wq, p)`` returns the new (u, v)."""
    B, L, M, W = X.shape
    g = M // (2 * te)
    Xr = X.reshape(B, L, g, 2, te, W)
    wv = sw.reshape(L, g, 2, te)[:, :, 1, :, None]
    qv = sq.reshape(L, g, 2, te)[:, :, 1, :, None]
    u, v = butterfly(Xr[:, :, :, 0], Xr[:, :, :, 1], wv, qv, p)
    return torch.stack([u, v], dim=3).reshape(B, L, M, W)


def pair_distance(M: int, k: int) -> int:
    """Stage k's pair distance in the probes: t = M >> (k + 1) from 8 up,
    t * (M / 8) below (the regrouped row space's distance)."""
    t = M >> (k + 1)
    return t if t >= 8 else t * (M // 8)


def ct_exact(u, v, w, wq, p):
    x = shoup_mul(v, w, wq, p)
    return add_mod(u, x, p), sub_mod(u, x, p)


def gs_exact(u, v, w, wq, p):
    return add_mod(u, v, p), shoup_mul(sub_mod(u, v, p), w, wq, p)
