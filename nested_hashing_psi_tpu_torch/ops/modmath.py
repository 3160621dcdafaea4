"""Modular arithmetic on RNS residue tensors (plain PyTorch).

Counterpart of ``nested_hashing_psi_tpu.ops.modmath``. Residues are
``torch.int32`` tensors holding values in [0, p): every prime is below 2**31,
so the bits equal the JAX package's uint32 residues (torch on the CPU has no
uint32 add/shift/compare). Products widen to int64; a product of two
residues stays below 2**62 and is exact.

Every function returns the canonical residue in [0, p), so results are
bit-equal to the JAX package's whatever the internal formulation: the
reference assembles 64-bit products from 16-bit partials (a TPU workaround);
here the wide product is one int64 multiply.

Constants (p, pinv, r2, Shoup quotients) are int64 tensors shaped to
broadcast against the data, e.g. (L, 1) against (..., L, N); Python ints
work too.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def _w(x):
    return x.long() if isinstance(x, torch.Tensor) else x


def _u32(x):
    """x's uint32 value: an int32 tensor holds the JAX package's uint32 bits
    (read back as [0, 2**32)); int64 tensors and ints already hold it."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32:
        return x.long() & MASK32
    return x


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two uint32 values:
    floor(a * b / 2**32) as int64 in [0, 2**32), exact (b is split into
    16-bit halves so no partial product reaches 2**63)."""
    a, b = _u32(a), _u32(b)
    return (a * (b >> 16) + ((a * (b & MASK16)) >> 16)) >> 16


def _mullo32(a, b):
    """a * b mod 2**32 for a, b in [0, 2**32), exact in int64."""
    return (a * (b & MASK16) + (((a * (b >> 16)) & MASK16) << 16)) & MASK32


def mont_mul(a, b, p, pinv):
    """Montgomery product a*b*R^-1 mod p (R = 2**32), as REDC computes it.

    Requires a, b < p < 2**31 and pinv = -p^-1 mod 2**32. If b is in
    Montgomery form (b = x*R mod p) this returns a*x mod p.
    """
    p, pinv = _w(p), _w(pinv)
    x = _w(a) * _w(b)                      # < 2**62
    lo = x & MASK32
    m = _mullo32(lo, pinv)
    # T + m*p = 0 mod R; the low-word carry is 1 unless lo == 0
    t = (x >> 32) + ((m * p) >> 32) + (lo != 0).long()
    return torch.where(t >= p, t - p, t).int()


def shoup_mul(x, w, wq, p):
    """x*w mod p with Shoup's precomputed quotient wq = floor(w * 2**32 / p).
    Valid for any x < 2**32 and w < p < 2**31; output < p."""
    x, w, p = _w(x), _w(w), _w(p)
    q = mulhi_u32(x, _w(wq))
    r = x * w - q * p                      # exact: r in [0, 2p)
    return torch.where(r >= p, r - p, r).int()


def shoup_host(w: int, p: int) -> int:
    """Host-side Shoup companion of constant w for prime p."""
    return (w << 32) // p


def add_mod(a, b, p):
    s = _w(a) + _w(b)
    p = _w(p)
    return torch.where(s >= p, s - p, s).int()


def sub_mod(a, b, p):
    d = _w(a) - _w(b)
    return torch.where(d < 0, d + _w(p), d).int()


def neg_mod(a, p):
    a = _w(a)
    return torch.where(a == 0, a, _w(p) - a).int()


def cond_sub_mod(x, p):
    """[x]_p for x < 2p (cross-prime re-reduction of a residue of another
    31-bit prime: all primes share the top bit, so x < 2**31 < 2p)."""
    x, p = _w(x), _w(p)
    return torch.where(x >= p, x - p, x).int()


def modsum(x, p, axis=0):
    """Sum mod p along `axis` (the int64 sum of < 2**32 residues is exact)."""
    return (_w(x).sum(dim=axis) % _w(p)).int()


def to_mont(a, p, pinv, r2):
    """a -> a*R mod p, with r2 = R**2 mod p."""
    return mont_mul(a, r2, p, pinv)


def from_mont(a, p, pinv):
    """a*R mod p -> a."""
    return mont_mul(a, 1, p, pinv)


def mul_mod(a, b, p, pinv, r2):
    """Generic a*b mod p (two REDC passes). Prefer mont_mul with a
    pre-scaled constant operand in hot paths."""
    return mont_mul(a, to_mont(b, p, pinv, r2), p, pinv)


# ---------------------------------------------------------------------------
# Host-side precomputation of per-prime Montgomery constants.
# ---------------------------------------------------------------------------

def mont_constants(p: int) -> tuple[int, int]:
    """(pinv, r2) for prime p < 2**31: pinv = -p^-1 mod 2**32, r2 = 2**64 mod p."""
    assert p < 2**31
    pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    r2 = pow(2, 64, p)
    return pinv, r2


def to_mont_host(x: int, p: int) -> int:
    """Host-side Montgomery form x*R mod p (R = 2**32)."""
    return (x << 32) % p
