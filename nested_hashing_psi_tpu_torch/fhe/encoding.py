"""SIMD packed plaintext encoding (slot packing), host numpy.

A copy of ``nested_hashing_psi_tpu.fhe.encoding``; its numpy NTTs
(``ntt_numpy``/``intt_numpy``) are the port's ``ops/refmodel.py`` and
``slot_to_ntt_pos`` is the port's ``fhe/galois.py`` copy, both re-exported
here. tests/test_torch_host_copies.py pins ``encode``,
``to_rns`` and ``decode`` equal to the originals.

For prime t with 2n | t-1 the ring Z_t[x]/(x^n+1) fully splits: the
negacyclic NTT over Z_t is an isomorphism onto n "slots" with pointwise
add/mult. Encoding = inverse NTT of the slot vector mod t; decoding =
forward NTT. Slot order is canonical (5-power ordering).

Two execution paths:
 - t < 2**31 (e.g. 65537 for 16-bit items): vectorized numpy uint64, exact.
 - larger t (33/41/49-bit moduli): the native C++ __int128 host kernel
   (native/nhpsi_native.cpp, via the port's utils/native.py) when
   available, with an exact numpy object-array fallback.
"""

from __future__ import annotations

import numpy as np

from nested_hashing_psi_tpu_torch.fhe.galois import slot_to_ntt_pos
from nested_hashing_psi_tpu_torch.ops import primes as primes_mod
from nested_hashing_psi_tpu_torch.ops.refmodel import _bitrev, intt_numpy, ntt_numpy


def _ntt_object(a: np.ndarray, p: int, psi: int, inverse: bool) -> np.ndarray:
    """Exact NTT mod big p on object arrays (same algorithm as ntt_numpy)."""
    n = a.shape[-1]
    logn = n.bit_length() - 1
    rev = _bitrev(n)
    root = pow(psi, -1, p) if inverse else psi
    tw = np.array([pow(root, int(r), p) for r in rev], dtype=object)
    x = a.astype(object) % p
    bshape = a.shape[:-1]
    if not inverse:
        m, t = 1, n
        for _ in range(logn):
            t //= 2
            x = x.reshape(*bshape, m, 2, t)
            s = tw[m:2 * m][:, None]
            u, v = x[..., 0, :], x[..., 1, :] * s % p
            x = np.stack([(u + v) % p, (u - v) % p], axis=-2)
            m *= 2
    else:
        m, t = n, 1
        while m > 1:
            h = m // 2
            x = x.reshape(*bshape, h, 2, t)
            s = tw[h:2 * h][:, None]
            u, v = x[..., 0, :], x[..., 1, :]
            x = np.stack([(u + v) % p, (u - v) * s % p], axis=-2)
            t *= 2
            m = h
        x = x.reshape(*bshape, n) * pow(n, -1, p) % p
    return x.reshape(*bshape, n)


class PackedEncoder:
    """Slot <-> coefficient transforms mod the plaintext modulus t.

    Slot order is canonical (5-power ordering): slot j < n/2 evaluates at
    psi^(5^j), slot n/2+j at psi^(-5^j).
    """

    def __init__(self, ring_dim: int, t: int):
        assert (t - 1) % (2 * ring_dim) == 0, "t must be NTT-friendly (2n | t-1)"
        self.n = ring_dim
        self.t = t
        self.psi = primes_mod.primitive_root_of_unity(t, 2 * ring_dim)
        self.small = t < 2**31
        self._s2n = slot_to_ntt_pos(ring_dim)

    def encode(self, values) -> np.ndarray:
        """Slot values (len <= n, ints; negatives allowed) -> coeffs in [0,t).

        Accepts (..., m) arrays or lists; pads slots beyond m with zeros.
        """
        # fast path: values fit int64 and t < 2^62 -> pure uint64 numpy
        v64 = None
        if self.t < 1 << 62:
            try:
                v64 = np.asarray(values, dtype=np.int64)
            except (OverflowError, TypeError, ValueError):
                v64 = None
        if v64 is not None:
            one_d = v64.ndim == 1
            if one_d:
                v64 = v64[None, :]
            batch, m = v64.shape[0], v64.shape[-1]
            assert m <= self.n
            t = np.int64(self.t)
            slots = np.zeros((batch, self.n), dtype=np.uint64)
            slots[:, :m] = ((v64 % t) + t) % t
            eval_vec = np.zeros_like(slots)
            eval_vec[:, self._s2n] = slots
            if self.small:
                coeffs = intt_numpy(eval_vec, self.t, self.psi)
            else:
                coeffs = self._big_ntt(eval_vec, inverse=True)
            return coeffs[0] if one_d else coeffs

        v = np.asarray(values, dtype=object)
        one_d = v.ndim == 1
        if one_d:
            v = v[None, :]
        batch, m = v.shape[0], v.shape[-1]
        assert m <= self.n
        slots = np.zeros((batch, self.n), dtype=object)
        slots[:, :m] = v
        slots = slots % self.t
        eval_vec = np.zeros_like(slots)
        eval_vec[:, self._s2n] = slots
        if self.small:
            coeffs = intt_numpy(eval_vec.astype(np.uint64), self.t, self.psi)
        else:
            coeffs = self._big_ntt(eval_vec, inverse=True)
        return coeffs[0] if one_d else coeffs

    def decode(self, coeffs: np.ndarray, length: int | None = None) -> np.ndarray:
        """Coeffs in [0,t) -> slot values in [0,t) (first `length` slots)."""
        c = np.asarray(coeffs)
        one_d = c.ndim == 1
        if one_d:
            c = c[None, :]
        if self.small:
            evals = ntt_numpy(c.astype(np.uint64), self.t, self.psi)
        else:
            evals = self._big_ntt(c, inverse=False)
        slots = evals[..., self._s2n]
        if length is not None:
            slots = slots[..., :length]
        return slots[0] if one_d else slots

    def _big_ntt(self, x: np.ndarray, inverse: bool) -> np.ndarray:
        """NTT mod big t (< 2^63): native C++ (__int128) when available, else
        exact object-array arithmetic. Returns uint64 when possible."""
        from nested_hashing_psi_tpu_torch.utils import native

        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if x.dtype == object:
            x64 = np.array(
                [[int(v) for v in row] for row in x], dtype=np.uint64
            )
        else:
            x64 = x.astype(np.uint64)
        out = native.ntt_mod_t(x64, self.t, self.psi, inverse)
        if out is None:
            out = _ntt_object(x.astype(object), self.t, self.psi, inverse=inverse)
        return out.reshape(*lead, x.shape[-1])

    def centered(self, coeffs: np.ndarray) -> np.ndarray:
        """Lift [0,t) coefficients to centered representatives (object ints)."""
        c = np.asarray(coeffs, dtype=object)
        return np.where(c > self.t // 2, c - self.t, c)

    def to_rns(self, coeffs: np.ndarray, q_primes: tuple[int, ...]) -> np.ndarray:
        """Centered-lift coeffs mod t, reduce mod each q_i -> (..., L, n) uint64."""
        c = np.asarray(coeffs)
        if c.dtype != object and self.t < 1 << 62:
            # uint64 fast path: (x - t) mod p == (x mod p + p - t mod p) mod p
            c = c.astype(np.uint64)
            big = c > np.uint64(self.t // 2)
            rows = []
            for p in q_primes:
                r = c % np.uint64(p)
                r_neg = (r + np.uint64(p - self.t % p)) % np.uint64(p)
                rows.append(np.where(big, r_neg, r))
            return np.stack(rows, axis=-2)
        cc = self.centered(c)
        return np.stack([(cc % p).astype(np.uint64) for p in q_primes], axis=-2)
