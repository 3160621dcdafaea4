"""Slow-but-obvious numpy/Python reference model (host numpy, no torch).

Counterpart of ``nested_hashing_psi_tpu.ops.refmodel``: the negacyclic
numpy NTTs (which the packed encoder ``fhe/encoding.py`` and the slot map
``fhe/galois.py`` run on the host, and which define the slot order), the
O(n^2) schoolbook negacyclic product and the canonical psi, the oracles the
tests hold the device transforms against. Primes are < 2**32, so numpy
uint64 products are exact.
"""

from __future__ import annotations

import numpy as np

from nested_hashing_psi_tpu_torch.ops import primes as primes_mod


def _bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def ntt_numpy(a: np.ndarray, p: int, psi: int) -> np.ndarray:
    """Forward negacyclic NTT mod p < 2**32 (merged-twiddle Cooley-Tukey,
    natural -> bit-reversed order, as ops/ntt.py). uint64 products are exact."""
    n = a.shape[-1]
    logn = n.bit_length() - 1
    rev = _bitrev(n)
    psi_rev = np.array([pow(psi, int(r), p) for r in rev], dtype=np.uint64)
    x = a.astype(np.uint64) % p
    bshape = a.shape[:-1]
    pp = np.uint64(p)
    m, t = 1, n
    for _ in range(logn):
        t //= 2
        x = x.reshape(*bshape, m, 2, t)
        s = psi_rev[m:2 * m][:, None]
        u = x[..., 0, :]
        v = x[..., 1, :] * s % pp
        x = np.stack([(u + v) % pp, (u - v + pp) % pp], axis=-2)
        m *= 2
    return x.reshape(*a.shape)


def intt_numpy(a: np.ndarray, p: int, psi: int) -> np.ndarray:
    """Inverse of ntt_numpy (Gentleman-Sande, bit-reversed -> natural)."""
    n = a.shape[-1]
    rev = _bitrev(n)
    psi_inv = pow(psi, -1, p)
    ipsi_rev = np.array([pow(psi_inv, int(r), p) for r in rev], dtype=np.uint64)
    x = a.astype(np.uint64) % p
    bshape = a.shape[:-1]
    pp = np.uint64(p)
    m, t = n, 1
    while m > 1:
        h = m // 2
        x = x.reshape(*bshape, h, 2, t)
        s = ipsi_rev[h:2 * h][:, None]
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = np.stack([(u + v) % pp, (u - v + pp) % pp * s % pp], axis=-2)
        t *= 2
        m = h
    x = x.reshape(*a.shape)
    return x * np.uint64(pow(n, -1, p)) % pp


def negacyclic_mul_naive(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Schoolbook polynomial multiply mod (x^n + 1, p). O(n^2), tests only."""
    n = len(a)
    res = np.zeros(n, dtype=object)
    aa = [int(v) for v in a]
    bb = [int(v) for v in b]
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                res[k] += aa[i] * bb[j]
            else:
                res[k - n] -= aa[i] * bb[j]
    return np.array([int(v) % p for v in res], dtype=np.uint64)


def default_psi(p: int, n: int) -> int:
    """The canonical primitive 2n-th root of unity mod p (ops.primes)."""
    return primes_mod.primitive_root_of_unity(p, 2 * n)
