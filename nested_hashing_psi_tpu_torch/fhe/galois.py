"""Galois/slot structure of Z_t[x]/(x^n+1) for fully-splitting prime t.

The port's own copy of ``nested_hashing_psi_tpu.fhe.galois`` (host numpy,
no device code); tests/test_torch_host_copies.py pins every function equal
to the original.

Background: the odd exponent group Z_{2n}^* = <5> x <-1>; slots are indexed
(j < n/2: exponent 5^j; j >= n/2: exponent -5^(j-n/2)). The automorphism
sigma_k: x -> x^k permutes evaluation points e -> e*k, which is:
 - k = 5^r:    left-rotation by r within each half-ring,
 - k = 2n-1:   swap of the two halves (conjugation).

Ciphertexts stay in NTT (evaluation) order, so sigma_k on a ciphertext is a
gather along the coefficient axis (identical for every limb) followed by a
key switch. The mapping between NTT output positions and exponents depends
only on the butterfly structure, so it is computed once per ring dim with a
small helper prime.
"""

from __future__ import annotations

import functools

import numpy as np

from nested_hashing_psi_tpu_torch.ops import primes as primes_mod
from nested_hashing_psi_tpu_torch.ops.refmodel import ntt_numpy


@functools.lru_cache(maxsize=None)
def ntt_exponent_map(n: int) -> tuple[np.ndarray, dict[int, int]]:
    """(E, pos_of_exp): E[pos] = odd exponent e with NTT-output position pos
    evaluating at psi^e; pos_of_exp its inverse."""
    p0 = primes_mod.ntt_primes(1, 31, 2 * n)[0]
    psi0 = primes_mod.primitive_root_of_unity(p0, 2 * n)
    mono = np.zeros(n, dtype=np.uint64)
    mono[1] = 1  # the polynomial x
    out = ntt_numpy(mono, p0, psi0)
    dlog = {}
    v = psi0
    for e in range(1, 2 * n, 2):
        dlog[v] = e
        v = v * psi0 % p0
        v = v * psi0 % p0
    E = np.array([dlog[int(x)] for x in out], dtype=np.int64)
    pos_of_exp = {int(e): i for i, e in enumerate(E)}
    return E, pos_of_exp


@functools.lru_cache(maxsize=None)
def slot_exponents(n: int) -> np.ndarray:
    """slot j -> exponent (5^j for j < n/2; 2n - 5^(j-n/2) otherwise)."""
    half = n // 2
    exps = np.zeros(n, dtype=np.int64)
    e = 1
    for j in range(half):
        exps[j] = e
        exps[half + j] = 2 * n - e
        e = e * 5 % (2 * n)
    return exps


@functools.lru_cache(maxsize=None)
def slot_to_ntt_pos(n: int) -> np.ndarray:
    """slot j -> NTT output position evaluating at the slot's exponent."""
    E, pos_of_exp = ntt_exponent_map(n)
    exps = slot_exponents(n)
    return np.array([pos_of_exp[int(e)] for e in exps], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def automorphism_ntt_perm(n: int, k: int) -> np.ndarray:
    """Gather indices applying sigma_k in NTT (evaluation) order:
    new_vals[pos] = old_vals[perm[pos]] with E(perm[pos]) = E(pos)*k mod 2n."""
    assert k % 2 == 1
    E, pos_of_exp = ntt_exponent_map(n)
    return np.array(
        [pos_of_exp[int(e * k % (2 * n))] for e in E], dtype=np.int32
    )


def rotation_galois_element(n: int, r: int) -> int:
    """Galois element for left-rotation by r slots within each half-ring."""
    return pow(5, r % (n // 2), 2 * n)


def conjugation_galois_element(n: int) -> int:
    return 2 * n - 1
