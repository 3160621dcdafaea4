"""Host-side number theory: NTT-friendly prime generation and CRT helpers.

A verbatim copy of ``nested_hashing_psi_tpu.ops.primes`` (that module loads
jax through its package ``__init__``; this one is pure Python). Both packages
must derive the identical prime sets, which tests/test_torch_host_copies.py
pins.

All functions here run on the host with Python ints (exact, arbitrary
precision) -- they execute once per protocol setup, never in the hot path.
"""

from __future__ import annotations

import functools


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our moduli)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(count: int, bits: int, order: int, avoid: tuple[int, ...] = ()) -> tuple[int, ...]:
    """Return `count` primes p with p = 1 (mod order), p < 2**bits, descending.

    `order` must be a power of two (2n for negacyclic NTT over ring dim n).
    Primes are found scanning downward from 2**bits so the set is
    deterministic for a given (count, bits, order).
    """
    assert order & (order - 1) == 0, "order must be a power of two"
    found: list[int] = []
    # Largest candidate of the form k*order + 1 below 2**bits. The scan must
    # stay above 2**(bits-1): device code reduces residues of one prime mod
    # another with a single conditional subtract (ops.modmath.cond_sub_mod),
    # which requires every x < 2**bits to satisfy x < 2p -- i.e. all primes
    # share the same top bit. Falling below the floor raises instead of
    # silently breaking that contract.
    floor = 2 ** (bits - 1)
    k = (2**bits - 2) // order
    while len(found) < count and k * order + 1 > floor:
        p = k * order + 1
        if p not in avoid and is_prime(p):
            found.append(p)
        k -= 1
    if len(found) < count:
        raise ValueError(
            f"not enough primes = 1 mod {order} in (2**{bits - 1}, 2**{bits})"
        )
    return tuple(found)


def find_generator(p: int) -> int:
    """Find a generator of the multiplicative group of Z_p (p prime)."""
    factors = _factorize(p - 1)
    g = 2
    while True:
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
        g += 1


def _factorize(n: int) -> list[int]:
    """Prime factors of n (small n-1 cofactors only; trial division)."""
    factors = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return factors


def primitive_root_of_unity(p: int, order: int) -> int:
    """A primitive `order`-th root of unity mod prime p (order | p-1)."""
    assert (p - 1) % order == 0
    g = find_generator(p)
    w = pow(g, (p - 1) // order, p)
    # Sanity: w has exact order `order`.
    assert pow(w, order, p) == 1
    for f in _factorize(order):
        assert pow(w, order // f, p) != 1
    return w


def crt_reconstruct(residues: list[int], moduli: list[int]) -> int:
    """CRT: the unique x in [0, prod(moduli)) with x = residues[i] mod moduli[i]."""
    q = 1
    for m in moduli:
        q *= m
    x = 0
    for r, m in zip(residues, moduli):
        qi = q // m
        x += r * qi * pow(qi, -1, m)
    return x % q


def centered(x: int, q: int) -> int:
    """Centered representative of x mod q, in (-q/2, q/2]."""
    x %= q
    return x - q if x > q // 2 else x
