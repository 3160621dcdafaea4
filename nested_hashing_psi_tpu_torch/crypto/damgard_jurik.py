"""Damgard-Jurik additively-homomorphic encryption (generalized Paillier).

The port's own copy of ``nested_hashing_psi_tpu.crypto.damgard_jurik``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_elgamal.py holds it against the original.

Capability parity with the reference's legacy additive-HE check
(reference tests/TestDamgardJurik.cpp:6-42, libscapi DamgardJurikEnc):
Enc(m) = (1+N)^m * r^(N^s) mod N^(s+1), plaintext space Z_{N^s}, additive
homomorphism by ciphertext multiplication. Host-side (python ints) -- kept
for protocol-prototype parity; the FHE track is the production path.
"""

from __future__ import annotations

import secrets

from nested_hashing_psi_tpu_torch.ops.primes import is_prime


def _random_prime(bits: int, rand) -> int:
    while True:
        cand = rand.getrandbits(bits) | (1 << (bits - 1)) | 1
        if is_prime(cand):
            return cand


class DamgardJurik:
    def __init__(self, modulus_bits: int = 1024, s: int = 1, rng=None):
        self._rand = rng or secrets.SystemRandom()
        self.s = s
        p = _random_prime(modulus_bits // 2, self._rand)
        q = _random_prime(modulus_bits // 2, self._rand)
        while q == p:
            q = _random_prime(modulus_bits // 2, self._rand)
        self.n = p * q
        self.n_s = self.n**s
        self.n_s1 = self.n ** (s + 1)
        self._lam = (p - 1) * (q - 1) // _gcd(p - 1, q - 1)  # lcm
        # d = 1 mod N^s and 0 mod lambda (CRT)
        self.d = _crt2(1, self.n_s, 0, self._lam)

    @classmethod
    def from_public(cls, n: int, s: int = 1) -> "DamgardJurik":
        """Public-key-only handle (a peer's modulus): encrypt/add/mult only;
        decrypt raises (no factorization). The reference's server side works
        exactly so (DamgardJurikEnc.setKey with only the public key)."""
        dj = cls.__new__(cls)
        dj._rand = secrets.SystemRandom()
        dj.s = s
        dj.n = n
        dj.n_s = n**s
        dj.n_s1 = n ** (s + 1)
        dj.d = None
        return dj

    def encrypt(self, m: int) -> int:
        m %= self.n_s
        r = self._rand.randrange(1, self.n)
        return (
            pow(1 + self.n, m, self.n_s1) * pow(r, self.n_s, self.n_s1)
        ) % self.n_s1

    def decrypt(self, c: int) -> int:
        """c^d = (1+N)^m mod N^(s+1); recover m with the DJ 2001 algorithm
        (binomial-expansion inversion of (1+N)^m)."""
        a = pow(c, self.d, self.n_s1)
        n = self.n
        i = 0
        for j in range(1, self.s + 1):
            nj = n**j
            t1 = (a % (nj * n) - 1) // n  # L(a mod n^{j+1})
            t2 = i
            fact = 1
            for k in range(2, j + 1):
                i -= 1
                t2 = t2 * i % nj
                fact *= k
                t1 = (t1 - t2 * n ** (k - 1) * pow(fact, -1, nj)) % nj
            i = t1
        return i % self.n_s

    def add(self, c1: int, c2: int) -> int:
        return c1 * c2 % self.n_s1

    def mult_by_const(self, c: int, k: int) -> int:
        return pow(c, k, self.n_s1)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _crt2(r1: int, m1: int, r2: int, m2: int) -> int:
    g = _gcd(m1, m2)
    assert g == 1
    return (r1 * m2 * pow(m2, -1, m1) + r2 * m1 * pow(m1, -1, m2)) % (m1 * m2)
