"""Lifted additively-homomorphic ElGamal on EC groups.

The port's own copy of ``nested_hashing_psi_tpu.crypto.elgamal``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_elgamal.py holds it against the original.

Capability parity with the reference's AddHomElGamalEnc
(reference src/Common/Crypto/AddHomElGamalEnc.{hpp:26-181,cpp}):
Enc(m) = (g^r, h^r * g^m); homomorphic add/sub, scalar mult, the
0/1-ciphertext xor-by-element trick, multi-exponentiation inner product,
randomized-equality gadgets (plain and fused custom variant) and the cheap
decrypts-to-zero check (c2 == x*c1, no discrete log needed). Like the
reference, rerandomization is deliberately omitted on the hot gadgets -- the
final multiplication by fresh randomness r plus the Enc(0) term blinds the
result (AddHomElGamalEnc.hpp:22-24 carries the same warning).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from nested_hashing_psi_tpu_torch.crypto.ec import EcGroup


@dataclass
class ElGamalCiphertext:
    c1: tuple | None  # EC point (affine) or None = identity
    c2: tuple | None


class AddHomElGamal:
    def __init__(self, group: EcGroup, rng=None):
        self.group = group
        self._rand = rng or secrets.SystemRandom()
        self.pk = None  # point h = x*G
        self.sk = None  # int x

    # -- keys ---------------------------------------------------------------
    def keygen(self) -> tuple:
        x = self._rand.randrange(1, self.group.order)
        self.sk = x
        self.pk = self.group.mul_gen(x)
        return self.pk, x

    def set_public_key(self, pk) -> None:
        self.pk = pk

    # -- encryption ---------------------------------------------------------
    def encrypt(self, m: int) -> ElGamalCiphertext:
        """Enc(m) = (r*G, r*pk + m*G); m any integer (mod group order)."""
        r = self._rand.randrange(1, self.group.order)
        c1 = self.group.mul_gen(r)
        c2 = self.group.add(self.group.mul(self.pk, r), self.group.mul_gen(m))
        return ElGamalCiphertext(c1, c2)

    def encrypt_zero(self) -> ElGamalCiphertext:
        r = self._rand.randrange(1, self.group.order)
        return ElGamalCiphertext(self.group.mul_gen(r), self.group.mul(self.pk, r))

    # -- batched entry points (amortize the native backend across protocol
    #    loops; every one falls back to the scalar form automatically) ------
    def _has_batch(self) -> bool:
        return hasattr(self.group, "mul_gen_batch")

    def encrypt_batch(self, msgs) -> list[ElGamalCiphertext]:
        """[Enc(m) for m in msgs] -- three native batch calls total instead
        of 3*len(msgs) scalar multiplications in Python."""
        if not self._has_batch():
            return [self.encrypt(m) for m in msgs]
        g = self.group
        rs = [self._rand.randrange(1, g.order) for _ in msgs]
        c1s = g.mul_gen_batch(rs)
        hr = g.mul_many(self.pk, rs)
        gm = g.mul_gen_batch(list(msgs))
        pairs = [pt for ab in zip(hr, gm) for pt in ab]
        c2s = g.sum_groups(pairs, len(msgs), 2)
        return [ElGamalCiphertext(a, b) for a, b in zip(c1s, c2s)]

    def encrypt_zero_batch(self, count: int) -> list[ElGamalCiphertext]:
        if not self._has_batch():
            return [self.encrypt_zero() for _ in range(count)]
        g = self.group
        rs = [self._rand.randrange(1, g.order) for _ in range(count)]
        c1s = g.mul_gen_batch(rs)
        c2s = g.mul_many(self.pk, rs)
        return [ElGamalCiphertext(a, b) for a, b in zip(c1s, c2s)]

    def randomized_equality_batch(
        self, minus_elem, others, enc_zeros
    ) -> list[ElGamalCiphertext]:
        """[r_i * (minus_elem + others[i] + enc_zeros[i])] with fresh r_i --
        the batched form of randomized_equality for one PIE's result list."""
        if not self._has_batch():
            return [
                self.randomized_equality(minus_elem, o, z)
                for o, z in zip(others, enc_zeros)
            ]
        g = self.group
        n = len(others)
        tri1, tri2 = [], []
        for o, z in zip(others, enc_zeros):
            tri1 += [minus_elem.c1, o.c1, z.c1]
            tri2 += [minus_elem.c2, o.c2, z.c2]
        t1 = g.sum_groups(tri1, n, 3)
        t2 = g.sum_groups(tri2, n, 3)
        rs = [self._rand.randrange(1, g.order) for _ in range(n)]
        out1 = g.mul_batch(t1, rs)
        out2 = g.mul_batch(t2, rs)
        return [ElGamalCiphertext(a, b) for a, b in zip(out1, out2)]

    def decrypts_to_zero_batch(self, cts) -> list[bool]:
        assert self.sk is not None, "private key not set"
        if not self._has_batch():
            return [self.decrypts_to_zero(c) for c in cts]
        xs = self.group.mul_batch([c.c1 for c in cts], [self.sk] * len(cts))
        return [c.c2 == x for c, x in zip(cts, xs)]

    # -- homomorphic ops ----------------------------------------------------
    def add(self, a: ElGamalCiphertext, b: ElGamalCiphertext) -> ElGamalCiphertext:
        g = self.group
        return ElGamalCiphertext(g.add(a.c1, b.c1), g.add(a.c2, b.c2))

    def subtract(self, a: ElGamalCiphertext, b: ElGamalCiphertext) -> ElGamalCiphertext:
        g = self.group
        return ElGamalCiphertext(
            g.add(a.c1, g.neg(b.c1)), g.add(a.c2, g.neg(b.c2))
        )

    def mult_by_const(self, a: ElGamalCiphertext, k: int) -> ElGamalCiphertext:
        g = self.group
        return ElGamalCiphertext(g.mul(a.c1, k), g.mul(a.c2, k))

    def mult_by_const_many(
        self, a: ElGamalCiphertext, ks
    ) -> list[ElGamalCiphertext]:
        """[Enc(k*m) for k in ks] sharing one window table per component --
        the repeated-base exponentiation of the Precomp offline phase
        (reference exponentiateWithPreComputedValues)."""
        g = self.group
        if hasattr(g, "mul_many"):
            c1s = g.mul_many(a.c1, ks)
            c2s = g.mul_many(a.c2, ks)
            return [ElGamalCiphertext(u, v) for u, v in zip(c1s, c2s)]
        return [self.mult_by_const(a, k) for k in ks]

    def element_xor_by_const(self, a: ElGamalCiphertext, elem: int) -> ElGamalCiphertext:
        """Enc(b*elem) -> Enc((1-b)*elem) for b in {0,1}: negate and add
        g^elem (AddHomElGamalEnc.cpp:458-494)."""
        g = self.group
        return ElGamalCiphertext(
            g.neg(a.c1), g.add(g.neg(a.c2), g.mul_gen(elem))
        )

    def xor_by_const(self, a: ElGamalCiphertext, bit: bool) -> ElGamalCiphertext:
        """Enc(b) -> Enc(b xor bit) for bit plaintexts."""
        if not bit:
            return ElGamalCiphertext(a.c1, a.c2)
        g = self.group
        return ElGamalCiphertext(g.neg(a.c1), g.add(g.neg(a.c2), g.mul_gen(1)))

    def homomorphic_inner_product(
        self, cts: list[ElGamalCiphertext], scalars: list[int]
    ) -> ElGamalCiphertext:
        """Enc(sum_i scalars[i] * m_i) via simultaneous multi-exponentiation
        (AddHomElGamalEnc.cpp:545-566)."""
        g = self.group
        u = g.multi_mul([c.c1 for c in cts], scalars)
        v = g.multi_mul([c.c2 for c in cts], scalars)
        return ElGamalCiphertext(u, v)

    def randomized_equality(
        self,
        minus_elem: ElGamalCiphertext,
        other,
        enc_zero: ElGamalCiphertext,
    ) -> ElGamalCiphertext:
        """r * (minus_elem + other + Enc(0)); `other` is a ciphertext or a
        plain integer (stash path) (AddHomElGamalEnc.cpp:568-600)."""
        if isinstance(other, int):
            g = self.group
            r = self._rand.randrange(1, self.group.order)
            v = g.add(g.mul_gen(other), minus_elem.c2)
            return ElGamalCiphertext(
                g.mul(minus_elem.c1, r), g.mul(v, r)
            )
        ct = self.add(self.add(minus_elem, other), enc_zero)
        r = self._rand.randrange(1, self.group.order)
        return self.mult_by_const(ct, r)

    def indexed_randomized_equality(
        self,
        index_cts: list[ElGamalCiphertext],
        table_values: list[int],
        minus_elem: ElGamalCiphertext,
        enc_zero: ElGamalCiphertext,
    ) -> ElGamalCiphertext:
        ip = self.homomorphic_inner_product(index_cts, table_values)
        return self.randomized_equality(minus_elem, ip, enc_zero)

    def custom_indexed_randomized_equality(
        self,
        index_cts: list[ElGamalCiphertext],
        table_values: list[int],
        minus_elem: ElGamalCiphertext,
        enc_zero: ElGamalCiphertext,
        randomness: int,
    ) -> ElGamalCiphertext:
        """Fused variant: one multi-exp including the mask exponent and the
        Enc(0) blinding (AddHomElGamalEnc.cpp:602-637). Assumes table_values
        were pre-multiplied by `randomness` (ElGamalPIE precalc path)."""
        cts = list(index_cts) + [minus_elem, enc_zero]
        scalars = list(table_values) + [randomness, 1]
        return self.homomorphic_inner_product(cts, scalars)

    # -- decryption ---------------------------------------------------------
    def decrypts_to_zero(self, ct: ElGamalCiphertext) -> bool:
        """m = 0 iff c2 == x * c1 (AddHomElGamalEnc.cpp:639-650)."""
        assert self.sk is not None, "private key not set"
        return ct.c2 == self.group.mul(ct.c1, self.sk)

    def decrypt_element(self, ct: ElGamalCiphertext):
        """Returns g^m (lifted; no discrete log), like the reference decrypt."""
        assert self.sk is not None
        g = self.group
        return g.add(ct.c2, g.neg(g.mul(ct.c1, self.sk)))

    # -- serialization ------------------------------------------------------
    def ct_to_bytes(self, ct: ElGamalCiphertext) -> bytes:
        g = self.group
        return g.to_bytes(ct.c1) + g.to_bytes(ct.c2)

    def ct_from_bytes(self, data: bytes) -> ElGamalCiphertext:
        g = self.group
        k = g.nbytes + 1
        return ElGamalCiphertext(g.from_bytes(data[:k]), g.from_bytes(data[k:]))

    def cts_from_bytes(self, data: bytes, count: int) -> list[ElGamalCiphertext]:
        """Deserialize `count` concatenated ciphertexts with ONE batched
        point-decompression call (the wire-receive hot path; see
        EcGroup.points_from_bytes)."""
        pts = self.group.points_from_bytes(data, 2 * count)
        return [
            ElGamalCiphertext(pts[2 * i], pts[2 * i + 1]) for i in range(count)
        ]

    def point_to_bytes(self, pt) -> bytes:
        return self.group.to_bytes(pt)

    def point_from_bytes(self, data: bytes):
        return self.group.from_bytes(data)
