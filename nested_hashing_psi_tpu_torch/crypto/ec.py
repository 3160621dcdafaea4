"""Prime-field NIST elliptic curves (P-192/224/256/384/521), pure Python.

The port's own copy of ``nested_hashing_psi_tpu.crypto.ec``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_ec.py holds it against the original.

Replaces the reference's libscapi OpenSSLDlogECFp
(reference src/Client/ElGamal/ElGamalPSIClient.hpp:40-52 selects the
curve by name). Binary-field curves (B-*/K-*) live in crypto/ec2m.py; use
ec_group() to dispatch by name exactly like the reference's
ElGamalPSIServer.hpp:32-44 P/B/K switch.

Jacobian-coordinate arithmetic with a fixed-base window table for the
generator. Host-side by design (SURVEY section 2.2), in both packages: the
port's GPU kernels serve the FHE path, and no kernel runs here.
"""

from __future__ import annotations

from dataclasses import dataclass

# name: (p, a, b, gx, gy, order)
CURVES = {
    "P-192": (
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFFFFFFFFFFFF,
        -3,
        0x64210519E59C80E70FA7E9AB72243049FEB8DEECC146B9B1,
        0x188DA80EB03090F67CBF20EB43A18800F4FF0AFD82FF1012,
        0x07192B95FFC8DA78631011ED6B24CDD573F977A11E794811,
        0xFFFFFFFFFFFFFFFFFFFFFFFF99DEF836146BC9B1B4D22831,
    ),
    "P-224": (
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF000000000000000000000001,
        -3,
        0xB4050A850C04B3ABF54132565044B0B7D7BFD8BA270B39432355FFB4,
        0xB70E0CBD6BB4BF7F321390B94A03C1D356C21122343280D6115C1D21,
        0xBD376388B5F723FB4C22DFE6CD4375A05A07476444D5819985007E34,
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFF16A2E0B8F03E13DD29455C5C2A3D,
    ),
    "P-256": (
        0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
        -3,
        0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
        0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    ),
    "P-384": (
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFFFF0000000000000000FFFFFFFF,
        -3,
        0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF,
        0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7,
        0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F,
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973,
    ),
    "P-521": (
        (1 << 521) - 1,
        -3,
        0x051953EB9618E1C9A1F929A21A0B68540EEA2DA725B99B315F3B8B489918EF109E156193951EC7E937B1652C0BD3BB1BF073573DF883D2C34F1EF451FD46B503F00,
        0x00C6858E06B70404E9CD9E3ECB662395B4429C648139053FB521F828AF606B4D3DBAA14B5E77EFE75928FE1DC127A2FFA8DE3348B3C1856A429BF97E7E31C2E5BD66,
        0x011839296A789A3BC0045C8A5FB42C7D1BD998F54449579B446817AFBD17273E662C97EE72995EF42640C550B9013FAD0761353C7086A272C24088BE94769FD16650,
        0x1FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFA51868783BF2F966B7FCC0148F709A5D03BB5C9B8899C47AEBB6FB71E91386409,
    ),
}

INFINITY = None  # affine point at infinity


class EcGroup:
    def __init__(self, name: str = "P-256"):
        if name not in CURVES:
            raise ValueError(f"unknown curve {name}")
        self.name = name
        self.p, a, self.b, gx, gy, self.order = CURVES[name]
        self.a = a % self.p
        self.g = (gx, gy)
        # native batch backend (native/nhpsi_ec.cpp): same group law, same
        # affine results, ~50x a Python bigint scalar mult; None -> pure
        # Python (templated limb widths cover every tabled prime curve)
        from nested_hashing_psi_tpu_torch.utils import native_ec

        self._native = native_ec.for_curve(self.p, self.a)
        # fixed-base window table: g^(j * 16^i) for j in [0,16)
        self._g_table = None if self._native else self._build_fixed_base_table(self.g)

    # -- Jacobian arithmetic ------------------------------------------------
    def _jac_double(self, P):
        if P is None:
            return None
        X1, Y1, Z1 = P
        p = self.p
        if Y1 == 0:
            return None
        XX = X1 * X1 % p
        YY = Y1 * Y1 % p
        YYYY = YY * YY % p
        ZZ = Z1 * Z1 % p
        S = 2 * ((X1 + YY) ** 2 - XX - YYYY) % p
        M = (3 * XX + self.a * ZZ % p * ZZ) % p
        T = (M * M - 2 * S) % p
        Y3 = (M * (S - T) - 8 * YYYY) % p
        Z3 = ((Y1 + Z1) ** 2 - YY - ZZ) % p
        return (T, Y3, Z3)

    def _jac_add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        p = self.p
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 % p * Z2Z2 % p
        S2 = Y2 * Z1 % p * Z1Z1 % p
        if U1 == U2:
            if S1 != S2:
                return None
            return self._jac_double(P)
        H = (U2 - U1) % p
        I = 4 * H * H % p
        J = H * I % p
        r = 2 * (S2 - S1) % p
        V = U1 * I % p
        X3 = (r * r - J - 2 * V) % p
        Y3 = (r * (V - X3) - 2 * S1 * J) % p
        Z3 = ((Z1 + Z2) ** 2 - Z1Z1 - Z2Z2) % p * H % p
        return (X3, Y3, Z3)

    def _to_jac(self, A):
        if A is None:
            return None
        return (A[0], A[1], 1)

    def _from_jac(self, P):
        if P is None:
            return None
        X, Y, Z = P
        p = self.p
        zi = pow(Z, -1, p)
        zi2 = zi * zi % p
        return (X * zi2 % p, Y * zi2 % p * zi % p)

    # -- group API ----------------------------------------------------------
    def add(self, A, B):
        return self._from_jac(self._jac_add(self._to_jac(A), self._to_jac(B)))

    def neg(self, A):
        if A is None:
            return None
        return (A[0], (-A[1]) % self.p)

    @staticmethod
    def _jac_neg(P):
        if P is None:
            return None
        return (P[0], -P[1], P[2])

    @staticmethod
    def _wnaf(k: int, w: int) -> list[int]:
        """Width-w non-adjacent form, little-endian digits in
        {0, +-1, +-3, ..., +-(2^(w-1)-1)}; at most 1 nonzero per w digits."""
        out = []
        while k:
            if k & 1:
                d = k & ((1 << w) - 1)
                if d >= 1 << (w - 1):
                    d -= 1 << w
                k -= d
                out.append(d)
            else:
                out.append(0)
            k >>= 1
        return out

    def _odd_table(self, P_jac, w: int):
        """[1P, 3P, 5P, ..., (2^(w-1)-1)P] in Jacobian coordinates."""
        tbl = [P_jac]
        twoP = self._jac_double(P_jac)
        for _ in range(1, 1 << (w - 2)):
            tbl.append(self._jac_add(tbl[-1], twoP))
        return tbl

    def mul(self, A, k: int):
        """Scalar multiplication k*A: width-5 wNAF (~n doubles + n/6 adds;
        replaces the double-and-add of libscapi's exponentiate)."""
        k %= self.order
        if k == 0 or A is None:
            return None
        if self._native:
            return self._native.mul_batch([A], [k], shared=True)[0]
        tbl = self._odd_table(self._to_jac(A), 5)
        return self._from_jac(self._wnaf_mul(tbl, k, 5))

    def mul_batch(self, points, scalars):
        """[k_i * A_i] pairwise, one native call when available."""
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch(points, ks, shared=False)
        return [self.mul(A, k) for A, k in zip(points, ks)]

    def _wnaf_mul(self, odd_tbl, k: int, w: int):
        R = None
        for d in reversed(self._wnaf(k, w)):
            R = self._jac_double(R)
            if d > 0:
                R = self._jac_add(R, odd_tbl[(d - 1) // 2])
            elif d < 0:
                R = self._jac_add(R, self._jac_neg(odd_tbl[(-d - 1) // 2]))
        return R

    def mul_many(self, A, scalars):
        """[k*A for k in scalars] sharing one wNAF table for the base --
        the repeated-base pattern of the Precomp offline phase (reference
        exponentiateWithPreComputedValues, AddHomElGamalEnc.hpp usage)."""
        if A is None:
            return [None] * len(scalars)
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch([A], ks, shared=True)
        tbl = self._odd_table(self._to_jac(A), 5)
        return [
            None if k == 0 else self._from_jac(self._wnaf_mul(tbl, k, 5))
            for k in ks
        ]

    def _build_fixed_base_table(self, base):
        nwin = (self.order.bit_length() + 3) // 4
        table = []
        cur = self._to_jac(base)
        for _ in range(nwin):
            row = [None]
            acc = None
            for _ in range(15):
                acc = self._jac_add(acc, cur)
                row.append(acc)
            table.append(row)
            for _ in range(4):
                cur = self._jac_double(cur)
        return table

    def mul_gen(self, k: int):
        """Fixed-base scalar multiplication k*G (windowed, 4-bit)."""
        k %= self.order
        if k == 0:
            return None
        if self._native:
            return self._native.mul_batch([self.g], [k], shared=True)[0]
        R = None
        i = 0
        while k:
            d = k & 0xF
            if d:
                R = self._jac_add(R, self._g_table[i][d])
            k >>= 4
            i += 1
        return self._from_jac(R)

    def mul_gen_batch(self, scalars):
        """[k*G for k in scalars], one native call when available."""
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch([self.g], ks, shared=True)
        return [self.mul_gen(k) for k in ks]

    def multi_mul(self, points, scalars):
        """Simultaneous multi-exponentiation: sum_i scalars[i]*points[i]
        (interleaved width-4 wNAF: shared doubles, ~n/5 adds per point;
        replaces libscapi simultaneousMultipleExponentiations)."""
        if self._native:
            k = len(points)
            return self._native.multi_mul_groups(
                list(points), [s % self.order for s in scalars], 1, k
            )[0]
        w = 4
        pairs = [
            (self._odd_table(self._to_jac(P), w), self._wnaf(s % self.order, w))
            for P, s in zip(points, scalars)
            if P is not None and s % self.order != 0
        ]
        if not pairs:
            return None
        nbits = max(len(naf) for _, naf in pairs)
        R = None
        for bit in range(nbits - 1, -1, -1):
            R = self._jac_double(R)
            for tbl, naf in pairs:
                d = naf[bit] if bit < len(naf) else 0
                if d > 0:
                    R = self._jac_add(R, tbl[(d - 1) // 2])
                elif d < 0:
                    R = self._jac_add(R, self._jac_neg(tbl[(-d - 1) // 2]))
        return self._from_jac(R)

    def multi_mul_groups(self, points, scalars, n_groups: int, k: int):
        """n_groups simultaneous multi-exps of k pairs each (flat inputs of
        length n_groups*k); one native call when available."""
        ks = [s % self.order for s in scalars]
        if self._native:
            return self._native.multi_mul_groups(list(points), ks, n_groups, k)
        return [
            self.multi_mul(points[g * k : (g + 1) * k], ks[g * k : (g + 1) * k])
            for g in range(n_groups)
        ]

    def sum_groups(self, points, n_groups: int, k: int):
        """n_groups sums of k points each (flat input)."""
        if self._native:
            return self._native.sum_groups(list(points), n_groups, k)
        out = []
        for g in range(n_groups):
            acc = None
            for pt in points[g * k : (g + 1) * k]:
                acc = self.add(acc, pt)
            out.append(acc)
        return out

    # -- serialization ------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return (self.p.bit_length() + 7) // 8

    def to_bytes(self, A) -> bytes:
        if A is None:
            return b"\x00" * (self.nbytes + 1)
        prefix = 2 | (A[1] & 1)
        return bytes([prefix]) + A[0].to_bytes(self.nbytes, "big")

    def from_bytes(self, data: bytes):
        if data[0] == 0:
            return None
        x = int.from_bytes(data[1:], "big")
        rhs = (x * x % self.p * x + self.a * x + self.b) % self.p
        y = _sqrt_mod(rhs, self.p)
        if y is None:
            raise ValueError("invalid point encoding")
        if (y & 1) != (data[0] & 1):
            y = self.p - y
        return (x, y)

    def points_from_bytes(self, data: bytes, count: int) -> list:
        """Deserialize `count` concatenated SEC1-compressed points.

        The wire-receive hot path: decompression (one modexp per point) runs
        as ONE native batch call when the backend is available and
        p = 3 (mod 4) (P-192/256, not P-224); otherwise falls back to the
        per-point Python path. Point-for-point identical to from_bytes."""
        k = self.nbytes + 1
        assert len(data) == count * k, (len(data), count, k)
        if self._native is None or self.p % 4 != 3 or count < 4:
            return [
                self.from_bytes(data[i * k : (i + 1) * k]) for i in range(count)
            ]
        import numpy as np

        arr = np.frombuffer(data, np.uint8).reshape(count, k)
        prefixes = arr[:, 0]
        inf = prefixes == 0
        nlb = self._native.nl * 8  # limb width follows the curve
        buf = np.zeros((count, nlb), np.uint8)
        buf[:, nlb - self.nbytes :] = arr[:, 1:]
        xs = np.ascontiguousarray(buf[:, ::-1]).view(np.uint64)  # LE limbs
        ys, ok = self._native.decompress_batch(self.b, xs, prefixes & 1)
        if not (ok | inf).all():
            raise ValueError("invalid point encoding")
        out = []
        for i in range(count):
            if inf[i]:
                out.append(None)
            else:
                out.append(
                    (
                        int.from_bytes(xs[i].tobytes(), "little"),
                        int.from_bytes(ys[i].tobytes(), "little"),
                    )
                )
        return out

    def is_on_curve(self, A) -> bool:
        if A is None:
            return True
        x, y = A
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0


def ec_group(name: str):
    """Curve dispatch by name: P-* -> prime field, B-*/K-* -> GF(2^m).

    Mirrors reference src/Server/ElGamal/ElGamalPSIServer.hpp:32-44
    (OpenSSLDlogECFp vs OpenSSLDlogECF2m by the curve name's first letter).
    """
    if name and name[0] in ("B", "K"):
        from nested_hashing_psi_tpu_torch.crypto.ec2m import BinaryEcGroup

        return BinaryEcGroup(name)
    return EcGroup(name)


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks square root mod odd prime p."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        # one modexp + a verifying square beats the Euler pre-check
        y = pow(a, (p + 1) // 4, p)
        return y if y * y % p == a else None
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r
