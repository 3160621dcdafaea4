"""Binary-field NIST elliptic curves (B-163..571, K-163..571), pure Python.

The port's own copy of ``nested_hashing_psi_tpu.crypto.ec2m``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_ec.py holds it against the original.

Completes the curve-selection parity with the reference's libscapi
OpenSSLDlogECF2m path (reference src/Server/ElGamal/ElGamalPSIServer.hpp:38-41
routes curve names starting with 'B' or 'K' to the binary-field backend).

Curves are y^2 + xy = x^3 + a*x^2 + b over GF(2^m) with the NIST reduction
trinomials/pentanomials. Field elements are Python ints (bit i = coefficient
of x^i); multiplication is a 4-bit-window carry-less product followed by
sparse reduction. Host-side by design, same as the prime-field backend
(crypto/ec.py): no GPU kernel runs here.

Same public API as EcGroup: add/neg/mul/mul_gen/multi_mul, SEC1-style
compressed (de)serialization, is_on_curve, order.
"""

from __future__ import annotations

# name: (m, reduction exponents below m, a, b, gx, gy, order)
# Reduction polynomial is x^m + sum(x^e for e in red_exps); NIST FIPS 186-4.
BINARY_CURVES = {
    "K-163": (
        163, (7, 6, 3, 0), 1, 1,
        0x2FE13C0537BBC11ACAA07D793DE4E6D5E5C94EEE8,
        0x289070FB05D38FF58321F2E800536D538CCDAA3D9,
        0x4000000000000000000020108A2E0CC0D99F8A5EF,
    ),
    "B-163": (
        163, (7, 6, 3, 0), 1,
        0x20A601907B8C953CA1481EB10512F78744A3205FD,
        0x3F0EBA16286A2D57EA0991168D4994637E8343E36,
        0x0D51FBC6C71A0094FA2CDD545B11C5C0C797324F1,
        0x40000000000000000000292FE77E70C12A4234C33,
    ),
    "K-233": (
        233, (74, 0), 0, 1,
        0x17232BA853A7E731AF129F22FF4149563A419C26BF50A4C9D6EEFAD6126,
        0x1DB537DECE819B7F70F555A67C427A8CD9BF18AEB9B56E0C11056FAE6A3,
        0x8000000000000000000000000000069D5BB915BCD46EFB1AD5F173ABDF,
    ),
    "B-233": (
        233, (74, 0), 1,
        0x066647EDE6C332C7F8C0923BB58213B333B20E9CE4281FE115F7D8F90AD,
        0x0FAC9DFCBAC8313BB2139F1BB755FEF65BC391F8B36F8F8EB7371FD558B,
        0x1006A08A41903350678E58528BEBF8A0BEFF867A7CA36716F7E01F81052,
        0x1000000000000000000000000000013E974E72F8A6922031D2603CFE0D7,
    ),
    "K-283": (
        283, (12, 7, 5, 0), 0, 1,
        0x503213F78CA44883F1A3B8162F188E553CD265F23C1567A16876913B0C2AC2458492836,
        0x1CCDA380F1C9E318D90F95D07E5426FE87E45C0E8184698E45962364E34116177DD2259,
        0x1FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFE9AE2ED07577265DFF7F94451E061E163C61,
    ),
    "B-283": (
        283, (12, 7, 5, 0), 1,
        0x27B680AC8B8596DA5A4AF8A19A0303FCA97FD7645309FA2A581485AF6263E313B79A2F5,
        0x5F939258DB7DD90E1934F8C70B0DFEC2EED25B8557EAC9C80E2E198F8CDBECD86B12053,
        0x3676854FE24141CB98FE6D4B20D02B4516FF702350EDDB0826779C813F0DF45BE8112F4,
        0x3FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEF90399660FC938A90165B042A7CEFADB307,
    ),
    "K-409": (
        409, (87, 0), 0, 1,
        0x060F05F658F49C1AD3AB1890F7184210EFD0987E307C84C27ACCFB8F9F67CC2C460189EB5AAAA62EE222EB1B35540CFE9023746,
        0x1E369050B7C4E42ACBA1DACBF04299C3460782F918EA427E6325165E9EA10E3DA5F6C42E9C55215AA9CA27A5863EC48D8E0286B,
        0x7FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFE5F83B2D4EA20400EC4557D5ED3E3E7CA5B4B5C83B8E01E5FCF,
    ),
    "B-409": (
        409, (87, 0), 1,
        0x021A5C2C8EE9FEB5C4B9A753B7B476B7FD6422EF1F3DD674761FA99D6AC27C8A9A197B272822F6CD57A55AA4F50AE317B13545F,
        0x15D4860D088DDB3496B0C6064756260441CDE4AF1771D4DB01FFE5B34E59703DC255A868A1180515603AEAB60794E54BB7996A7,
        0x061B1CFAB6BE5F32BBFA78324ED106A7636B9C5A7BD198D0158AA4F5488D08F38514F1FDF4B4F40D2181B3681C364BA0273C706,
        0x10000000000000000000000000000000000000000000000000001E2AAD6A612F33307BE5FA47C3C9E052F838164CD37D9A21173,
    ),
    "K-571": (
        571, (10, 5, 2, 0), 0, 1,
        0x26EB7A859923FBC82189631F8103FE4AC9CA2970012D5D46024804801841CA44370958493B205E647DA304DB4CEB08CBBD1BA39494776FB988B47174DCA88C7E2945283A01C8972,
        0x349DC807F4FBF374F4AEADE3BCA95314DD58CEC9F307A54FFC61EFC006D8A2C9D4979C0AC44AEA74FBEBBB9F772AEDCB620B01A7BA7AF1B320430C8591984F601CD4C143EF1C7A3,
        0x20000000000000000000000000000000000000000000000000000000000000000000000131850E1F19A63E4B391A8DB917F4138B630D84BE5D639381E91DEB45CFE778F637C1001,
    ),
    "B-571": (
        571, (10, 5, 2, 0), 1,
        0x2F40E7E2221F295DE297117B7F3D62F5C6A97FFCB8CEFF1CD6BA8CE4A9A18AD84FFABBD8EFA59332BE7AD6756A66E294AFD185A78FF12AA520E4DE739BACA0C7FFEFF7F2955727A,
        0x303001D34B856296C16C0D40D3CD7750A93D1D2955FA80AA5F40FC8DB7B2ABDBDE53950F4C0D293CDD711A35B67FB1499AE60038614F1394ABFA3B4C850D927E1E7769C8EEC2D19,
        0x37BF27342DA639B6DCCFFFEB73D69D78C6C27A6009CBBCA1980F8533921E8A684423E43BAB08A576291AF8F461BB2A8B3531D2F0485C19B16E2F1516E23DD3C1A4827AF1B8AC15B,
        0x3FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFE661CE18FF55987308059B186823851EC7DD9CA1161DE93D5174D66E8382E9BB2FE84E47,
    ),
}


class BinaryEcGroup:
    """EC group over GF(2^m); affine coordinates, API-compatible with EcGroup."""

    def __init__(self, name: str):
        if name not in BINARY_CURVES:
            raise ValueError(f"unknown binary curve {name}")
        self.name = name
        m, red, a, b, gx, gy, order = BINARY_CURVES[name]
        self.m = m
        self._red = red
        self._fmask = (1 << m) - 1
        self._fpoly = (1 << m) | sum(1 << e for e in red)  # full modulus poly
        self.a, self.b = a, b
        self.g = (gx, gy)
        self.order = order
        if not self.is_on_curve(self.g):
            raise ValueError(f"{name}: generator not on curve")
        # native PCLMUL batch backend (native/nhpsi_ec2m.cpp): same affine
        # group law, identical results; None -> pure Python
        from nested_hashing_psi_tpu_torch.utils import native_ec2m

        self._native = native_ec2m.for_curve(m, red, self.a, self.b)
        self._g_table = (
            None if self._native else self._build_fixed_base_table(self.g)
        )

    # -- GF(2^m) field arithmetic --------------------------------------------
    def _freduce(self, v: int) -> int:
        m = self.m
        while True:
            hi = v >> m
            if not hi:
                return v
            v &= self._fmask
            for e in self._red:
                v ^= hi << e

    def _fmul(self, x: int, y: int) -> int:
        # 4-bit-window carry-less multiply: tab[i] = clmul(x, i)
        tab = [0, x]
        for i in range(2, 16):
            tab.append((tab[i >> 1] << 1) ^ tab[i & 1])
        r = 0
        for shift in range((y.bit_length() + 3) & ~3, -4, -4):
            r = (r << 4) ^ tab[(y >> shift) & 15]
        return self._freduce(r)

    def _fsq(self, x: int) -> int:
        return self._fmul(x, x)

    def _finv(self, x: int) -> int:
        # binary extended Euclid over GF(2)[x]
        u, v = x, self._fpoly
        g1, g2 = 1, 0
        while u != 1:
            j = u.bit_length() - v.bit_length()
            if j < 0:
                u, v, g1, g2 = v, u, g2, g1
                j = -j
            u ^= v << j
            g1 ^= g2 << j
        return self._freduce(g1)

    def _fsqrt(self, x: int) -> int:
        # sqrt(x) = x^(2^(m-1))
        for _ in range(self.m - 1):
            x = self._fsq(x)
        return x

    def _half_trace(self, c: int) -> int:
        # solves z^2 + z = c for odd m (requires Tr(c) = 0)
        z = c
        for _ in range((self.m - 1) // 2):
            c = self._fsq(self._fsq(c))
            z ^= c
        return z

    # -- group API -------------------------------------------------------------
    def add(self, A, B):
        if A is None:
            return B
        if B is None:
            return A
        x1, y1 = A
        x2, y2 = B
        if x1 == x2:
            if x1 == 0 or y2 == (x1 ^ y1):
                return None  # B = -A (incl. the order-2 point x=0)
            # doubling: lambda = x + y/x
            lam = x1 ^ self._fmul(y1, self._finv(x1))
            x3 = self._fsq(lam) ^ lam ^ self.a
            y3 = self._fsq(x1) ^ self._fmul(lam ^ 1, x3)
            return (x3, y3)
        lam = self._fmul(y1 ^ y2, self._finv(x1 ^ x2))
        x3 = self._fsq(lam) ^ lam ^ x1 ^ x2 ^ self.a
        y3 = self._fmul(lam, x1 ^ x3) ^ x3 ^ y1
        return (x3, y3)

    def neg(self, A):
        if A is None:
            return None
        return (A[0], A[0] ^ A[1])

    def mul(self, A, k: int):
        k %= self.order
        if k == 0 or A is None:
            return None
        if self._native:
            return self._native.mul_batch([A], [k], shared=True)[0]
        R = None
        for bit in bin(k)[2:]:
            R = self.add(R, R)
            if bit == "1":
                R = self.add(R, A)
        return R

    # -- batch API (native when available; same results as the loops) -------
    def mul_batch(self, points, scalars):
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch(points, ks, shared=False)
        return [self.mul(P, k) for P, k in zip(points, ks)]

    def mul_many(self, A, scalars):
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch([A], ks, shared=True)
        return [self.mul(A, k) for k in ks]

    def mul_gen_batch(self, scalars):
        ks = [k % self.order for k in scalars]
        if self._native:
            return self._native.mul_batch([self.g], ks, shared=True)
        return [self.mul_gen(k) for k in ks]

    def multi_mul_groups(self, points, scalars, n_groups: int, k: int):
        ks = [s % self.order for s in scalars]
        if self._native:
            return self._native.multi_mul_groups(list(points), ks, n_groups, k)
        return [
            self.multi_mul(points[g * k : (g + 1) * k], ks[g * k : (g + 1) * k])
            for g in range(n_groups)
        ]

    def sum_groups(self, points, n_groups: int, k: int):
        if self._native:
            return self._native.sum_groups(list(points), n_groups, k)
        out = []
        for g in range(n_groups):
            acc = None
            for P in points[g * k : (g + 1) * k]:
                acc = self.add(acc, P)
            out.append(acc)
        return out

    def _build_fixed_base_table(self, base):
        nwin = (self.order.bit_length() + 3) // 4
        table = []
        cur = base
        for _ in range(nwin):
            row = [None]
            acc = None
            for _ in range(15):
                acc = self.add(acc, cur)
                row.append(acc)
            table.append(row)
            for _ in range(4):
                cur = self.add(cur, cur)
        return table

    def mul_gen(self, k: int):
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
                R = self.add(R, self._g_table[i][d])
            k >>= 4
            i += 1
        return R

    def multi_mul(self, points, scalars):
        """sum_i scalars[i]*points[i] by interleaved binary double-and-add."""
        pairs = [
            (P, s % self.order)
            for P, s in zip(points, scalars)
            if P is not None and s % self.order != 0
        ]
        if not pairs:
            return None
        nbits = max(s.bit_length() for _, s in pairs)
        R = None
        for bit in range(nbits - 1, -1, -1):
            R = self.add(R, R)
            for P, s in pairs:
                if (s >> bit) & 1:
                    R = self.add(R, P)
        return R

    # -- serialization (SEC1 compressed for GF(2^m)) ---------------------------
    @property
    def nbytes(self) -> int:
        return (self.m + 7) // 8

    def to_bytes(self, A) -> bytes:
        if A is None:
            return b"\x00" * (self.nbytes + 1)
        x, y = A
        ybit = 0 if x == 0 else self._fmul(y, self._finv(x)) & 1
        return bytes([2 | ybit]) + x.to_bytes(self.nbytes, "big")

    def points_from_bytes(self, data: bytes, count: int) -> list:
        """Batch deserialization (API parity with EcGroup; per-point here --
        half-trace decompression has no native backend)."""
        k = self.nbytes + 1
        assert len(data) == count * k
        return [self.from_bytes(data[i * k : (i + 1) * k]) for i in range(count)]

    def from_bytes(self, data: bytes):
        if data[0] == 0:
            return None
        x = int.from_bytes(data[1:], "big")
        if x == 0:
            return (0, self._fsqrt(self.b))
        # z^2 + z = x + a + b/x^2, y = x*z
        c = x ^ self.a ^ self._fmul(self.b, self._finv(self._fsq(x)))
        z = self._half_trace(c)
        if self._fsq(z) ^ z != c:
            raise ValueError("invalid point encoding")
        if (z & 1) != (data[0] & 1):
            z ^= 1
        return (x, self._fmul(x, z))

    def is_on_curve(self, A) -> bool:
        if A is None:
            return True
        x, y = A
        lhs = self._fsq(y) ^ self._fmul(x, y)
        rhs = self._fmul(self._fsq(x), x ^ self.a) ^ self.b
        return lhs == rhs
