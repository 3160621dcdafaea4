"""RNS-BGV scheme over int32 residue tensors (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.fhe.bgv``: keygen, the RNS-CRT
gadget relin and Galois keys, packed plaintexts, secret- and public-key
encryption, decryption of BGV- and BFV-form phases (host CRT decode), the
homomorphic ops (add, ct x pt, ct x ct with relinearisation), the BGV
modulus switch down the drop-limb chain, and the automorphisms of the
EvalSum ladder. Ciphertexts are (..., k, L, N) int32 tensors in the NTT
domain, bit-equal to the JAX package's uint32 ones.

Every transform goes through the K1 wrapper (``ops.ntt_cuda``): the CUDA
kernel for a context on a CUDA device, the plain version on the CPU. The
context holds its constant tensors on its explicit ``device`` and draws its
randomness from its own ``torch.Generator``; keys therefore differ from the
JAX package's (threefry), and the tests compare randomised operations
through decryption or by feeding one package's sampled tensors to the other
(``convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.fhe.encoding import PackedEncoder
from nested_hashing_psi_tpu_torch.fhe.galois import (
    automorphism_ntt_perm,
    rotation_galois_element,
)
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops.modmath import (
    add_mod,
    cond_sub_mod,
    modsum,
    mont_mul,
    sub_mod,
    to_mont,
)
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.ntt_cuda import intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import centered, crt_reconstruct
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER


def tensor_product(a, b, p, pinv, r2):
    """(c0 + c1*s) x (d0 + d1*s) over one RNS base, NTT domain:
    a, b int32 (..., 2, L, N) -> (..., 3, L, N)."""
    b0m = to_mont(b[..., 0, :, :], p, pinv, r2)
    b1m = to_mont(b[..., 1, :, :], p, pinv, r2)
    return tensor_product_mont(a, b0m, b1m, p, pinv)


def tensor_product_mont(a, b0m, b1m, p, pinv):
    """tensor_product with the second operand's components already in
    Montgomery form. Karatsuba: 3 REDC multiplies, the middle term being
    (a0+a1)(b0+b1) - d0 - d2 (Montgomery form is linear, so the operand sums
    stay valid REDC inputs)."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    d0 = mont_mul(a0, b0m, p, pinv)
    d2 = mont_mul(a1, b1m, p, pinv)
    mid = mont_mul(add_mod(a0, a1, p), add_mod(b0m, b1m, p), p, pinv)
    d1 = sub_mod(sub_mod(mid, d0, p), d2, p)
    return torch.stack([d0, d1, d2], dim=-3)


@dataclass
class Ciphertext:
    """data: int32 (..., k, L, N) in NTT domain; k = 2 (or 3 pre-relin).
    form "bfv" phases carry Delta*m + e; `scale` is a known mod-t factor on
    the message that decrypt divides out."""

    data: torch.Tensor
    form: str = "bgv"
    scale: int = 1

    @property
    def k(self) -> int:
        return self.data.shape[-3]


@dataclass
class SecretKey:
    s_mont: torch.Tensor     # (L, N) NTT domain, Montgomery form
    s_ntt: torch.Tensor      # (L, N) NTT domain, plain form


@dataclass
class PublicKey:
    b_mont: torch.Tensor     # (L, N) Montgomery NTT form: b = t*e - a*s
    a_mont: torch.Tensor     # (L, N)


@dataclass
class RelinKey:
    b_mont: torch.Tensor     # (L_dig, L, N)
    a_mont: torch.Tensor     # (L_dig, L, N)


class BGVContext:
    default_form = "bgv"

    def _msg_prep(self, m_ntt):
        """Message placement in the phase: identity for BGV (LSB); the BFV
        subclass scales by Delta = floor(q/t) (MSB)."""
        return m_ntt

    def __init__(self, params: SchemeParams, seed: int = 0, *, device):
        self.params = params
        self.device = torch.device(device)
        self.n = params.ring_dim
        self.t = params.plaintext_modulus
        self.q_primes = params.q_primes
        self.L = params.num_limbs
        self.plan = NTTPlan(self.n, self.q_primes)
        self.encoder = PackedEncoder(self.n, self.t)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

        # device constants, (L, 1) int64 to broadcast against (..., L, N)
        tb = self.plan.tensors(self.device)
        self.p, self.pinv, self.r2 = tb["p"], tb["pinv"], tb["r2"]
        # the same primes and Montgomery constants as (L,) int32 bit views,
        # the form the position-sum kernel reads
        self.p_u32, self.pinv_u32 = tb["p_u32"], tb["pinv_u32"]
        qs = self.q_primes
        self.t_mont = self._col([(self.t << 32) % p for p in qs])
        # encryption-noise scaling: t*e for BGV; BFV overrides with 1*e
        self.noise_mont = self.t_mont
        self.qk_mod_qj = torch.tensor(
            [[[pk % pj] for pj in qs] for pk in qs], dtype=torch.int64,
            device=self.device,
        )                                                 # (L_dig, L, 1)
        self.q_half = self._col([p // 2 for p in qs])
        self.r32 = self._col([(1 << 32) % p for p in qs])

        # host CRT-decode constants
        q = params.q
        self._crt_inv = np.array([pow(q // p, -1, p) for p in qs], np.uint64)
        self._crt_qi_f = np.array([float(p) for p in qs])
        self._crt_qhat_mod_t = [(q // p) % self.t for p in qs]
        self._q_mod_t = q % self.t
        self._perms: dict[int, torch.Tensor] = {}

    def _col(self, vals) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int64, device=self.device).reshape(-1, 1)

    # ------------------------------------------------------------------
    # transforms (K1 on CUDA, the plain version on the CPU)
    # ------------------------------------------------------------------
    def _ntt_fast(self, x):
        return ntt(x, self.plan)

    def _intt_fast(self, x):
        return intt(x, self.plan)

    # ------------------------------------------------------------------
    # randomness (the context's own generator)
    # ------------------------------------------------------------------
    def _uniform_rns(self, shape) -> torch.Tensor:
        """Uniform mod q_i, shape (..., L, N); bias ~2^-33 via 64-bit draws."""
        hi, lo = torch.randint(
            0, 1 << 32, (2,) + tuple(shape), generator=self.gen,
            device=self.device, dtype=torch.int64,
        )
        return ((hi * self.r32 + lo) % self.p).int()

    def _small_to_rns(self, v: torch.Tensor) -> torch.Tensor:
        """Signed small ints (..., N) -> (..., L, N) int32 residues."""
        return torch.remainder(v.long()[..., None, :], self.p).int()

    def _ternary(self, shape) -> torch.Tensor:
        return torch.randint(
            -1, 2, tuple(shape), generator=self.gen, device=self.device,
            dtype=torch.int64,
        )

    def _gauss(self, shape) -> torch.Tensor:
        e = torch.randn(
            tuple(shape), generator=self.gen, device=self.device,
            dtype=torch.float64,
        ) * self.params.error_std
        return torch.clamp(torch.round(e), -24, 24).long()

    # ------------------------------------------------------------------
    # keys
    # ------------------------------------------------------------------
    def keygen(self) -> tuple[SecretKey, PublicKey]:
        s_ntt = self._ntt_fast(self._small_to_rns(self._ternary((self.n,))))
        s_mont = to_mont(s_ntt, self.p, self.pinv, self.r2)
        sk = SecretKey(s_mont=s_mont, s_ntt=s_ntt)
        a = self._uniform_rns((self.L, self.n))
        e_ntt = self._ntt_fast(self._small_to_rns(self._gauss((self.n,))))
        b = sub_mod(
            mont_mul(e_ntt, self.noise_mont, self.p, self.pinv),
            mont_mul(a, sk.s_mont, self.p, self.pinv),
            self.p,
        )
        pk = PublicKey(
            b_mont=to_mont(b, self.p, self.pinv, self.r2),
            a_mont=to_mont(a, self.p, self.pinv, self.r2),
        )
        return sk, pk

    def relin_keygen(self, sk: SecretKey) -> RelinKey:
        """RNS-CRT gadget key for s^2 -> s (EvalMultKeyGen equivalent)."""
        s2 = mont_mul(sk.s_ntt, sk.s_mont, self.p, self.pinv)  # plain form
        return self._ksk_gen_impl(sk, s2)

    def galois_keygen(self, sk: SecretKey, elements) -> dict[int, RelinKey]:
        """Key-switch keys sigma_k(s) -> s for each Galois element k
        (EvalRotateKeyGen / EvalSumKeyGen equivalent)."""
        return {
            int(k): self._ksk_gen_impl(sk, sk.s_ntt.index_select(-1, self._galois_perm(k)))
            for k in elements
        }

    def _galois_perm(self, k: int) -> torch.Tensor:
        """sigma_k's NTT-order gather indices on the context's device."""
        k = int(k)
        if k not in self._perms:
            self._perms[k] = torch.from_numpy(
                automorphism_ntt_perm(self.n, k).astype(np.int64)
            ).to(self.device)
        return self._perms[k]

    def _ksk_gen_impl(self, sk: SecretKey, target_ntt) -> RelinKey:
        """ksk[k] = (noise*e_k - a_k*s + target*g_k, a_k) with the CRT gadget
        g_k = 1 on limb k, 0 elsewhere; target in plain NTT form (L, N)."""
        L, n = self.L, self.n
        a = self._uniform_rns((L, L, n))
        e_ntt = self._ntt_fast(self._small_to_rns(self._gauss((L, n))))
        b = sub_mod(
            mont_mul(e_ntt, self.noise_mont, self.p, self.pinv),
            mont_mul(a, sk.s_mont, self.p, self.pinv),
            self.p,
        )
        eye = torch.eye(L, dtype=torch.bool, device=self.device)[:, :, None]
        b = torch.where(eye, add_mod(b, target_ntt[None], self.p), b)
        return RelinKey(
            b_mont=to_mont(b, self.p, self.pinv, self.r2),
            a_mont=to_mont(a, self.p, self.pinv, self.r2),
        )

    # ------------------------------------------------------------------
    # plaintexts
    # ------------------------------------------------------------------
    def _encode_rns(self, slot_values) -> torch.Tensor:
        """Host packed encode -> (B?, L, N) int32 coefficient residues on
        the context's device."""
        coeffs = self.encoder.encode(slot_values)
        rns = self.encoder.to_rns(coeffs, self.q_primes)  # (..., L, n) uint64
        return torch.from_numpy(rns.astype(np.int32)).to(self.device)

    def make_plaintext_rns(self, slot_values) -> torch.Tensor:
        """Packed-encode slot values -> (B?, L, N) int32 NTT-domain tensor."""
        return self._ntt_fast(self._encode_rns(slot_values))

    def make_plaintext_mont(self, slot_values) -> torch.Tensor:
        """Like make_plaintext_rns but in Montgomery form (ct x pt operand)."""
        return to_mont(
            self.make_plaintext_rns(slot_values), self.p, self.pinv, self.r2
        )

    # ------------------------------------------------------------------
    # encryption / decryption
    # ------------------------------------------------------------------
    def encrypt_sk(self, m_ntt: torch.Tensor, sk: SecretKey) -> Ciphertext:
        """Secret-key encryption of (B?, L, N) NTT-domain plaintext(s)."""
        bshape = tuple(m_ntt.shape[:-2])
        c1 = self._uniform_rns(bshape + (self.L, self.n))
        e_ntt = self._ntt_fast(self._small_to_rns(self._gauss(bshape + (self.n,))))
        c0 = sub_mod(
            add_mod(
                mont_mul(e_ntt, self.noise_mont, self.p, self.pinv),
                self._msg_prep(m_ntt),
                self.p,
            ),
            mont_mul(c1, sk.s_mont, self.p, self.pinv),
            self.p,
        )
        return Ciphertext(torch.stack([c0, c1], dim=-3), self.default_form, 1)

    def encrypt_pk(self, m_ntt: torch.Tensor, pk: PublicKey) -> Ciphertext:
        """Public-key encryption of (B?, L, N) NTT-domain plaintext(s)."""
        bshape = tuple(m_ntt.shape[:-2])
        u_ntt = self._ntt_fast(self._small_to_rns(self._ternary(bshape + (self.n,))))
        e_ntt = self._ntt_fast(self._small_to_rns(self._gauss((2,) + bshape + (self.n,))))
        noise = mont_mul(e_ntt, self.noise_mont, self.p, self.pinv)
        c0 = add_mod(
            add_mod(mont_mul(u_ntt, pk.b_mont, self.p, self.pinv), noise[0], self.p),
            self._msg_prep(m_ntt),
            self.p,
        )
        c1 = add_mod(mont_mul(u_ntt, pk.a_mont, self.p, self.pinv), noise[1], self.p)
        return Ciphertext(torch.stack([c0, c1], dim=-3), self.default_form, 1)

    def decrypt_phase(self, ct: Ciphertext, sk: SecretKey) -> torch.Tensor:
        """[c0 + c1*s (+ c2*s^2)]_q in coefficient domain: (..., L, N) int32."""
        d = ct.data
        phase = add_mod(
            d[..., 0, :, :],
            mont_mul(d[..., 1, :, :], sk.s_mont, self.p, self.pinv),
            self.p,
        )
        if d.shape[-3] == 3:
            c2s = mont_mul(d[..., 2, :, :], sk.s_mont, self.p, self.pinv)
            phase = add_mod(
                phase, mont_mul(c2s, sk.s_mont, self.p, self.pinv), self.p
            )
        return self._intt_fast(phase)

    def decrypt(self, ct: Ciphertext, sk: SecretKey, length: int | None = None):
        """Full decrypt to slot values in [0, t) on the host. Returns
        (slots, noise_bits). Ciphertexts on a smaller basis are decrypted in
        the matching child context with the shrunk key. Spans
        ``decrypt.phase`` (on the device), ``decrypt.download`` and
        ``decrypt.crt`` (the host CRT and decode)."""
        n_limbs = ct.data.shape[-2]
        if n_limbs < self.L:
            return self.context_for_limbs(n_limbs).decrypt(
                ct, self.shrink_key_to(sk, n_limbs), length
            )
        with TRACER.span("decrypt.phase", device=self.device):
            phase = self.decrypt_phase(ct, sk)
        with TRACER.span("decrypt.download"):
            phase = phase.cpu().numpy().astype(np.uint64)
        with TRACER.span("decrypt.crt"):
            if ct.form == "bgv":
                coeffs, noise_bits = self._phase_to_mt(phase)
            else:
                coeffs, noise_bits = self._phase_to_mt_bfv(phase)
            if ct.scale != 1:
                inv = pow(ct.scale, -1, self.t)
                coeffs = (coeffs.astype(object) * inv) % self.t
            return self.encoder.decode(coeffs, length), noise_bits

    def _phase_to_mt_bfv(self, phase: np.ndarray):
        raise NotImplementedError("BFV-form decrypt requires BFVContext")

    def noise_bits_exact(self, ct: Ciphertext, sk: SecretKey) -> float:
        """Exact log2 |[phase]_q| via host CRT (tests and diagnostics: slow).
        decrypt()'s float64 estimate floors at ~log2(q) - 51."""
        phase = self.decrypt_phase(ct, sk).cpu().numpy().astype(np.uint64)
        flat = phase.reshape(-1, self.L, self.n)
        q, worst = self.params.q, 0
        for b in range(flat.shape[0]):
            for j in range(self.n):
                x = crt_reconstruct(
                    [int(flat[b, i, j]) for i in range(self.L)], list(self.q_primes)
                )
                worst = max(worst, abs(centered(x, q)))
        return float(int(worst).bit_length())

    def _phase_to_mt(self, phase: np.ndarray):
        """Exact [x]_q mod t of a BGV-form phase from its RNS residues
        (..., L, N), plus the noise size. x = sum_i y_i*(q/q_i) - k*q with
        y_i = [x_i * (q/q_i)^-1]_{q_i} and k = round(sum_i y_i/q_i); float64
        rounding is safe while the noise budget holds (|x| << q/2). t >= 2^33
        goes through the native __int128 CRT kernel when it is built; an
        exact object-arithmetic route covers the rest."""
        if self.t >= 1 << 33:
            from nested_hashing_psi_tpu_torch.utils import native

            res = native.phase_to_mt(phase, self.q_primes, self.t, "bgv")
            if res is not None:
                m, dist = res
                noise_bits = (
                    np.log2(dist) + self.params.q.bit_length() if dist > 0 else 0.0
                )
                return m, noise_bits
        y = (phase * self._crt_inv.reshape(-1, 1)) % np.array(
            self.q_primes, np.uint64
        ).reshape(-1, 1)
        v = (y.astype(np.float64) / self._crt_qi_f.reshape(-1, 1)).sum(axis=-2)
        k = np.round(v).astype(np.int64)
        frac = np.abs(v - k)
        max_frac = float(frac.max()) if frac.size else 0.0
        noise_bits = (
            np.log2(max_frac) + self.params.q.bit_length() if max_frac > 0 else 0.0
        )
        t = self.t
        if t < 2**33 and max(self.q_primes) < 2**31:
            acc = np.zeros(y.shape[:-2] + y.shape[-1:], dtype=np.uint64)
            for i in range(self.L):
                acc = (acc + y[..., i, :] * np.uint64(self._crt_qhat_mod_t[i] % t)) % np.uint64(t)
            kb = (k.astype(object) * self._q_mod_t) % t
            m = (acc.astype(object) - kb) % t
            return m.astype(object), noise_bits
        acc = np.zeros(y.shape[:-2] + y.shape[-1:], dtype=object)
        for i in range(self.L):
            acc = (acc + y[..., i, :].astype(object) * self._crt_qhat_mod_t[i]) % t
        m = (acc - k.astype(object) * self._q_mod_t) % t
        return m, noise_bits

    # ------------------------------------------------------------------
    # homomorphic ops
    # ------------------------------------------------------------------
    def ct_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.form == b.form and a.scale == b.scale, "mismatched ct forms"
        return Ciphertext(add_mod(a.data, b.data, self.p), a.form, a.scale)

    def ct_pt_mul(self, ct: Ciphertext, pt_mont: torch.Tensor) -> Ciphertext:
        """ct x packed plaintext (Montgomery NTT form, (B?, L, N))."""
        return Ciphertext(
            mont_mul(ct.data, pt_mont[..., None, :, :], self.p, self.pinv),
            ct.form,
            ct.scale,
        )

    def ct_ct_mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ct_ct_mul_impl(self._to_mul_form(a), self._to_mul_form(b))

    def _to_mul_form(self, ct: Ciphertext) -> Ciphertext:
        """BGV contexts multiply in place; the BFV subclass converts
        Delta-form operands to BGV form first."""
        return ct

    def _ct_ct_mul_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product -> 3-component ciphertext (relinearize after)."""
        return Ciphertext(
            tensor_product(a.data, b.data, self.p, self.pinv, self.r2),
            "bgv",
            a.scale * b.scale % self.t,
        )

    def relinearize(self, ct: Ciphertext, rlk: RelinKey) -> Ciphertext:
        return self._relinearize_impl(ct, rlk)

    def _relinearize_impl(self, ct: Ciphertext, rlk: RelinKey) -> Ciphertext:
        """3 -> 2 components via RNS-CRT gadget key switching."""
        assert ct.data.shape[-3] == 3
        d = ct.data
        ks0, ks1 = self._key_switch(d[..., 2, :, :], rlk)
        return Ciphertext(
            torch.stack(
                [add_mod(d[..., 0, :, :], ks0, self.p), add_mod(d[..., 1, :, :], ks1, self.p)],
                dim=-3,
            ),
            ct.form,
            ct.scale,
        )

    def ct_ct_mul_relin(self, a: Ciphertext, b: Ciphertext, rlk: RelinKey) -> Ciphertext:
        return self.relinearize(self.ct_ct_mul(a, b), rlk)

    # ------------------------------------------------------------------
    # key switching (RNS-CRT gadget)
    # ------------------------------------------------------------------
    def _key_switch(self, poly_ntt: torch.Tensor, ksk: RelinKey):
        """(d0, d1) with d0 + d1*s = poly * <key target> (+ small noise),
        from an NTT-domain polynomial (..., L, N)."""
        return self._key_switch_coeffs(self._intt_fast(poly_ntt), ksk)

    def _key_switch_coeffs(self, poly_coeffs: torch.Tensor, ksk: RelinKey):
        """(d0, d1) with d0 + d1*s = poly * <key target> (+ small noise),
        from a coefficient-domain polynomial (..., L, N)."""
        dig = self._rns_decompose_coeffs(poly_coeffs)  # (..., L_dig, L, N) NTT
        d0 = modsum(mont_mul(dig, ksk.b_mont, self.p, self.pinv), self.p, axis=-3)
        d1 = modsum(mont_mul(dig, ksk.a_mont, self.p, self.pinv), self.p, axis=-3)
        return d0, d1

    def _rns_decompose_coeffs(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(..., L, N) coefficient domain -> centered limb digits re-reduced
        mod every q_j, in NTT domain: (..., L_dig, L, N)."""
        dk = coeffs[..., :, None, :]              # (..., L_dig, 1, N)
        big = dk > self.q_half[:, None, :]        # centered lift sign
        r = cond_sub_mod(dk, self.p[None, :, :])  # (..., L_dig, L, N)
        r_neg = sub_mod(r, self.qk_mod_qj, self.p[None, :, :])
        return self._ntt_fast(torch.where(big, r_neg, r))

    # ------------------------------------------------------------------
    # drop-limb child contexts
    # ------------------------------------------------------------------
    def drop_limb_context(self) -> "BGVContext":
        """Context over q' = q / q_last (shares scheme params otherwise)."""
        if not hasattr(self, "_child_ctx"):
            self._child_ctx = type(self)(
                replace(self.params, num_limbs=self.L - 1), seed=0,
                device=self.device,
            )
        return self._child_ctx

    def context_for_limbs(self, n_limbs: int) -> "BGVContext":
        """Walk the drop-limb chain down to a context over n_limbs limbs."""
        ctx = self
        while ctx.L > n_limbs:
            ctx = ctx.drop_limb_context()
        assert ctx.L == n_limbs, (self.L, n_limbs)
        return ctx

    def shrink_key(self, sk: SecretKey) -> SecretKey:
        return SecretKey(s_mont=sk.s_mont[:-1], s_ntt=sk.s_ntt[:-1])

    def shrink_key_to(self, sk: SecretKey, n_limbs: int) -> SecretKey:
        return SecretKey(s_mont=sk.s_mont[:n_limbs], s_ntt=sk.s_ntt[:n_limbs])

    @staticmethod
    def shrink_relin_key(rlk: RelinKey, n_limbs: int) -> RelinKey:
        """A full-modulus RNS-CRT gadget key restricted to the prefix basis
        (drop the trailing digit rows and limb columns)."""
        return RelinKey(
            b_mont=rlk.b_mont[:n_limbs, :n_limbs],
            a_mont=rlk.a_mont[:n_limbs, :n_limbs],
        )

    # ------------------------------------------------------------------
    # modulus switching (leveled BGV)
    # ------------------------------------------------------------------
    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        """BGV modulus switch: drop the last limb q_l, scaling noise by
        ~1/q_l. c' = (c - delta)/q_l with delta = c mod q_l corrected to
        0 mod t. Returns a ciphertext for drop_limb_context(); the message
        picks up q_l^-1 mod t, tracked in scale. BGV form and t < 2^31 only.

        Every intermediate is the canonical residue the JAX package's uint32
        REDC steps produce, computed here as exact int64 products."""
        assert ct.form == "bgv", "mod switch operates on BGV-form phases"
        assert self.t < 2**31
        child = self.drop_limb_context()
        L, t, ql = self.L, self.t, self.q_primes[-1]
        if not hasattr(self, "_ms_consts"):
            qs = self.q_primes[:-1]
            self._ms_consts = (
                self._col([ql % qj for qj in qs]),
                self._col([t % qj for qj in qs]),
                self._col([pow(ql, -1, qj) for qj in qs]),
            )
        ql_j, t_j, qlinv_j = self._ms_consts
        qj = self.p[:-1]
        coeffs = self._intt_fast(ct.data).long()          # (..., k, L, N)
        r = coeffs[..., L - 1 : L, :]                      # [c]_{q_l}
        big = (r > ql // 2).long()                         # centered sign
        # u = [-r_c * q_l^-1]_t, r_c the centered residue
        r_c_mod_t = (r - big * (ql % t)) % t
        u = (t - r_c_mod_t) % t * pow(ql, -1, t) % t
        u_big = (u > t // 2).long()
        # delta mod q_j = r_c + q_l * u_c  (r_c, u_c centered)
        r_j = (r - big * ql_j) % qj
        u_j = (u - u_big * t_j) % qj
        delta = (r_j + u_j * ql_j) % qj
        scaled = (coeffs[..., : L - 1, :] - delta) % qj * qlinv_j % qj
        return Ciphertext(
            child._ntt_fast(scaled.int()), ct.form, ct.scale * pow(ql, -1, t) % t
        )

    # ------------------------------------------------------------------
    # automorphisms / rotations (EvalRotate, EvalSum equivalents)
    # ------------------------------------------------------------------
    def automorphism(self, ct: Ciphertext, k: int, gk: RelinKey) -> Ciphertext:
        """sigma_k(ct): the NTT-order slot permutation (a gather on the last
        axis), then a key switch of c1 back to s."""
        perm = self._galois_perm(k)
        c0 = ct.data[..., 0, :, :].index_select(-1, perm)
        c1 = ct.data[..., 1, :, :].index_select(-1, perm)
        ks0, ks1 = self._key_switch(c1, gk)
        return Ciphertext(
            torch.stack([add_mod(c0, ks0, self.p), ks1], dim=-3), ct.form, ct.scale
        )

    def rotate_slots(self, ct: Ciphertext, r: int, gks: dict[int, RelinKey]) -> Ciphertext:
        """Left-rotate slots by r within each half-ring (EvalAtIndex)."""
        k = rotation_galois_element(self.n, r)
        if k == 1:
            return ct
        return self.automorphism(ct, k, gks[k])

    def conjugate(self, ct: Ciphertext, gks: dict[int, RelinKey]) -> Ciphertext:
        """Swap the two half-rings (sigma_{2n-1})."""
        k = 2 * self.n - 1
        return self.automorphism(ct, k, gks[k])

    def sum_ladder_elements(self) -> list[int]:
        """Galois elements needed by eval_sum_all_slots (EvalSumKeyGen set)."""
        half = self.n // 2
        els = [rotation_galois_element(self.n, 1 << j) for j in range(half.bit_length() - 1)]
        els.append(2 * self.n - 1)
        return els

    def eval_sum_all_slots(self, ct: Ciphertext, gks: dict[int, RelinKey]) -> Ciphertext:
        """Sum of all n slots, replicated into every slot (EvalSum over the
        full batch): log2(n/2) rotations + one conjugation."""
        r = 1
        while r < self.n // 2:
            ct = self.ct_add(ct, self.rotate_slots(ct, r, gks))
            r <<= 1
        return self.ct_add(ct, self.conjugate(ct, gks))
