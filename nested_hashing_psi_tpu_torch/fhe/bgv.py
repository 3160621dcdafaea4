"""RNS-BGV scheme core over int32 residue tensors (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.fhe.bgv``, limited to what the
BatchedFHE main path runs: constants, keygen, the RNS-CRT gadget relin key,
packed plaintexts, secret-key encryption, decryption (host CRT decode), the
coefficient-domain key switch and the drop-limb child contexts.
Ciphertexts are (..., k, L, N) int32 tensors in the NTT domain, bit-equal
to the JAX package's uint32 ones.

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


def tensor_product(a, b, p, pinv, r2):
    """(c0 + c1*s) x (d0 + d1*s) over one RNS base, NTT domain:
    a, b int32 (..., 2, L, N) -> (..., 3, L, N). Karatsuba: 3 REDC
    multiplies, the middle term being (a0+a1)(b0+b1) - d0 - d2 (Montgomery
    form is linear, so the operand sums stay valid REDC inputs)."""
    b0m = to_mont(b[..., 0, :, :], p, pinv, r2)
    b1m = to_mont(b[..., 1, :, :], p, pinv, r2)
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
        the matching child context with the shrunk key."""
        n_limbs = ct.data.shape[-2]
        if n_limbs < self.L:
            return self.context_for_limbs(n_limbs).decrypt(
                ct, self.shrink_key_to(sk, n_limbs), length
            )
        if ct.form != "bfv":
            raise NotImplementedError(
                "BGV-form decryption (--bgv) is not ported yet"
            )
        phase = self.decrypt_phase(ct, sk).cpu().numpy().astype(np.uint64)
        coeffs, noise_bits = self._phase_to_mt_bfv(phase)
        if ct.scale != 1:
            inv = pow(ct.scale, -1, self.t)
            coeffs = (coeffs.astype(object) * inv) % self.t
        return self.encoder.decode(coeffs, length), noise_bits

    def _phase_to_mt_bfv(self, phase: np.ndarray):
        raise NotImplementedError("BFV-form decrypt requires BFVContext")

    # ------------------------------------------------------------------
    # key switching (RNS-CRT gadget), coefficient-domain input
    # ------------------------------------------------------------------
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
