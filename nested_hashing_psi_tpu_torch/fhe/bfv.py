"""RNS-BFV scheme layer (PyTorch): the reference's default scheme.

Counterpart of ``nested_hashing_psi_tpu.fhe.bfv``: scale-invariant (MSB)
encoding with phase Delta*m + e, textbook HPS ct x ct
(``ops.basis.BFVMulConverter``) on the full basis (``ct_ct_mul``, the fused
``ct_ct_mul_relin``) or after the exact drop-limb rescale
(``ops.basis.RNSRescale``, ``rescale_ct``, the fused
``hps_mul_relin_rescaled``; on a GPU the rescale, the base extension, the
tensor products and scale-and-round are the HPS kernels of csrc/hps.cu),
the exact t-scaling bridge to BGV form
(``ct_ct_mul_bridge``, with the Delta-lifting relinearisation) and the host
decode of a BFV phase. ``make_context`` picks BGV or BFV from the scheme.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.fhe.bgv import (
    BGVContext,
    Ciphertext,
    tensor_product,
)
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops import hps_cuda
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter, RNSRescale
from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, mont_mul
from nested_hashing_psi_tpu_torch.ops.ntt_cuda import intt, ntt


class BFVContext(BGVContext):
    default_form = "bfv"

    def __init__(self, params: SchemeParams, seed: int = 0, *, device):
        super().__init__(params, seed, device=device)
        delta = params.q // self.t
        self.delta_mont = self._col([((delta % p) << 32) % p for p in self.q_primes])
        # noise is plain e (the message sits in the MSB)
        self.noise_mont = self._col([(1 << 32) % p for p in self.q_primes])
        self.r_t = params.q % self.t  # the BGV bridge's message factor is -r_t
        self._mulconv: BFVMulConverter | None = None
        self._rescalers: dict[int, RNSRescale] = {}

    def _msg_prep(self, m_ntt):
        return mont_mul(m_ntt, self.delta_mont, self.p, self.pinv)

    def ct_ct_mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """EvalMult(ct, ct): textbook HPS for BFV-form operands; the
        t-scaling bridge handles mixed forms."""
        if a.form == "bfv" and b.form == "bfv":
            return self._hps_mul_impl(a, b)
        return super().ct_ct_mul(a, b)

    def ct_ct_mul_bridge(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """The exact t-scaling bridge: both operands times t (BGV form,
        message -r_t*m), then a BGV tensor product."""
        return super().ct_ct_mul(a, b)

    def _hps_mul_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        out = self._ntt_fast(self._hps_core(a.data, b.data))
        return Ciphertext(out, "bfv", a.scale * b.scale % self.t)

    def ct_ct_mul_relin(self, a: Ciphertext, b: Ciphertext, rlk) -> Ciphertext:
        """Fused EvalMult + relinearisation for BFV-form operands on the full
        basis: the HPS product's d2 stays in the coefficient domain and feeds
        the gadget decompose directly (no forward NTT of d2, no inverse NTT
        in the decompose)."""
        if a.form == "bfv" and b.form == "bfv":
            return self._hps_mul_relin_impl(a, b, rlk)
        return super().ct_ct_mul_relin(a, b, rlk)

    def _hps_mul_relin_impl(self, a: Ciphertext, b: Ciphertext, rlk) -> Ciphertext:
        y = self._hps_core(a.data, b.data)  # (..., 3, L, N) coefficients
        d01 = self._ntt_fast(y[..., :2, :, :])
        ks0, ks1 = self._key_switch_coeffs(y[..., 2, :, :], rlk)
        data = torch.stack(
            [add_mod(d01[..., 0, :, :], ks0, self.p), add_mod(d01[..., 1, :, :], ks1, self.p)],
            dim=-3,
        )
        return Ciphertext(data, "bfv", a.scale * b.scale % self.t)

    def _relinearize_impl(self, ct: Ciphertext, rlk) -> Ciphertext:
        """A BGV-form product (the t-scaling bridge) is Delta-lifted to BFV
        form before key switching: this context's keys carry plain noise,
        which would land in the mod-t message of a BGV-form phase. Times
        Delta, the phase is Delta*m - r_t*e (Delta*t = q - r_t), where the
        key-switch noise is absorbed by the rounding decrypt. Exact."""
        if ct.form == "bgv":
            ct = Ciphertext(
                mont_mul(ct.data, self.delta_mont, self.p, self.pinv), "bfv", ct.scale
            )
        return super()._relinearize_impl(ct, rlk)

    def _to_mul_form(self, ct: Ciphertext) -> Ciphertext:
        """BFV form -> BGV form: multiply by t; the message becomes -r_t*m."""
        if ct.form == "bgv":
            return ct
        return Ciphertext(
            mont_mul(ct.data, self.t_mont, self.p, self.pinv),
            "bgv",
            ct.scale * (self.t - self.r_t) % self.t,
        )

    @property
    def mulconv(self) -> BFVMulConverter:
        """Lazily-built HPS multiplication machinery."""
        if self._mulconv is None:
            self._mulconv = BFVMulConverter(self.q_primes, self.t, self.n)
        return self._mulconv

    def _ntt_fast_aux(self, x):
        return ntt(x, self.mulconv.plan_aux)

    def _intt_fast_aux(self, x):
        return intt(x, self.mulconv.plan_aux)

    def _hps_core(self, a_data, b_data, ab_coeffs=None, ab_aux=None) -> torch.Tensor:
        """Textbook HPS product core: NTT-domain operands (each (..., 2, L, N))
        -> coefficient-domain product over q, (..., 3, L, N).

        ab_coeffs, when given, is the stacked (2, ..., 2, L, N)
        coefficient-domain view of the operands (the rescaled path already
        has it, so the iNTT is skipped); ab_aux, when given, its extension
        to the aux base. On CUDA tensors the extension, both tensor products
        and scale-and-round with the return to q are the HPS kernels
        (``ops.hps_cuda``); K1 transforms between them."""
        mc = self.mulconv
        if ab_coeffs is None:
            ab_coeffs = self._intt_fast(torch.stack([a_data, b_data], dim=0))
        if ab_aux is None:
            ab_aux = mc.extend_q_to_aux(ab_coeffs)
        # both operands ride one stacked transform per direction
        eab = self._ntt_fast_aux(ab_aux)
        if a_data.is_cuda:
            d_q, d_aux = hps_cuda.tensor_products(a_data.contiguous(), b_data.contiguous(),
                                                  eab[0], eab[1], mc)
        else:
            tb = mc.plan_aux.tensors(self.device)
            d_q = tensor_product(a_data, b_data, self.p, self.pinv, self.r2)
            d_aux = tensor_product(eab[0], eab[1], tb["p"], tb["pinv"], tb["r2"])
        # scale by t/q with rounding, exact-convert back to q
        return mc.scale_round_to_q(self._intt_fast(d_q), self._intt_fast_aux(d_aux))

    # ------------------------------------------------------------------
    # drop-limb rescale (BFV modulus switch) + the rescaled mult pipeline
    # ------------------------------------------------------------------
    def _rescaler(self, n_limbs: int) -> RNSRescale:
        """Cached exact RNS rescale from this context's basis to its first
        n_limbs primes."""
        if n_limbs not in self._rescalers:
            self._rescalers[n_limbs] = RNSRescale(self.q_primes, self.L - n_limbs)
        return self._rescalers[n_limbs]

    def rescale_coeffs(self, coeffs: torch.Tensor, n_limbs: int) -> torch.Tensor:
        """(..., L, N) coefficient-domain -> (..., n_limbs, N) over the
        child basis (exact integer rescale; see RNSRescale)."""
        assert 1 <= n_limbs < self.L
        return self._rescaler(n_limbs).rescale(coeffs)

    def rescale_ct(self, ct: Ciphertext, n_limbs: int) -> Ciphertext:
        """Modulus-switch a BFV-form ciphertext down to n_limbs limbs.
        Noise: e' ~ e/qd + t*small (fhe.params.bfv_mul_limbs model)."""
        assert ct.form == "bfv"
        if n_limbs >= self.L:
            return ct
        child = self.context_for_limbs(n_limbs)
        coeffs = self._intt_fast(ct.data)
        return Ciphertext(
            child._ntt_fast(self.rescale_coeffs(coeffs, n_limbs)), ct.form, ct.scale
        )

    def hps_mul_relin_rescaled(
        self,
        a: Ciphertext,
        b: Ciphertext,
        rlk,
        mul_limbs: int,
        ship_limbs: int | None = None,
        a_limbs: int | None = None,
    ) -> Ciphertext:
        """EvalMult + relin with both operands first rescaled to mul_limbs
        limbs: the operands' inverse transforms feed the rescale, whose
        output feeds both the q'-side forward NTT and the HPS base
        extension. Optionally rescales the product once more to ship_limbs
        (the wire/decrypt basis). a may already live on a smaller basis
        (a_limbs); b is on the full basis. rlk is the FULL-basis relin key,
        shrunk to the mult basis here."""
        assert a.form == "bfv" and b.form == "bfv"
        mctx = self.context_for_limbs(mul_limbs)
        a_L = a.data.shape[-2] if a_limbs is None else a_limbs
        ab_aux = None  # the rescaled operands' aux residues, where one pass makes both
        if a_L == self.L and b.data.shape[-2] == self.L:
            assert 1 <= mul_limbs < self.L
            ab_coeffs = self._intt_fast(torch.stack([a.data, b.data], dim=0))
            ab_m, ab_aux = self._rescaler(mul_limbs).rescale_extend(
                ab_coeffs, mctx.mulconv.q_to_aux)
        else:
            actx = self.context_for_limbs(a_L)
            a_c = actx._intt_fast(a.data)
            a_m = actx.rescale_coeffs(a_c, mul_limbs) if a_L > mul_limbs else a_c
            b_m = self.rescale_coeffs(self._intt_fast(b.data), mul_limbs)
            ab_m = torch.stack([a_m, b_m], dim=0)
        ntt_m = mctx._ntt_fast(ab_m)
        y = mctx._hps_core(ntt_m[0], ntt_m[1], ab_coeffs=ab_m, ab_aux=ab_aux)
        d01 = mctx._ntt_fast(y[..., :2, :, :])
        rlk_m = self.shrink_relin_key(rlk, mul_limbs)
        ks0, ks1 = mctx._key_switch_coeffs(y[..., 2, :, :], rlk_m)
        data = torch.stack(
            [
                add_mod(d01[..., 0, :, :], ks0, mctx.p),
                add_mod(d01[..., 1, :, :], ks1, mctx.p),
            ],
            dim=-3,
        )
        scale = a.scale * b.scale % self.t
        if ship_limbs is not None and ship_limbs < mul_limbs:
            sctx = self.context_for_limbs(ship_limbs)
            coeffs = mctx._intt_fast(data)
            data = sctx._ntt_fast(mctx.rescale_coeffs(coeffs, ship_limbs))
        return Ciphertext(data, "bfv", scale)

    def _phase_to_mt_bfv(self, phase: np.ndarray):
        """m = round(t/q * [phase]_q) mod t via the CRT float trick; exact
        native __int128 kernel for t >= 2^33, exact object arithmetic for
        t >= 2^40 otherwise."""
        if self.t >= 1 << 33:
            from nested_hashing_psi_tpu_torch.utils import native

            res = native.phase_to_mt(phase, self.q_primes, self.t, "bfv")
            if res is not None:
                m, dist = res
                noise_bits = (
                    np.log2(dist) + self.params.q.bit_length() - self.t.bit_length()
                    if dist > 0
                    else 0.0
                )
                return m, noise_bits
        y = (phase * self._crt_inv.reshape(-1, 1)) % np.array(
            self.q_primes, np.uint64
        ).reshape(-1, 1)
        v = (y.astype(np.float64) / self._crt_qi_f.reshape(-1, 1)).sum(axis=-2)
        frac = v - np.floor(v)
        t = self.t
        # float64 error ~ L * 2^-52; safe for t below ~2^40
        if t < 1 << 40:
            m = np.round(frac * t).astype(np.int64) % t
            err = np.abs(frac * t - np.round(frac * t))
            max_err = float(err.max()) if err.size else 0.0
            noise_bits = (
                float(np.log2(max_err)) + self.params.q.bit_length() - t.bit_length()
                if max_err > 0
                else 0.0
            )
            return m.astype(object), noise_bits
        from nested_hashing_psi_tpu_torch.ops.primes import crt_reconstruct

        q = self.params.q
        flat = phase.reshape(-1, self.L, self.n)
        out = np.zeros((flat.shape[0], self.n), dtype=object)
        for b in range(flat.shape[0]):
            for j in range(self.n):
                x = crt_reconstruct(
                    [int(flat[b, i, j]) for i in range(self.L)],
                    list(self.q_primes),
                )
                out[b, j] = (x * t + q // 2) // q % t
        return out.reshape(phase.shape[:-2] + (self.n,)), 0.0


def make_context(params: SchemeParams, seed: int | None = 0, *, device) -> BGVContext:
    """Scheme factory matching the reference's --bgv switch, on an explicit
    device. seed=None draws the generator seed from OS entropy (secrets) --
    required wherever secret keys are made in production paths; an explicit
    int seed is for tests only."""
    if seed is None:
        import secrets

        seed = secrets.randbits(63)
    if params.scheme == "bfv":
        return BFVContext(params, seed, device=device)
    return BGVContext(params, seed, device=device)
