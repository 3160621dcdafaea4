"""Decrypt on the context's device, straight to packed slots or a zero mask,
for BFV-form and BGV-form ciphertexts.

Counterpart of ``nested_hashing_psi_tpu.fhe.device_decrypt`` (BFV only
there). The host decrypt (``BGVContext.decrypt``) copies the whole phase
tensor (..., L, N) to the host and runs the CRT decode and the slot NTT in
numpy; this keeps the decode on the device and hands back only what the PSI
client needs:

    phase = c0 + c1*s             (31-bit RNS; the inverse NTT is K1)
    y_i   = [x_i * (q/q_i)^-1]_{q_i}
    BFV:  m = round(t/q * x) mod t             (exact fixed-point CRT)
    BGV:  m = [x]_q mod t = (sum_i y_i [q/q_i]_t - k [q]_t) mod t,
          k = round(sum_i y_i / q_i)
    slots = NTT_t(m)[s2n]

On a CUDA tensor ``zero_mask`` is one launch of the decrypt kernel
(``ops.decrypt_cuda``, csrc/decrypt.cu) on the phase, and raises if the
kernel does; on a CPU tensor it runs the plain PyTorch version, two-plane
int64 arithmetic (``ops.mod64``), which ``slots`` runs on both devices.

Exactness of the CRT step: t*x/q = t*v - t*k' for v = sum_i y_i/q_i and an
integer k' < L, so m + t*k' = round(t*v). S = sum_i y_i * floor(t * 2^72 /
q_i) underestimates t*v*2^72 by less than sum_i y_i < 2^36, four orders
below the decrypt noise margin, so (S + 2^71) >> 72 is exactly round(t*v),
and m is its residue mod t. The BGV form takes the same sum with t = 1 for
k, which equals the host decrypt's float64 round(v) while the noise budget
holds (|x| far below q/2). The tracked ciphertext scale is a unit mod t, so
it never changes which slots are zero; like the reference, ``slots`` does
not divide it out.

Build the decryptor in the context of the ciphertext's limb count (a
shipped result lives on the rescaled basis: ``ctx.context_for_limbs(L')``
with ``ctx.shrink_key_to(sk, L')``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import decrypt_cuda, mod64
from nested_hashing_psi_tpu_torch.ops.modmath import MASK32, add_mod, mont_mul, shoup_host, shoup_mul
from nested_hashing_psi_tpu_torch.ops.refmodel import _bitrev


class DeviceDecryptor:
    """Decode constants of one context and one ciphertext form ("bfv" or
    "bgv", the context's own by default), as tensors on its device: the
    kernel's on a CUDA context, the plain version's ``ops.mod64`` planes on
    first use (``slots``, ``zero_mask`` of a CPU tensor)."""

    def __init__(self, ctx, form: str | None = None):
        form = form or ctx.default_form
        if form not in ("bfv", "bgv"):
            raise ValueError(f"unknown ciphertext form {form!r}")
        self.ctx, self.form = ctx, form
        t, n = int(ctx.t), ctx.n
        qs = [int(p) for p in ctx.q_primes]
        # y_i = phase_i * (q/q_i)^-1 mod q_i
        inv = [int(v) for v in np.asarray(ctx._crt_inv).reshape(-1)]
        # T_i = floor(t * 2^72 / q_i) (BFV) or floor(2^72 / q_i) (BGV's k), below 2^96
        T = [((t if form == "bfv" else 1) << 72) // q for q in qs]
        if any(v >> 96 for v in T):
            raise ValueError(f"t = {t} is too wide for the decrypt's 96-bit CRT constants")
        self._t = t
        self._t2 = mod64.split_u64(t)
        # decode-NTT twiddles mod t: bit-reversed psi powers
        pows = [1] * n
        for i in range(1, n):
            pows[i] = pows[i - 1] * ctx.encoder.psi % t
        psi_pows = [pows[r] for r in _bitrev(n)]
        self._kernel_inputs = (qs, t, T, inv, psi_pows, ctx.encoder._s2n)
        # the decrypt kernel's tables, built on a CUDA context only; the
        # plain version's (below) on first use
        self.kernel_tables = (decrypt_cuda.constants(*self._kernel_inputs, ctx.device)
                              if ctx.device.type == "cuda" else None)

    def _col(self, vals) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int64, device=self.ctx.device).reshape(-1, 1)

    @functools.cached_property
    def _crt_planes(self):
        """The plain CRT step's tables: y's Shoup constants per limb, T_i as
        three 32-bit planes (3, L, 1), and under BGV [q/q_i]_t and [q]_t as
        ``ops.mod64`` planes."""
        qs, t, T, inv = self._kernel_inputs[:4]
        inv_w = self._col(inv)
        inv_wq = self._col([shoup_host(v, q) for v, q in zip(inv, qs)])
        T3 = torch.stack([self._col([(v >> (32 * k)) & MASK32 for v in T]) for k in range(3)])
        bgv = None
        if self.form == "bgv":
            q = self.ctx.params.q
            h = [(q // p) % t for p in qs]  # [q/q_i]_t
            bgv = (tuple(self._col(c) for c in zip(*(mod64.split_u64(v) for v in h))),
                   tuple(self._col(c) for c in zip(*(mod64.shoup64_host(v, t) for v in h))),
                   (mod64.split_u64(q % t), mod64.shoup64_host(q % t, t)))
        return inv_w, inv_wq, T3, bgv

    @functools.cached_property
    def _psi_w(self):
        return mod64.planes(np.array(self._kernel_inputs[4], dtype=np.uint64), self.ctx.device)

    @functools.cached_property
    def _psi_wq(self):
        return mod64.planes(np.array([(v << 64) // self._t for v in self._kernel_inputs[4]],
                                     dtype=object), self.ctx.device)

    @functools.cached_property
    def _s2n(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self._kernel_inputs[5], np.int64)).to(self.ctx.device)

    def _phase(self, ct_data: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        """[c0 + c1*s]_q coefficients (..., L, N) int32 (degree 2 only)."""
        ctx = self.ctx
        ph = add_mod(
            ct_data[..., 0, :, :],
            mont_mul(ct_data[..., 1, :, :], s_mont, ctx.p, ctx.pinv),
            ctx.p,
        )
        return ctx._intt_fast(ph)

    def _mt_planes(self, phase: torch.Tensor):
        """phase (..., L, N) -> m = [x]_q's message mod t as (lo, hi) planes:
        round(t/q*[x]_q) mod t (BFV) or [x]_q mod t (BGV).

        S = sum_i y_i * T_i is gathered in four 32-bit columns: y_i < 2^31
        and each plane of T_i < 2^32, so every y_i * T_ik is one exact int64
        product, split into its low and high words, and each column sum of
        at most 2L words stays far below 2^63 until one carry pass."""
        inv_w, inv_wq, T3, bgv = self._crt_planes
        y = shoup_mul(phase, inv_w, inv_wq, self.ctx.p).long()  # (..., L, N)
        prods = [y * T3[k] for k in range(3)]
        lo = [(pk & MASK32).sum(dim=-2) for pk in prods]
        hi = [(pk >> 32).sum(dim=-2) for pk in prods]
        cols = [lo[0], hi[0] + lo[1], hi[1] + lo[2], hi[2]]
        cols[2] = cols[2] + (1 << 7)  # + 2^71 (rounding)
        for k in range(3):  # carry pass
            cols[k + 1] = cols[k + 1] + (cols[k] >> 32)
            cols[k] = cols[k] & MASK32
        # S >> 72 = m + k*t (BFV) or k (BGV) with k < L; t < 2^62 keeps it in int64
        m_plus = (cols[2] >> 8) + (cols[3] << 24)
        if self.form == "bfv":
            m = torch.remainder(m_plus, self._t)
            return m & MASK32, m >> 32
        h2, hq2, qt2 = bgv
        zero = torch.zeros_like(y)
        terms = mod64.shoup_mul2((y, zero), h2, hq2, self._t2)  # y_i [q/q_i]_t
        acc = terms[0][..., 0, :], terms[1][..., 0, :]
        for i in range(1, y.shape[-2]):
            acc = mod64.add2_mod(acc, (terms[0][..., i, :], terms[1][..., i, :]), self._t2)
        kq = mod64.shoup_mul2((m_plus, torch.zeros_like(m_plus)), *qt2, self._t2)
        return mod64.sub2_mod(acc, kq, self._t2)

    def _slot_planes(self, ct_data: torch.Tensor, s_mont: torch.Tensor):
        m2 = self._mt_planes(self._phase(ct_data, s_mont))
        lo, hi = mod64.ntt2_mod_t(m2, self._psi_w, self._psi_wq, self._t2)
        return lo[..., self._s2n], hi[..., self._s2n]

    def slots(self, ct_data: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        """Packed slot values in [0, t) as int64 (..., n), canonical slot
        order (the plain version on either device). ct_data: (..., 2, L, N)
        on this context's basis."""
        lo, hi = self._slot_planes(ct_data, s_mont)
        return lo | (hi << 32)

    def zero_mask(self, ct_data: torch.Tensor, s_mont: torch.Tensor,
                  length: int | None = None) -> torch.Tensor:
        """Decrypt straight to the per-slot zero mask (..., length) bool --
        the only artifact the PSI client's intersection extraction needs:
        the decrypt kernel on a CUDA tensor, the plain version on the CPU."""
        n = self.ctx.n
        length = n if length is None else length
        if ct_data.is_cuda:
            phase = self._phase(ct_data, s_mont)
            lead = phase.shape[:-2]
            mask = decrypt_cuda.zero_mask(phase.reshape(-1, *phase.shape[-2:]),
                                          *self.kernel_tables, self.form == "bgv", length)
            return mask.reshape(*lead, length)
        if not 0 <= length <= n:
            raise ValueError(f"length {length} outside [0, {n}]")
        lo, hi = self._slot_planes(ct_data, s_mont)
        return ((lo == 0) & (hi == 0))[..., :length]
