"""The packed encode on the context's device: slot values to Montgomery
NTT-domain plaintexts, bit-equal to ``BGVContext.make_plaintext_mont``.

The host encode (``fhe.encoding.PackedEncoder``, ``BGVContext._encode_rns``)
reduces slot values mod t, places them at the canonical slots, takes the
inverse negacyclic NTT mod t (object arrays or a C++ helper for t > 2^31),
lifts each coefficient to its centred value and reduces it mod each q_i.
This does the same on tensors, in the two-plane Shoup-64 arithmetic of
``ops.mod64`` (one algorithm for every t below 2^62), then K1 and the
Montgomery form as the host path's ``make_plaintext_mont`` does. Slot values
arrive as int64 tensors holding 64-bit words; ``fold`` multiplies them by
per-slot values below t (the server's masks) on the way in.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import mod64
from nested_hashing_psi_tpu_torch.ops.modmath import MASK32, to_mont
from nested_hashing_psi_tpu_torch.ops.refmodel import _bitrev


def _planes(x: torch.Tensor):
    """int64 words (uint64 bits) -> (lo, hi) planes."""
    return x & MASK32, (x >> 32) & MASK32


class DeviceEncoder:
    """The encode constants of one context, as tensors on its device."""

    def __init__(self, ctx):
        self.ctx = ctx
        t, n, dev = int(ctx.t), ctx.n, ctx.device
        self._t2 = mod64.split_u64(t)
        ipsi = pow(ctx.encoder.psi, -1, t)
        pows = [1] * n
        for i in range(1, n):
            pows[i] = pows[i - 1] * ipsi % t
        tw = [pows[r] for r in _bitrev(n)]
        self._tw = mod64.planes(np.array(tw, dtype=np.uint64), dev)
        self._twq = mod64.planes(np.array([(v << 64) // t for v in tw], dtype=object), dev)
        ninv = pow(n, -1, t)
        self._ninv = mod64.split_u64(ninv), mod64.shoup64_host(ninv, t)
        self._one = mod64.split_u64(1), mod64.shoup64_host(1, t)
        c = (1 << 64) % t  # for the Shoup quotients of values that are not constants
        self._c = mod64.split_u64(c), mod64.shoup64_host(c, t)
        self._tinv = mod64.split_u64(pow(t, -1, 1 << 64))
        self._s2n = torch.from_numpy(np.asarray(ctx.encoder._s2n, np.int64)).to(dev)
        self._neg = ctx._col([p - t % p for p in ctx.q_primes])  # [-t]_{q_i}

    def reduce(self, x: torch.Tensor):
        """int64 words -> their values mod t, as planes."""
        return mod64.shoup_mul2(_planes(x), *self._one, self._t2)

    def quotient(self, w):
        """Planes w < t that are not constants -> their Shoup quotients."""
        return mod64.shoup_quotient2(w, *self._c, self._tinv, self._t2)

    def fold(self, x: torch.Tensor, w, wq):
        """int64 words times planes w < t (Shoup quotients wq), mod t."""
        return mod64.shoup_mul2(_planes(x), w, wq, self._t2)

    def plaintext_mont(self, slots2) -> torch.Tensor:
        """Slot values in [0, t) as planes (rows, m), m <= n -> (rows, L, n)
        int32 Montgomery NTT-domain plaintexts."""
        lo, hi = slots2
        rows, m = lo.shape
        ctx, idx = self.ctx, self._s2n[:m]
        evals = []
        for plane in (lo, hi):
            e = torch.zeros((rows, ctx.n), dtype=torch.int64, device=plane.device)
            e[:, idx] = plane
            evals.append(e)
        c_lo, c_hi = mod64.intt2_mod_t(evals, self._tw, self._twq, *self._ninv, self._t2)
        coeffs = (c_lo | (c_hi << 32))[:, None, :]  # (rows, 1, n), below t < 2^62
        res = coeffs % ctx.p
        lift = torch.where(coeffs > ctx.t // 2, (res + self._neg) % ctx.p, res)
        return to_mont(ctx._ntt_fast(lift.int()), ctx.p, ctx.pinv, ctx.r2)
