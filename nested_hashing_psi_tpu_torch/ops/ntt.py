"""Negacyclic NTT/iNTT over RNS limb tensors: tables and the plain version.

Counterpart of ``nested_hashing_psi_tpu.ops.ntt``: the same merged-twiddle
Cooley-Tukey forward (natural -> canonical bit-reversed order) and
Gentleman-Sande inverse (bit-reversed -> natural, including 1/n), with the
same Shoup twiddle tables. ``ntt``/``intt`` here are the plain PyTorch
version of the CUDA kernel in ``ops/ntt_cuda.py``; the main path calls the
wrapper there, which takes this version only for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import primes as primes_mod
from nested_hashing_psi_tpu_torch.ops.modmath import (
    add_mod,
    mont_constants,
    shoup_host,
    shoup_mul,
    sub_mod,
)


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev.astype(np.int64)


@dataclass
class NTTPlan:
    """Per-(ring dim, prime set) twiddle tables, built once on the host as
    numpy uint32 arrays (the JAX package's exact layout), with per-device
    tensor views built on first use (``tensors``)."""

    n: int
    primes: tuple[int, ...]
    # twiddles are (L, 2, n) with axis 1 packing the Shoup pair
    # [value, floor(value * 2^32 / p)]
    psi_rev: np.ndarray = field(init=False)       # (L, 2, n)
    psi_inv_rev: np.ndarray = field(init=False)   # (L, 2, n)
    n_inv: np.ndarray = field(init=False)         # (L, 2, 1) n^-1 Shoup pair
    # the CUDA kernel's inverse scale, folded into its last stage:
    # [n^-1, quotient, psi_inv_rev[1] * n^-1, quotient]
    inv_scale: np.ndarray = field(init=False)     # (L, 4)
    p_arr: np.ndarray = field(init=False)         # (L, 1)
    pinv_arr: np.ndarray = field(init=False)      # (L, 1)
    r2_arr: np.ndarray = field(init=False)        # (L, 1)

    def __post_init__(self):
        n, ps = self.n, self.primes
        assert n & (n - 1) == 0
        L = len(ps)
        rev = bit_reverse_indices(n)
        psi_rev = np.zeros((L, 2, n), dtype=np.uint32)
        psi_inv_rev = np.zeros((L, 2, n), dtype=np.uint32)
        n_inv = np.zeros((L, 2, 1), dtype=np.uint32)
        inv_scale = np.zeros((L, 4), dtype=np.uint32)
        p_arr = np.zeros((L, 1), dtype=np.uint32)
        pinv_arr = np.zeros((L, 1), dtype=np.uint32)
        r2_arr = np.zeros((L, 1), dtype=np.uint32)
        for l, p in enumerate(ps):
            psi = primes_mod.primitive_root_of_unity(p, 2 * n)
            psi_pows = [1] * n
            for i in range(1, n):
                psi_pows[i] = psi_pows[i - 1] * psi % p
            psi_inv = pow(psi, -1, p)
            ipsi_pows = [1] * n
            for i in range(1, n):
                ipsi_pows[i] = ipsi_pows[i - 1] * psi_inv % p
            w = np.array(psi_pows, dtype=np.uint64)[rev]
            iw = np.array(ipsi_pows, dtype=np.uint64)[rev]
            psi_rev[l, 0] = w
            psi_rev[l, 1] = (w << np.uint64(32)) // np.uint64(p)
            psi_inv_rev[l, 0] = iw
            psi_inv_rev[l, 1] = (iw << np.uint64(32)) // np.uint64(p)
            ninv = pow(n, -1, p)
            n_inv[l, 0, 0], n_inv[l, 1, 0] = ninv, shoup_host(ninv, p)
            w1ninv = int(iw[1]) * ninv % p
            inv_scale[l] = ninv, shoup_host(ninv, p), w1ninv, shoup_host(w1ninv, p)
            pinv, r2 = mont_constants(p)
            p_arr[l, 0] = p
            pinv_arr[l, 0] = pinv
            r2_arr[l, 0] = r2
        self.psi_rev = psi_rev
        self.psi_inv_rev = psi_inv_rev
        self.n_inv = n_inv
        self.inv_scale = inv_scale
        self.p_arr = p_arr
        self.pinv_arr = pinv_arr
        self.r2_arr = r2_arr
        self._dev: dict = {}

    @property
    def L(self) -> int:
        return len(self.primes)

    @property
    def logn(self) -> int:
        return self.n.bit_length() - 1

    def tensors(self, device) -> dict:
        """The tables on `device`: int64 copies for the plain version and
        int32 bit-views of the uint32 tables for the CUDA kernels. The NTT
        kernel reads each twiddle as one 8-byte [value, quotient] pair:
        ``psi_pairs_u32``/``ipsi_pairs_u32`` are (L, n, 2), the (L, 2, n)
        tables with their last two axes swapped."""
        device = torch.device(device)
        if device not in self._dev:
            def i64(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)

            def u32(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a).view(np.int32)
                ).to(device)

            self._dev[device] = {
                "psi": i64(self.psi_rev),
                "ipsi": i64(self.psi_inv_rev),
                "ninv": i64(self.n_inv),
                "p": i64(self.p_arr),
                "pinv": i64(self.pinv_arr),
                "r2": i64(self.r2_arr),
                "psi_pairs_u32": u32(self.psi_rev.transpose(0, 2, 1)),
                "ipsi_pairs_u32": u32(self.psi_inv_rev.transpose(0, 2, 1)),
                "iscale_u32": u32(self.inv_scale),
                "p_u32": u32(self.p_arr[:, 0]),
                "pinv_u32": u32(self.pinv_arr[:, 0]),
            }
        return self._dev[device]


def ntt(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward negacyclic NTT. x: int32 (..., L, n) -> (..., L, n) (bit-rev order)."""
    n, L = plan.n, plan.L
    bshape = x.shape[:-2]
    assert x.shape[-2:] == (L, n), (x.shape, L, n)
    tb = plan.tensors(x.device)
    psi = tb["psi"]
    p = tb["p"][:, :, None]                   # (L,1,1)
    m, t = 1, n
    for _ in range(plan.logn):
        t //= 2
        x = x.reshape(*bshape, L, m, 2, t)
        sw = psi[:, 0, m:2 * m][:, :, None]  # (L, m, 1)
        sq = psi[:, 1, m:2 * m][:, :, None]
        u = x[..., 0, :]
        v = shoup_mul(x[..., 1, :], sw, sq, p)
        x = torch.stack([add_mod(u, v, p), sub_mod(u, v, p)], dim=-2)
        m *= 2
    return x.reshape(*bshape, L, n)


def intt(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse negacyclic NTT. x: int32 (..., L, n) (bit-rev) -> natural order."""
    n, L = plan.n, plan.L
    bshape = x.shape[:-2]
    assert x.shape[-2:] == (L, n), (x.shape, L, n)
    tb = plan.tensors(x.device)
    ipsi = tb["ipsi"]
    p = tb["p"][:, :, None]
    m, t = n, 1
    while m > 1:
        h = m // 2
        x = x.reshape(*bshape, L, h, 2, t)
        sw = ipsi[:, 0, h:2 * h][:, :, None]
        sq = ipsi[:, 1, h:2 * h][:, :, None]
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = torch.stack(
            [add_mod(u, v, p), shoup_mul(sub_mod(u, v, p), sw, sq, p)], dim=-2
        )
        t *= 2
        m = h
    x = x.reshape(*bshape, L, n)
    ninv = tb["ninv"]
    return shoup_mul(x, ninv[:, 0], ninv[:, 1], tb["p"])
