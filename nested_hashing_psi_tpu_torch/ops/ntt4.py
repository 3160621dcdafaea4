"""Four-step negacyclic NTT: n = m1*m2 as two batched modular matrix products.

Counterpart of ``nested_hashing_psi_tpu.ops.ntt4``, bit-exact with
``ops.ntt`` (the same canonical bit-reversed output order):

    canonical(m1 x m2) = ((M1 @ A) * T) @ M2T,   A = a.reshape(m1, m2)
    inverse            = iM1 @ ((S @ iM2T) * iT)

The psi pre-twist, the mid twiddles and the bit reversals of both output
index halves live in the constant matrices, made once by
``ops.ntt_mxu._plain_matrices`` (the same matrices the tensor-core NTT
splits into digits) and turned into Montgomery form here. That function
folds 1/m2 into iT where the JAX package folds it into iM2T; every product
is reduced mod p, so the transforms are bit-equal either way.

The four-step form is the basis of the Ulysses-style distributed NTT
(``parallel.dist_ntt.dist_ntt_fns``): stage 1 contracts over m1 and is
local when the m2 axis is sharded, stage 2 contracts over m2 and is local
when m1 is sharded, with one all-to-all between them. Plain PyTorch on
int64-widened residues; per element it costs O(m1 + m2) products against
O(log n) for the butterfly NTT, so single-device transforms use K1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants, mont_mul
from nested_hashing_psi_tpu_torch.ops.ntt_mxu import _plain_matrices


@dataclass(eq=False)
class FourStepPlan:
    """Montgomery-form matrices per prime, stacked (L, ., .) uint32 as in
    the JAX package: M1 (m1, m1), T (m1, m2), M2T (m2, m2) and the inverses
    iM1, iT, iM2T; ``tensors(device)`` lifts them to int64 once per device."""

    n: int
    primes: tuple[int, ...]
    m1: int = 0

    def __post_init__(self):
        if self.m1 == 0:
            self.m1 = 1 << ((self.n.bit_length() - 1 + 1) // 2)
        self.m2 = self.n // self.m1
        assert self.m1 * self.m2 == self.n
        mats = []
        for p in self.primes:
            r = np.uint64((1 << 32) % p)
            mats.append([(m.astype(np.uint64) * r % np.uint64(p)).astype(np.uint32)
                         for m in _plain_matrices(self.n, self.m1, p)])
        self.M1, self.T, self.M2T, self.iM1, self.iT, self.iM2T = (
            np.stack(x) for x in zip(*mats))
        L = len(self.primes)
        self.p_arr = np.array(self.primes, np.uint32).reshape(L, 1, 1)
        self.pinv_arr = np.array(
            [mont_constants(p)[0] for p in self.primes], np.uint32).reshape(L, 1, 1)
        self._dev: dict = {}

    @property
    def L(self) -> int:
        return len(self.primes)

    def tensors(self, device) -> dict:
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {
                name: torch.from_numpy(getattr(self, name).astype(np.int64)).to(device)
                for name in ("M1", "T", "M2T", "iM1", "iT", "iM2T", "p_arr", "pinv_arr")
            }
        return self._dev[device]


# contraction terms summed per step: each step is a few broadcast kernels
# over (..., KCHUNK, ...) products, so the launches per stage fall KCHUNK-fold
KCHUNK = 16


def _contract(terms, p):
    """Sum of canonical residues (< 2^31 each) along a chunked contraction,
    exact in int64 and reduced once."""
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return (acc % p).int()


def _matmul_left(M, x, p, pinv):
    """result[..., L, a, j] = sum_k M[L, a, k] * x[..., L, k, j] mod p
    (M in Montgomery form)."""
    K = M.shape[2]
    return _contract(
        (mont_mul(x[..., None, k : k + KCHUNK, :], M[:, :, k : k + KCHUNK, None], p[..., None],
                  pinv[..., None]).long().sum(dim=-2) for k in range(0, K, KCHUNK)), p)


def _matmul_right(x, M, p, pinv):
    """result[..., L, a, b] = sum_k x[..., L, a, k] * M[L, k, b] mod p."""
    K = M.shape[1]
    return _contract(
        (mont_mul(x[..., k : k + KCHUNK, None], M[:, None, k : k + KCHUNK, :], p[..., None],
                  pinv[..., None]).long().sum(dim=-2) for k in range(0, K, KCHUNK)), p)


def ntt4(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Forward four-step NTT, bit-exact with ops.ntt.ntt. x: (..., L, n) int32."""
    tb = plan.tensors(x.device)
    p, pinv = tb["p_arr"], tb["pinv_arr"]
    X = x.reshape(*x.shape[:-2], plan.L, plan.m1, plan.m2)
    C = _matmul_left(tb["M1"], X, p, pinv)
    D = mont_mul(C, tb["T"], p, pinv)
    return _matmul_right(D, tb["M2T"], p, pinv).reshape(x.shape)


def intt4(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Inverse four-step NTT, bit-exact with ops.ntt.intt."""
    tb = plan.tensors(x.device)
    p, pinv = tb["p_arr"], tb["pinv_arr"]
    X = x.reshape(*x.shape[:-2], plan.L, plan.m1, plan.m2)
    D = _matmul_right(X, tb["iM2T"], p, pinv)
    C = mont_mul(D, tb["iT"], p, pinv)
    return _matmul_left(tb["iM1"], C, p, pinv).reshape(x.shape)
