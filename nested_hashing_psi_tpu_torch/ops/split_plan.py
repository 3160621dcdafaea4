"""The split (four-step) NTT's per-stage row tables, host numpy.

The port's own copy of the tables of ``SplitNTTPlan`` in
``nested_hashing_psi_tpu.ops.ntt_pallas`` (that module imports jax), with
only the tables that the NTT probes under ``benchmarks/`` read: the CT
stage tables ``s1``, the GS stage tables ``s2``, the elementwise twiddle
``tw``, their regrouped ``v2`` forms and the primes. The values are the JAX
plan's, bit for bit (tests/test_torch_probe_ntt.py).

Tables (numpy uint32); axis 1 packs the Shoup pair [value, quotient]:
  s1  (L, 2, log_m1, m1, 1)  CT stage k: row r -> phi^rev[m + r//(2t)]
  s2  (L, 2, log_m2, m2, 1)  GS stage k: row r -> w^((m2/t) * (r mod h))
  tw  (L, 2, m1, m2)         psi^k2 * omega^(rev_m1(a) * k2)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import primes as primes_mod
from nested_hashing_psi_tpu_torch.ops.ntt import bit_reverse_indices

# Minimum pair distance of the split (u/v) stage form on the TPU; the v2
# tables lift the stages below it into regrouped row space.
SPLIT_MIN_T = 8


def _log2(x: int) -> int:
    assert x & (x - 1) == 0 and x > 0
    return x.bit_length() - 1


def _pow_table(base: int, count: int, p: int) -> list[int]:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % p
    return out


def _use_regroup(M: int) -> bool:
    """Whether the v2 tables lift the sub-tile stages of an M-point half
    into regrouped row space (M/8 >= 8 keeps every scaled pair distance
    t*(M/8) >= SPLIT_MIN_T)."""
    return M >= 64


def _regroup_perm(M: int) -> np.ndarray:
    """idx such that regrouped_row[r'] = natural_row[idx[r']]: the regroup
    sends row blk*8 + off to off*(M/8) + blk."""
    R = M // 8
    rp = np.arange(M)
    return (rp % R) * 8 + rp // R


def _shoup_pairs(vals: np.ndarray, p: int) -> np.ndarray:
    """(..., ) values < p -> (2, ...) uint32 [value, floor(value 2^32 / p)]."""
    v = vals.astype(np.uint64)
    return np.stack([v, (v << np.uint64(32)) // np.uint64(p)]).astype(np.uint32)


@dataclass(eq=False)
class SplitNTTPlan:
    """The split NTT's stage tables for ring ``n`` and ``primes``, with the
    JAX plan's default split: m1 = 2^ceil(log2(n)/2), m2 = n / m1."""

    n: int
    primes: tuple[int, ...]

    def __post_init__(self):
        n = self.n
        self.m1 = 1 << ((_log2(n) + 1) // 2)
        self.m2 = n // self.m1
        m1, m2 = self.m1, self.m2
        assert m1 * m2 == n and m1 >= 2 and m2 >= 2
        L = len(self.primes)
        log1, log2_ = _log2(m1), _log2(m2)
        rev1 = bit_reverse_indices(m1)
        s1 = np.zeros((L, 2, log1, m1, 1), np.uint32)
        s2 = np.zeros((L, 2, log2_, m2, 1), np.uint32)
        tw = np.zeros((L, 2, m1, m2), np.uint32)
        p_arr = np.zeros((L, 1), np.uint32)
        rows1, rows2 = np.arange(m1), np.arange(m2)
        for l, p in enumerate(self.primes):
            psi = primes_mod.primitive_root_of_unity(p, 2 * n)
            omega = psi * psi % p
            phi = pow(psi, m2, p)          # primitive 2*m1-th root
            w = pow(omega, m1, p)          # primitive m2-th root
            phi_pows = np.array(_pow_table(phi, m1, p), np.int64)
            t1_full = phi_pows[rev1]
            # stage-1 CT: stage k has m = 2^k groups of span 2t, twiddle per group
            for k in range(log1):
                t = m1 >> (k + 1)
                s1[l, :, k, :, 0] = _shoup_pairs(t1_full[(1 << k) + rows1 // (2 * t)], p)
            # stage-2 GS: block t = m2 >> k, half h; twiddle w^((m2/t) (r mod h))
            w_pows = np.array(_pow_table(w, m2, p), np.int64)
            for k in range(log2_):
                t = m2 >> k
                s2[l, :, k, :, 0] = _shoup_pairs(w_pows[((m2 // t) * (rows2 % (t // 2))) % m2], p)
            # psi^k2 * omega^(rev1[a] * k2); omega has order n
            psi_pows = np.array(_pow_table(psi, m2, p), np.int64)
            omega_pows = np.array(_pow_table(omega, n, p), np.int64)
            ex = (rev1[:, None] * rows2[None, :]) % n
            tw[l] = _shoup_pairs(psi_pows[None, :] * omega_pows[ex] % p, p)
            p_arr[l, 0] = p
        self.s1, self.s2, self.tw, self.p_arr = s1, s2, tw, p_arr
        self.log1, self.log2 = log1, log2_

        # v2 tables: the rows of the sub-tile stages (t < SPLIT_MIN_T)
        # permuted into regrouped row space
        def v2_tables(tab, M):
            out = tab.copy()
            if not _use_regroup(M):
                return out
            idx = _regroup_perm(M)
            for k in range(tab.shape[2]):
                if (M >> (k + 1)) < SPLIT_MIN_T:
                    out[:, :, k] = tab[:, :, k][:, :, idx]
            return out

        self.s1_v2 = v2_tables(s1, m1)
        self.s2_v2 = v2_tables(s2, m2)
        self._dev: dict = {}

    def tensors(self, device) -> dict:
        """The tables the probes' kernels read, as int32 bit views on
        ``device`` (built once per device): s1_v2, s2_v2 (L, 2, log, m, 1),
        tw (L, 2, m1, m2) and p (L,)."""
        device = torch.device(device)
        if device not in self._dev:
            def u32(a):
                return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

            self._dev[device] = {"s1_v2": u32(self.s1_v2), "s2_v2": u32(self.s2_v2),
                                 "tw": u32(self.tw), "p": u32(self.p_arr[:, 0])}
        return self._dev[device]

    @property
    def L(self) -> int:
        return len(self.primes)
