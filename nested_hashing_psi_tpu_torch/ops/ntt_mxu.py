"""K3: the negacyclic NTT as exact int8-digit matrix products.

Counterpart of ``nested_hashing_psi_tpu.ops.ntt_mxu``: the same contract as
K1 (natural -> canonical bit-reversed order, the inverse with 1/n folded
in), computed as the two stages of the four-step factorisation n = m1 * m2,

    forward  S = ((M1 @ X) * T) @ M2T        X = x viewed as (m1, m2)
    inverse  X = ((S @ iM2T) * iT) @ iM1

where every matrix product M @ X mod p runs on 7-bit digits: X splits into
five digits stacked along the contraction axis, G_i holds digit i of the
pre-scaled constants 2^(7j) * M mod p, and Q_i = G_i @ X_digits is exact in
int32 (Q_i <= 5 * m * 127^2 < 2^25). Three Montgomery products recombine
the five Q_i into S mod p.

``MxuNTTPlan`` builds the JAX package's tables on the host (pinned equal by
tests/test_torch_ntt_mxu.py). ``ntt_mxu_plain`` / ``intt_mxu_plain`` are the
plain PyTorch version: the digit products are float64 matmuls, exact because
every partial sum stays below 2^53. ``ntt_mxu`` / ``intt_mxu`` launch the
tensor-core kernel (csrc/ntt_mxu.cu, wgmma) on a CUDA tensor and take the
plain version on a CPU tensor only; ``launches`` counts kernel launches (a
call above n = 16384 runs one launch per stage: two). On the device the
plan keeps each G in the order and layout the kernel's shared-memory ring
consumes (``_device_stream``). Nothing in the package calls K3: like the JAX
package's, it is an op with its tests.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops import primes as primes_mod
from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, mont_constants, mont_mul
from nested_hashing_psi_tpu_torch.ops.ntt import bit_reverse_indices

DIGITS = 5
DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1
MMA_TILE = 16          # m1 and m2 must be multiples of this (core-matrix rows)
FUSED_MAX_N = 16384    # above this csrc/ntt_mxu.cu runs one stage per launch
MAX_N = 32768          # one stage's digit stack must fit in shared memory
# csrc/ntt_mxu.cu's wgmma geometry: bytes of K per k-step, k-steps per ring
# chunk, rows of one wgmma tile, output rows of one pass (two consumer
# warpgroups)
KSTEP, CHUNK_STEPS, TILE_ROWS, PASS_ROWS = 32, 4, 64, 128

launches = {"ntt": 0, "intt": 0}


def reset_launches() -> None:
    launches.update(ntt=0, intt=0)


def _plain_matrices(n: int, m1: int, p: int):
    """Plain-form four-step matrices mod p: M1 (m1,m1), T (m1,m2), M2T
    (m2,m2) and the inverses iM1, iT (1/n folded in), iM2T, as uint32.
    Every entry is a power of psi (order 2n), so one table of psi^e for
    e < 2n gives them all."""
    m2 = n // m1
    psi = primes_mod.primitive_root_of_unity(p, 2 * n)
    pw = np.empty(2 * n, dtype=np.uint64)
    cur = 1
    for e in range(2 * n):
        pw[e] = cur
        cur = cur * psi % p

    def psi_pow(e):
        return pw[np.mod(e, 2 * n)]

    j1 = bit_reverse_indices(m1)[:, None]          # row a -> j1 = rev(a)
    j2 = bit_reverse_indices(m2)
    k1 = np.arange(m1, dtype=np.int64)[None, :]
    k2 = np.arange(m2, dtype=np.int64)[None, :]
    pp = np.uint64(p)
    e1 = m2 * k1 + 2 * m2 * j1 * k1                # psi^(m2 k1) omega^(m2 j1 k1)
    et = k2 + 2 * j1 * k2                          # psi^k2 omega^(j1 k2)
    e2 = 2 * m1 * k2.T * j2[None, :]               # (k2, b): omega^(m1 j2 k2)
    M1 = psi_pow(e1)
    T = psi_pow(et)
    M2T = psi_pow(e2)
    iM1 = (psi_pow(-e1) * np.uint64(pow(m1, -1, p)) % pp).T
    iT = psi_pow(-et) * np.uint64(pow(m2, -1, p)) % pp
    iM2T = psi_pow(-e2).T
    return tuple(m.astype(np.uint32) for m in (M1, T, M2T, iM1, iT, iM2T))


def _digit_stack(M: np.ndarray, p: int, left: bool) -> np.ndarray:
    """G (DIGITS, m, DIGITS*k) int8 for S = M @ X with X digit-stacked along
    rows (left), or G (DIGITS, DIGITS*k, m) for S = X @ M with X stacked
    along columns; block j of G_i is digit i of 2^(7j) * M mod p."""
    blocks = []
    for j in range(DIGITS):
        Mj = M.astype(np.uint64) * np.uint64((1 << (DIGIT_BITS * j)) % p) % np.uint64(p)
        blocks.append([(Mj >> np.uint64(DIGIT_BITS * i)) & np.uint64(DIGIT_MASK)
                       for i in range(DIGITS)])
    axis = -1 if left else -2
    return np.stack(
        [np.concatenate([blocks[j][i] for j in range(DIGITS)], axis=axis)
         for i in range(DIGITS)]
    ).astype(np.int8)


def _digit_stack_left(M: np.ndarray, p: int) -> np.ndarray:
    return _digit_stack(M, p, left=True)


def _digit_stack_right(M: np.ndarray, p: int) -> np.ndarray:
    return _digit_stack(M, p, left=False)


def stage_geometry(left: bool, m1: int, m2: int) -> tuple[int, int, int]:
    """(passes, k-steps, rows) of one stage in csrc/ntt_mxu.cu: the output's
    m1 rows (padded to a 64-row wgmma tile) go in passes of 128; K = 5m is
    cut into 32-byte k-steps, padded to whole ring chunks of 4; a G matrix
    in one k-step has the pass's rows (left stage, G is the A operand) or m2
    rows (right stage, G transposed is the B operand)."""
    mp = max(TILE_ROWS, m1)
    passes = -(-mp // PASS_ROWS)
    chunk_k = CHUNK_STEPS * KSTEP
    ksteps = -(-DIGITS * (m1 if left else m2) // chunk_k) * CHUNK_STEPS
    return passes, ksteps, (min(mp, PASS_ROWS) if left else m2)


def _device_stream(G: np.ndarray, left: bool, m1: int, m2: int) -> np.ndarray:
    """G (L, DIGITS, m1, 5 m1) of a left stage or (L, DIGITS, 5 m2, m2) of a
    right one -> (L, bytes) int8, each prime's G in the order the kernel's
    ring consumes it: per pass (left only), per digit matrix, per k-step,
    one chunk, a rows x 32 K-major slice in 8-row x 16-byte core matrices
    (row groups 256 bytes apart, the two 16-byte halves of a k-step 128
    apart). The right stage's G is stored transposed, (b, k); padded rows
    and k are zero."""
    if not left:
        G = G.swapaxes(-1, -2)
    passes, ksteps, rows = stage_geometry(left, m1, m2)
    P = passes if left else 1
    L = G.shape[0]
    padded = np.zeros((L, DIGITS, P * rows, ksteps * KSTEP), np.int8)
    padded[:, :, :G.shape[2], :G.shape[3]] = G
    t = padded.reshape(L, DIGITS, P, rows // 8, 8, ksteps, 2, 16)
    return np.ascontiguousarray(t.transpose(0, 2, 1, 5, 3, 6, 4, 7).reshape(L, -1))


def _shoup_digit_weights(primes) -> np.ndarray:
    """(L, 2, DIGITS) uint32: w_i = 2^(7i) mod p and floor(w_i 2^32 / p),
    the kernel's Shoup pairs for folding Q_i into sum_i 2^(7i) Q_i mod p."""
    w = [[(1 << (DIGIT_BITS * i)) % p for i in range(DIGITS)] for p in primes]
    return np.array([[row, [(v << 32) // p for v in row]] for row, p in zip(w, primes)],
                    np.uint32)


@dataclass(eq=False)
class MxuNTTPlan:
    """Host tables of the JAX package's ``MxuNTTPlan`` (numpy, same values
    and layouts), plus per-device tensors built on first use."""

    n: int
    primes: tuple[int, ...]
    m1: int = 0

    def __post_init__(self):
        n = self.n
        if self.m1 == 0:
            self.m1 = 1 << (n.bit_length() // 2)
        self.m2 = n // self.m1
        m1, m2 = self.m1, self.m2
        assert m1 * m2 == n
        L = len(self.primes)
        self.G1 = np.zeros((L, DIGITS, m1, DIGITS * m1), np.int8)
        self.G2 = np.zeros((L, DIGITS, DIGITS * m2, m2), np.int8)
        self.iG1 = np.zeros((L, DIGITS, m1, DIGITS * m1), np.int8)
        self.iG2 = np.zeros((L, DIGITS, DIGITS * m2, m2), np.int8)
        self.tw = np.zeros((L, m1, m2), np.uint32)
        self.itw = np.zeros((L, m1, m2), np.uint32)
        # recombination constants c_k = 2^(7k) * 2^32 mod p for k in {0,2,4}
        self.rc = np.zeros((L, 3, 1, 1), np.uint32)
        self.p_arr = np.zeros((L, 1), np.uint32)
        self.pinv_arr = np.zeros((L, 1), np.uint32)
        for l, p in enumerate(self.primes):
            M1, T, M2T, iM1, iT, iM2T = _plain_matrices(n, m1, p)
            self.G1[l] = _digit_stack_left(M1, p)
            self.G2[l] = _digit_stack_right(M2T, p)
            self.iG1[l] = _digit_stack_left(iM1, p)
            self.iG2[l] = _digit_stack_right(iM2T, p)
            r = np.uint64((1 << 32) % p)
            self.tw[l] = T.astype(np.uint64) * r % np.uint64(p)
            self.itw[l] = iT.astype(np.uint64) * r % np.uint64(p)
            for idx, k in enumerate((0, 2, 4)):
                self.rc[l, idx] = ((1 << (DIGIT_BITS * k)) << 32) % p
            self.p_arr[l, 0] = p
            self.pinv_arr[l, 0] = mont_constants(p)[0]
        self._dev: dict = {}

    @property
    def L(self) -> int:
        return len(self.primes)

    def tensors(self, device) -> dict:
        """The tables on `device`: float64 digit matrices and int64
        constants for the plain version, and the kernel's operands (the G
        streams of ``_device_stream``, int32 bit-views of the uint32 tables)."""
        device = torch.device(device)
        if device not in self._dev:
            L = self.L

            def i64(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)

            def u32(a):
                return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

            self._dev[device] = {
                "G1": torch.from_numpy(self.G1.astype(np.float64)).to(device),
                "G2": torch.from_numpy(self.G2.astype(np.float64)).to(device),
                "iG1": torch.from_numpy(self.iG1.astype(np.float64)).to(device),
                "iG2": torch.from_numpy(self.iG2.astype(np.float64)).to(device),
                "tw": i64(self.tw),
                "itw": i64(self.itw),
                "rc": i64(self.rc.reshape(L, 3, 1, 1)),
                "p": i64(self.p_arr.reshape(L, 1, 1)),
                "pinv": i64(self.pinv_arr.reshape(L, 1, 1)),
            }
            if device.type == "cuda":
                def stream(G, left):
                    return torch.from_numpy(_device_stream(G, left, self.m1, self.m2)).to(device)

                self._dev[device].update(
                    G1_dev=stream(self.G1, True), G2_dev=stream(self.G2, False),
                    iG1_dev=stream(self.iG1, True), iG2_dev=stream(self.iG2, False),
                    tw_u32=u32(self.tw), itw_u32=u32(self.itw),
                    rc_u32=u32(_shoup_digit_weights(self.primes)),
                    p_u32=u32(self.p_arr[:, 0]), pinv_u32=u32(self.pinv_arr[:, 0]),
                )
        return self._dev[device]


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _digits(X: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 (..., m, k) -> float64 digit stack along `dim` (5 x wider)."""
    return torch.cat(
        [(X >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(DIGITS)], dim=dim
    ).double()


def _recombine(Q: torch.Tensor, tb: dict) -> torch.Tensor:
    """Q (B, L, DIGITS, m, k) exact digit products -> S = sum 2^(7i) Q_i
    mod p, as three Montgomery products (A, B < 2^32 after the shifts)."""
    Q = Q.long()
    p, pinv, rc = tb["p"], tb["pinv"], tb["rc"]
    A = Q[:, :, 0] + (Q[:, :, 1] << DIGIT_BITS)
    B = Q[:, :, 2] + (Q[:, :, 3] << DIGIT_BITS)
    S = add_mod(mont_mul(A, rc[:, 0], p, pinv), mont_mul(B, rc[:, 1], p, pinv), p)
    return add_mod(S, mont_mul(Q[:, :, 4], rc[:, 2], p, pinv), p)


def _stage_left(X, G, tb):
    """S = M @ X mod p; X (B, L, m1, m2), G (L, DIGITS, m1, DIGITS*m1)."""
    return _recombine(G[None] @ _digits(X, -2)[:, :, None], tb)


def _stage_right(X, G, tb):
    """S = X @ M mod p; X (B, L, m1, m2), G (L, DIGITS, DIGITS*m2, m2)."""
    return _recombine(_digits(X, -1)[:, :, None] @ G[None], tb)


def _mxu_plain(x: torch.Tensor, plan: MxuNTTPlan, inverse: bool) -> torch.Tensor:
    _check_input(x, plan)
    tb = plan.tensors(x.device)
    X = x.reshape(-1, plan.L, plan.m1, plan.m2).long()
    if inverse:
        D = _stage_right(X, tb["iG2"], tb)
        C = mont_mul(D, tb["itw"], tb["p"], tb["pinv"])
        out = _stage_left(C.long(), tb["iG1"], tb)
    else:
        C = _stage_left(X, tb["G1"], tb)
        D = mont_mul(C, tb["tw"], tb["p"], tb["pinv"])
        out = _stage_right(D.long(), tb["G2"], tb)
    return out.reshape(x.shape)


def ntt_mxu_plain(x: torch.Tensor, plan: MxuNTTPlan) -> torch.Tensor:
    """Forward NTT of int32 residues (..., L, n) -> bit-reversed order."""
    return _mxu_plain(x, plan, inverse=False)


def intt_mxu_plain(x: torch.Tensor, plan: MxuNTTPlan) -> torch.Tensor:
    """Inverse NTT of int32 residues (..., L, n) -> natural order."""
    return _mxu_plain(x, plan, inverse=True)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor, plan: MxuNTTPlan) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32 residues, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (plan.L, plan.n):
        raise ValueError(f"NTT input {tuple(x.shape)} is not (..., {plan.L}, {plan.n})")


def _launch(x: torch.Tensor, plan: MxuNTTPlan, inverse: bool) -> torch.Tensor:
    _check_input(x, plan)
    if plan.m1 % MMA_TILE or plan.m2 % MMA_TILE:
        raise ValueError(
            f"K3 needs m1 = {plan.m1} and m2 = {plan.m2} to be multiples of "
            f"{MMA_TILE} (ring {plan.n} is too small)"
        )
    if plan.n > MAX_N:
        raise ValueError(f"K3 supports rings up to {MAX_N}, not {plan.n}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # rows are read by bulk copies and 16-byte loads
        x = x.clone()
    y = torch.empty_like(x)
    tmp = torch.empty_like(x) if plan.n > FUSED_MAX_N else None
    tb = plan.tensors(x.device)
    if inverse:
        ga, gb, tw = tb["iG2_dev"], tb["iG1_dev"], tb["itw_u32"]
    else:
        ga, gb, tw = tb["G1_dev"], tb["G2_dev"], tb["tw_u32"]
    launched = ctypes.c_int(0)
    rc = cuda_lib.get_lib().nhpsi_ntt_mxu(
        x.data_ptr(), y.data_ptr(), None if tmp is None else tmp.data_ptr(),
        ga.data_ptr(), gb.data_ptr(), tw.data_ptr(), tb["rc_u32"].data_ptr(),
        tb["p_u32"].data_ptr(), tb["pinv_u32"].data_ptr(),
        x.numel() // plan.n, plan.L, plan.m1, plan.m2, int(inverse),
        ctypes.byref(launched), torch.cuda.current_stream(x.device).cuda_stream,
    )
    name = "intt" if inverse else "ntt"
    launches[name] += launched.value
    cuda_lib.check(rc, f"{name}_mxu")
    return y


def ntt_mxu(x: torch.Tensor, plan: MxuNTTPlan) -> torch.Tensor:
    """Forward NTT (..., L, n) int32 -> bit-reversed order: the tensor-core
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.is_cuda:
        return _launch(x, plan, inverse=False)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return ntt_mxu_plain(x, plan)


def intt_mxu(x: torch.Tensor, plan: MxuNTTPlan) -> torch.Tensor:
    """Inverse NTT (..., L, n) int32 (bit-reversed) -> natural order."""
    if x.is_cuda:
        return _launch(x, plan, inverse=True)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return intt_mxu_plain(x, plan)
