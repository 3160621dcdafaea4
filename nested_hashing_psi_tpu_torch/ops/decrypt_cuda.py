"""The client's decrypt kernel (csrc/decrypt.cu): phase coefficients to the
per-slot zero mask in one launch, for BFV-form and BGV-form results.

``zero_mask`` launches the kernel on a CUDA tensor and raises on anything
else: the plain PyTorch version of the same function is
``fhe.device_decrypt.DeviceDecryptor`` on a CPU tensor, which calls this
wrapper only for CUDA tensors. ``constants`` builds the kernel's tables once
per (context, form); their layout is the kernel's (``kHead`` and
``kLimbWords`` in decrypt.cu). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.modmath import shoup_host

MIN_N, MAX_N = 16, 32768
HEAD, LIMB_WORDS = 4, 8  # decrypt.cu's kHead, kLimbWords

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _u64_tensor(vals, device) -> torch.Tensor:
    """uint64 values as the int64 tensor of the same bits."""
    return torch.from_numpy(np.array(vals, dtype=np.uint64).view(np.int64)).to(device)


def constants(q_primes, t: int, fixed, crt_inv, psi_rev, s2n, device):
    """The kernel's tables: (consts, psi, s2n).

    consts (HEAD + LIMB_WORDS * L,) uint64 bits: t, [q]_t and its 64-bit
    Shoup quotient, then per limb q_i, (q/q_i)^-1 mod q_i and its 32-bit
    Shoup quotient, the low and high words of the fixed-point constant
    ``fixed`` (floor(t 2^72 / q_i) for BFV, floor(2^72 / q_i) for BGV; the
    caller holds it below 2^96), [q/q_i]_t and its 64-bit Shoup quotient.
    psi (2n,) uint64 bits: the bit-reversed psi powers mod t, then their
    Shoup quotients. s2n (n,) int32: the NTT position of each slot."""
    qs = [int(p) for p in q_primes]
    q = math.prod(qs)
    head = [t, q % t, (q % t << 64) // t, 0]
    limbs = []
    for p, inv, f in zip(qs, crt_inv, fixed):
        inv, f, h = int(inv), int(f), (q // p) % t
        limbs += [p, inv, shoup_host(inv, p), f & (2**64 - 1), f >> 64, h, (h << 64) // t, 0]
    psi_rev = [int(v) for v in psi_rev]
    return (_u64_tensor(head + limbs, device),
            _u64_tensor(psi_rev + [(v << 64) // t for v in psi_rev], device),
            torch.from_numpy(np.asarray(s2n, np.int32)).to(device))


def zero_mask(phase: torch.Tensor, consts: torch.Tensor, psi: torch.Tensor,
              s2n: torch.Tensor, bgv: bool, length: int) -> torch.Tensor:
    """(rows, L, n) int32 phase on a CUDA device -> (rows, length) bool, True
    where the slot decrypts to 0. The kernel splits a row over a cluster of
    one block per 2048 coefficients, at most 8; no rows or no slots launch
    nothing."""
    global launches
    if not phase.is_cuda:
        raise ValueError(f"the decrypt kernel takes a CUDA tensor, got {phase.device}")
    if phase.dtype != torch.int32 or phase.dim() != 3:
        raise TypeError(f"phase must be (rows, L, n) int32, got {tuple(phase.shape)} "
                        f"{phase.dtype}")
    rows, L, n = phase.shape
    logn = n.bit_length() - 1
    if not MIN_N <= n <= MAX_N or n != 1 << logn:
        raise ValueError(f"the decrypt kernel takes n a power of two in [{MIN_N}, {MAX_N}], "
                         f"got {n}")
    if tuple(consts.shape) != (HEAD + LIMB_WORDS * L,) or tuple(psi.shape) != (2 * n,) \
            or tuple(s2n.shape) != (n,):
        raise ValueError(f"constants {tuple(consts.shape)}, {tuple(psi.shape)}, "
                         f"{tuple(s2n.shape)} do not fit L = {L}, n = {n}")
    if consts.dtype != torch.int64 or psi.dtype != torch.int64 or s2n.dtype != torch.int32:
        raise TypeError("consts and psi must be int64 bit views, s2n int32")
    if any(c.device != phase.device or not c.is_contiguous() for c in (consts, psi, s2n)):
        raise ValueError(f"the constants must be contiguous on {phase.device}")
    if not 0 <= length <= n:
        raise ValueError(f"length {length} outside [0, {n}]")
    out = torch.empty((rows, length), dtype=torch.bool, device=phase.device)
    if rows == 0 or length == 0:
        return out
    phase = phase.contiguous()
    stream = torch._C._cuda_getCurrentRawStream(phase.device.index)
    rc = cuda_lib.get_lib().nhpsi_decrypt_mask(
        phase.data_ptr(), out.data_ptr(), consts.data_ptr(), psi.data_ptr(), s2n.data_ptr(),
        rows, L, logn, length, int(bgv), stream)
    cuda_lib.check(rc, "decrypt_mask")
    launches += 1
    return out
