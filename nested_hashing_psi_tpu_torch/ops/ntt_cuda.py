"""K1 wrapper: the negacyclic NTT/iNTT, CUDA kernel (csrc/ntt.cu) on a CUDA
tensor, the plain PyTorch version (ops/ntt.py) on a CPU tensor.

Counterpart of ``nested_hashing_psi_tpu.ops.ntt_pallas.ntt_pallas`` /
``intt_pallas``: the same (..., L, n) contract, bit-exact with the plain
``ntt``/``intt``. A CUDA tensor always goes to the kernel; a failed build or
launch raises. ``launches`` counts kernel launches per direction (a CPU
call is not one).
"""

from __future__ import annotations

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.ntt import intt as intt_plain
from nested_hashing_psi_tpu_torch.ops.ntt import ntt as ntt_plain

launches = {"ntt": 0, "intt": 0}


def reset_launches() -> None:
    launches.update(ntt=0, intt=0)


def _check_input(x: torch.Tensor, plan: NTTPlan) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32 residues, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (plan.L, plan.n):
        raise ValueError(f"NTT input {tuple(x.shape)} is not (..., {plan.L}, {plan.n})")


def _launch(x: torch.Tensor, plan: NTTPlan, inverse: bool) -> torch.Tensor:
    _check_input(x, plan)
    x = x.contiguous()
    y = torch.empty_like(x)
    tb = plan.tensors(x.device)
    rows = x.numel() // plan.n
    lib = cuda_lib.get_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if inverse:
        rc = lib.nhpsi_ntt_inv(
            x.data_ptr(), y.data_ptr(), tb["ipsi_u32"].data_ptr(),
            tb["ninv_u32"].data_ptr(), tb["p_u32"].data_ptr(),
            rows, plan.L, plan.logn, stream,
        )
    else:
        rc = lib.nhpsi_ntt_fwd(
            x.data_ptr(), y.data_ptr(), tb["psi_u32"].data_ptr(),
            tb["p_u32"].data_ptr(), rows, plan.L, plan.logn, stream,
        )
    name = "intt" if inverse else "ntt"
    cuda_lib.check(rc, name)
    launches[name] += 1
    return y


def ntt(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward NTT of int32 residues (..., L, n) -> bit-reversed order."""
    if x.is_cuda:
        return _launch(x, plan, inverse=False)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    _check_input(x, plan)
    return ntt_plain(x, plan)


def intt(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse NTT of int32 residues (..., L, n) -> natural order."""
    if x.is_cuda:
        return _launch(x, plan, inverse=True)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    _check_input(x, plan)
    return intt_plain(x, plan)
