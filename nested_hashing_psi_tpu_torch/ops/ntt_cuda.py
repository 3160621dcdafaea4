"""K1 wrapper: the negacyclic NTT/iNTT, CUDA kernel (csrc/ntt.cu) on a CUDA
tensor, the plain PyTorch version (ops/ntt.py) on a CPU tensor.

Counterpart of ``nested_hashing_psi_tpu.ops.ntt_pallas.ntt_pallas`` /
``intt_pallas``: the same (..., L, n) contract, bit-exact with the plain
``ntt``/``intt``. A CUDA tensor always goes to the kernel; a failed build or
launch raises. ``launches`` counts kernel launches per direction (a CPU call
is none; a call in the split form launches two kernels). The kernel takes
the split form from n = 1024 up, else the whole-row one;
``_launch(..., form=...)`` forces one, for measuring the two forms against
each other.
"""

from __future__ import annotations

import ctypes

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.ntt import intt as intt_plain
from nested_hashing_psi_tpu_torch.ops.ntt import ntt as ntt_plain

WHOLE_ROW, SPLIT = 1, 2  # the forms _launch can force
MIN_N, MAX_N = 16, 32768

launches = {"ntt": 0, "intt": 0}


def reset_launches() -> None:
    launches.update(ntt=0, intt=0)


def _check_input(x: torch.Tensor, plan: NTTPlan) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32 residues, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (plan.L, plan.n):
        raise ValueError(f"NTT input {tuple(x.shape)} is not (..., {plan.L}, {plan.n})")


def _launch(x: torch.Tensor, plan: NTTPlan, inverse: bool, form: int | None = None) -> torch.Tensor:
    """Run the CUDA kernel on a CUDA tensor, in the form chosen from n, or
    in ``form`` (WHOLE_ROW or SPLIT)."""
    _check_input(x, plan)
    if not MIN_N <= plan.n <= MAX_N:
        raise ValueError(f"the NTT kernel takes n in [{MIN_N}, {MAX_N}], got {plan.n}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel moves residues in 16-byte vectors
        x = x.clone()
    y = torch.empty_like(x)
    tb = plan.tensors(x.device)
    tw = tb["ipsi_pairs_u32" if inverse else "psi_pairs_u32"]
    lib = cuda_lib.get_lib()
    args = [x.data_ptr(), y.data_ptr(), tw.data_ptr(), tb["iscale_u32"].data_ptr(),
            tb["p_u32"].data_ptr(), x.numel() // plan.n, plan.L, plan.logn, int(inverse)]
    grids = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if form is None:
        rc = lib.nhpsi_ntt(*args, ctypes.byref(grids), stream)
    else:
        rc = lib.nhpsi_ntt_form(*args, form, ctypes.byref(grids), stream)
    name = "intt" if inverse else "ntt"
    launches[name] += grids.value
    cuda_lib.check(rc, name)
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
