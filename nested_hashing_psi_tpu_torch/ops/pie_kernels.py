"""K2: the batched PIE's position-summed ct x pt product.

    ip[h, d, c, l, :] = sum_p idx[h, p, c, l, :] * pt[h, d, p, l, :]  (mod q_l)

Counterpart of ``nested_hashing_psi_tpu.ops.pie_kernels``:
``indexed_inner_product`` launches the CUDA kernel (csrc/pie_ip.cu) on CUDA
tensors and takes ``indexed_inner_product_plain`` on CPU tensors only.
``launches`` counts kernel launches. With ``p0`` the index covers positions
[p0, p0 + P) of a wider table, which the kernel reads in place (the
streamed upload's chunks); without it the widths must match. The wrapper
takes the primes and Montgomery constants as the (L,) int32 bit views the
kernel reads (``NTTPlan.tensors()["p_u32"]``, ``["pinv_u32"]``, built once
per plan and device), so a call converts nothing on the host.
"""

from __future__ import annotations

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.modmath import modsum, mont_mul

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _from_u32_bits(c: torch.Tensor) -> torch.Tensor:
    """(L,) int32 bit views -> (L, 1) int64 constants in [0, 2**32)."""
    return (c.long() & 0xFFFFFFFF).reshape(-1, 1)


def indexed_inner_product_plain(idx, pt, p, pinv, p0: int | None = None):
    """Plain PyTorch version (materializes the (H, D, P, 2, L, N) products)."""
    if p0 is not None:
        pt = pt[:, :, p0 : p0 + idx.shape[1]]
    prod = mont_mul(idx[:, None], pt[..., None, :, :], p, pinv)
    return modsum(prod, p, axis=2)


def indexed_inner_product(
    idx: torch.Tensor,   # (H, P, 2, L, N) int32 ciphertext residues
    pt: torch.Tensor,    # (H, D, P_full, L, N) int32 Montgomery plaintexts
    p_u32: torch.Tensor,     # (L,) int32 bit views of the primes
    pinv_u32: torch.Tensor,  # (L,) int32 bit views of -p^-1 mod 2^32
    p0: int | None = None,  # idx position 0 is table position p0
) -> torch.Tensor:
    """-> (H, D, 2, L, N) int32: the per-depth, per-hash inner products over
    table positions [p0, p0 + P) (over the whole table, P_full = P, when p0
    is None)."""
    global launches
    if idx.dim() != 5 or pt.dim() != 5:
        raise ValueError(f"idx {tuple(idx.shape)} / pt {tuple(pt.shape)} must be 5-d")
    H, P, k, L, N = idx.shape
    D, P_full = pt.shape[1], pt.shape[2]
    start = 0 if p0 is None else p0
    if (k != 2 or tuple(pt.shape) != (H, D, P_full, L, N)
            or not 0 <= start <= P_full - P or (p0 is None and P_full != P)):
        raise ValueError(
            f"idx {tuple(idx.shape)} at position {p0} does not match pt {tuple(pt.shape)}"
        )
    if idx.dtype != torch.int32 or pt.dtype != torch.int32:
        raise TypeError("idx and pt must be int32 residues")
    if idx.device != pt.device or p_u32.device != idx.device or pinv_u32.device != idx.device:
        raise ValueError(f"idx on {idx.device}, pt on {pt.device}, constants on "
                         f"{p_u32.device}/{pinv_u32.device}")
    if (p_u32.dtype != torch.int32 or pinv_u32.dtype != torch.int32
            or tuple(p_u32.shape) != (L,) or tuple(pinv_u32.shape) != (L,)):
        raise TypeError(f"the constants must be ({L},) int32 bit views")
    if not idx.is_cuda:
        if idx.device.type != "cpu":
            raise ValueError(f"no position sum for device {idx.device}")
        return indexed_inner_product_plain(
            idx, pt, _from_u32_bits(p_u32), _from_u32_bits(pinv_u32), p0)
    idx, pt = idx.contiguous(), pt.contiguous()
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=idx.device)
    rc = cuda_lib.get_lib().nhpsi_pie_ip(
        idx.data_ptr(), pt.data_ptr(), out.data_ptr(),
        p_u32.contiguous().data_ptr(), pinv_u32.contiguous().data_ptr(),
        H, D, P, L, N, start, P_full,
        torch.cuda.current_stream(idx.device).cuda_stream,
    )
    cuda_lib.check(rc, "indexed_inner_product")
    launches += 1
    return out
