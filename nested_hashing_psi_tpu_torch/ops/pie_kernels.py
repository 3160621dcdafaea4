"""K2: the batched PIE's position-summed ct x pt product.

    ip[h, d, c, l, :] = sum_p idx[h, p, c, l, :] * pt[h, d, p, l, :]  (mod q_l)

Counterpart of ``nested_hashing_psi_tpu.ops.pie_kernels``:
``indexed_inner_product`` launches the CUDA kernel (csrc/pie_ip.cu) on CUDA
tensors and takes ``indexed_inner_product_plain`` on CPU tensors only.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.modmath import modsum, mont_mul

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _u32_bits(c: torch.Tensor) -> torch.Tensor:
    """(L, 1) int64 constants in [0, 2**32) -> (L,) int32 with the same bits."""
    c = c.reshape(-1).long()
    return torch.where(c >= 2**31, c - 2**32, c).int().contiguous()


def indexed_inner_product_plain(idx, pt, p, pinv):
    """Plain PyTorch version (materializes the (H, D, P, 2, L, N) products)."""
    prod = mont_mul(idx[:, None], pt[..., None, :, :], p, pinv)
    return modsum(prod, p, axis=2)


def indexed_inner_product(
    idx: torch.Tensor,   # (H, P, 2, L, N) int32 ciphertext residues
    pt: torch.Tensor,    # (H, D, P, L, N) int32 Montgomery plaintexts
    p: torch.Tensor,     # (L, 1) int64 primes
    pinv: torch.Tensor,  # (L, 1) int64 Montgomery constants
) -> torch.Tensor:
    """-> (H, D, 2, L, N) int32: the per-depth, per-hash inner products."""
    global launches
    if idx.dim() != 5 or pt.dim() != 5:
        raise ValueError(f"idx {tuple(idx.shape)} / pt {tuple(pt.shape)} must be 5-d")
    H, P, k, L, N = idx.shape
    D = pt.shape[1]
    if k != 2 or tuple(pt.shape) != (H, D, P, L, N):
        raise ValueError(f"idx {tuple(idx.shape)} does not match pt {tuple(pt.shape)}")
    if idx.dtype != torch.int32 or pt.dtype != torch.int32:
        raise TypeError("idx and pt must be int32 residues")
    if idx.device != pt.device:
        raise ValueError(f"idx on {idx.device}, pt on {pt.device}")
    if not idx.is_cuda:
        if idx.device.type != "cpu":
            raise ValueError(f"no position sum for device {idx.device}")
        return indexed_inner_product_plain(idx, pt, p, pinv)
    idx, pt = idx.contiguous(), pt.contiguous()
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=idx.device)
    primes = _u32_bits(p.to(idx.device))
    pinvs = _u32_bits(pinv.to(idx.device))
    rc = cuda_lib.get_lib().nhpsi_pie_ip(
        idx.data_ptr(), pt.data_ptr(), out.data_ptr(),
        primes.data_ptr(), pinvs.data_ptr(), H, D, P, L, N,
        torch.cuda.current_stream(idx.device).cuda_stream,
    )
    cuda_lib.check(rc, "indexed_inner_product")
    launches += 1
    return out
