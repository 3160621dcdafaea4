"""K2: the batched PIE's position-summed ct x pt product.

    ip[h, d, c, l, :] = sum_p idx[h, p, c, l, :] * pt[h, d, p, l, :]  (mod q_l)

Counterpart of ``nested_hashing_psi_tpu.ops.pie_kernels``:
``indexed_inner_product`` launches the CUDA kernel (csrc/pie_ip.cu) on CUDA
tensors and takes ``indexed_inner_product_plain`` on CPU tensors only.
``launches`` counts kernel launches. With ``p0`` the index covers positions
[p0, p0 + P) of a wider table, which the kernel reads in place (the
streamed upload's chunks); without it the widths must match. The table is
any (H, D, P_full, L, N) view whose n axis is contiguous, read in place: the
device-resident table, or the host-resident path's position-major
(P_full, H, D, L, N) upload buffer permuted to that order. With ``acc``
(H, D, 2, L, N) the result is add_mod(acc, sum), written over ``acc``: a
running sum over chunks or slices costs no separate add. The wrapper takes
the primes and Montgomery constants as the (L,) int32 bit views the kernel
reads (``NTTPlan.tensors()["p_u32"]``, ``["pinv_u32"]``, built once per plan
and device), so a call converts nothing on the host.
"""

from __future__ import annotations

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib
from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, modsum, mont_mul

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _from_u32_bits(c: torch.Tensor) -> torch.Tensor:
    """(L,) int32 bit views -> (L, 1) int64 constants in [0, 2**32)."""
    return (c.long() & 0xFFFFFFFF).reshape(-1, 1)


def indexed_inner_product_plain(idx, pt, p, pinv, p0: int | None = None, acc=None):
    """Plain PyTorch version (materializes the (H, D, P, 2, L, N) products);
    returns a new tensor, add_mod(acc, sum) with acc."""
    start = 0 if p0 is None else p0
    pt = pt[:, :, start : start + idx.shape[1]]
    prod = mont_mul(idx[:, None], pt[..., None, :, :], p, pinv)
    ip = modsum(prod, p, axis=2)
    return ip if acc is None else add_mod(acc, ip, p)


def indexed_inner_product(
    idx: torch.Tensor,   # (H, P, 2, L, N) int32 ciphertext residues
    pt: torch.Tensor,    # (H, D, P_full, L, N) int32 Montgomery plaintexts, n contiguous
    p_u32: torch.Tensor,     # (L,) int32 bit views of the primes
    pinv_u32: torch.Tensor,  # (L,) int32 bit views of -p^-1 mod 2^32
    p0: int | None = None,  # idx position 0 is table position p0
    acc: torch.Tensor | None = None,  # (H, D, 2, L, N) running sum, updated in place
) -> torch.Tensor:
    """-> (H, D, 2, L, N) int32: the per-depth, per-hash inner products over
    table positions [p0, p0 + P) (over the whole table, P_full = P, when p0
    is None); with acc, add_mod(acc, them), written over acc and returned."""
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
    dev = idx.device
    if (pt.device != dev or p_u32.device != dev or pinv_u32.device != dev
            or (acc is not None and acc.device != dev)):
        raise ValueError(f"idx on {dev}, pt on {pt.device}, constants on "
                         f"{p_u32.device}/{pinv_u32.device}"
                         + ("" if acc is None else f", acc on {acc.device}"))
    if (p_u32.dtype != torch.int32 or pinv_u32.dtype != torch.int32
            or tuple(p_u32.shape) != (L,) or tuple(pinv_u32.shape) != (L,)):
        raise TypeError(f"the constants must be ({L},) int32 bit views")
    if acc is not None and (tuple(acc.shape) != (H, D, 2, L, N) or acc.dtype != torch.int32
                            or not acc.is_contiguous()):
        raise ValueError(f"acc {tuple(acc.shape)} {acc.dtype} must be a contiguous "
                         f"({H}, {D}, 2, {L}, {N}) int32 tensor")
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"no position sum for device {dev}")
        ip = indexed_inner_product_plain(idx, pt, _from_u32_bits(p_u32),
                                         _from_u32_bits(pinv_u32), p0, acc)
        return ip if acc is None else acc.copy_(ip)
    # the (H, D, P, L, N) table view at position `start`, as a pointer and
    # strides (a sliced view would cost the host more than a short launch)
    st = pt.stride()
    table_ptr = pt.data_ptr() + 4 * start * st[2]
    acc_ptr = None if acc is None else acc.data_ptr()
    if st[4] != 1 or N % 4 or (st[0] | st[1] | st[2] | st[3]) % 4 or table_ptr % 16 \
            or (acc_ptr or 0) % 16:
        raise ValueError(
            f"the kernel reads 16-byte vectors along n: table strides {st}, N = {N}, table "
            f"and acc offsets {table_ptr % 16} / {(acc_ptr or 0) % 16} B")
    si = idx.stride()
    if si[1:] != (2 * L * N, L * N, N, 1) or si[0] % 4 or idx.data_ptr() % 16:
        idx = idx.clone(memory_format=torch.contiguous_format)
        si = idx.stride()
    out = torch.empty((H, D, 2, L, N), dtype=torch.int32, device=dev) if acc is None else acc
    # the current stream's handle, as torch.cuda.current_stream(dev).cuda_stream
    # gives it, without building a Stream object (several us of host time,
    # which paces a short launch such as a streamed chunk's)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = cuda_lib.get_lib().nhpsi_pie_ip(
        idx.data_ptr(), table_ptr, acc_ptr, out.data_ptr(), p_u32.contiguous().data_ptr(),
        pinv_u32.contiguous().data_ptr(), H, D, P, L, N, si[0], st[0], st[1], st[2], st[3],
        stream,
    )
    cuda_lib.check(rc, "indexed_inner_product")
    launches += 1
    return out
