"""Distributed NTT: the ring (coefficient) axis sharded over ranks.

Counterpart of ``nested_hashing_psi_tpu.parallel.dist_ntt``, bit-exact with
``ops.ntt``. Two layouts:

 1. Ulysses-style (``dist_ntt_fns``): the four-step factorisation
    (``ops.ntt4``) with ONE all-to-all between its two locally dense
    stages. x viewed as (..., L, m1, m2): the forward takes x sharded on
    m2 and returns it sharded on m1 (canonical order rows); the inverse
    mirrors it, so NTT-domain pointwise algebra sharded on m1 composes with
    the inverse without another relayout.
 2. Ring exchange (``ring_ntt_local_fns``, ``dist_ntt_ring_fns``): the
    butterfly NTT with each rank holding a contiguous block of n/D
    coefficients. The first log2(D) stages of the forward pair coefficients
    a block or more apart, so each swaps its whole block with the
    XOR-partner rank (``comm.ppermute``) and keeps its half; the remaining
    log2(n/D) stages are local. The inverse runs the local stages first.
    Per transform a rank sends log2(D) blocks: log2(D) * (n/D) * L * batch
    * 4 bytes.

Each function here is a rank's local body: it takes and returns this
rank's block and calls the collectives of ``parallel.comm`` on the axis's
process group. Plain PyTorch, as the JAX bodies are jnp.
"""

from __future__ import annotations

import torch

from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, mont_mul, shoup_mul, sub_mod
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.ntt4 import FourStepPlan, _matmul_left, _matmul_right
from nested_hashing_psi_tpu_torch.parallel import comm
from nested_hashing_psi_tpu_torch.parallel.multihost import Mesh


def dist_ntt_fns(plan: FourStepPlan, mesh: Mesh, axis: str, ndim: int = 3):
    """(fwd, inv) local bodies for inputs of rank ``ndim`` ending in
    (L, m1, m2), sharded over ``axis``: fwd takes the (..., L, m1, m2/D)
    block sharded on m2 and returns the (..., L, m1/D, m2) block sharded on
    m1; inv the reverse. Specs: (None, ..., None, axis) and (..., axis, None)."""
    group = mesh.groups[axis]
    D, d = mesh.shape[axis], mesh.index[axis]
    if plan.m2 % D or plan.m1 % D:
        raise ValueError(f"m1 = {plan.m1}, m2 = {plan.m2} do not split {D} ways")
    tb = plan.tensors(mesh.device)
    p, pinv = tb["p_arr"], tb["pinv_arr"]
    cols = slice(d * (plan.m2 // D), (d + 1) * (plan.m2 // D))
    t_local, it_local = tb["T"][:, :, cols], tb["iT"][:, :, cols]

    def check(x):
        if x.dim() != ndim:
            raise ValueError(f"input {tuple(x.shape)} is not of rank {ndim}")

    def fwd(x):
        check(x)
        c = _matmul_left(tb["M1"], x, p, pinv)         # local: contract m1
        dd = mont_mul(c, t_local, p, pinv)
        dd = comm.all_to_all(dd, dd.dim() - 2, dd.dim() - 1, group)
        return _matmul_right(dd, tb["M2T"], p, pinv)   # local: contract m2

    def inv(y):
        check(y)
        dd = _matmul_right(y, tb["iM2T"], p, pinv)     # local: contract m2
        dd = comm.all_to_all(dd, dd.dim() - 1, dd.dim() - 2, group)
        c = mont_mul(dd, it_local, p, pinv)
        return _matmul_left(tb["iM1"], c, p, pinv)     # local: contract m1

    return fwd, inv


def ring_ntt_local_fns(plan: NTTPlan, group, D: int, device):
    """Per-rank bodies (fwd_local, inv_local) of the ring-exchange NTT over
    the ``D`` ranks of ``group``: each takes and returns this rank's block
    (..., L, n/D) of a coefficient-sharded (..., L, n) tensor on ``device``."""
    n, L = plan.n, plan.L
    if D & (D - 1) or n % (2 * D) or comm.axis_size(group) != D:
        raise ValueError(f"ring exchange over {D} ranks of a group of "
                         f"{comm.axis_size(group)} at n = {n}")
    logD, logn, block = D.bit_length() - 1, plan.logn, n // D
    tb = plan.tensors(device)
    psi, ipsi, n_inv = tb["psi"], tb["ipsi"], tb["ninv"]   # (L, 2, n) Shoup pairs
    p2 = tb["p"]                                            # (L, 1)
    p3 = p2[:, :, None]                                     # (L, 1, 1)
    d = comm.axis_index(group)

    def tw_scalar(table, i):
        return table[:, 0, i : i + 1], table[:, 1, i : i + 1]      # (L, 1)

    def tw_block(table, i, count):
        return table[:, 0, i : i + count, None], table[:, 1, i : i + count, None]

    def swap(x, s):
        """The partner's block at cross-rank stage s, and whether this rank
        holds the lower half of the butterfly."""
        mask = D >> (s + 1)
        other = comm.ppermute(x, [(i, i ^ mask) for i in range(D)], group)
        return other, (d & mask) == 0

    def fwd_local(x):
        bshape = x.shape[:-2]
        for s in range(logD):  # cross-rank stages
            other, lower = swap(x, s)
            u, v_in = (x, other) if lower else (other, x)
            v = shoup_mul(v_in, *tw_scalar(psi, (1 << s) + (d >> (logD - s))), p2)
            x = add_mod(u, v, p2) if lower else sub_mod(u, v, p2)
        for s in range(logD, logn):  # local stages on the block
            t, m_loc = n >> (s + 1), (1 << s) >> logD
            w, wq = tw_block(psi, (1 << s) + d * m_loc, m_loc)
            xr = x.reshape(*bshape, L, m_loc, 2, t)
            u = xr[..., 0, :]
            v = shoup_mul(xr[..., 1, :], w, wq, p3)
            x = torch.stack([add_mod(u, v, p3), sub_mod(u, v, p3)], dim=-2).reshape(
                *bshape, L, block)
        return x

    def inv_local(x):
        bshape = x.shape[:-2]
        for s in range(logn - 1, logD - 1, -1):  # local stages first
            t, h_loc = n >> (s + 1), (1 << s) >> logD
            w, wq = tw_block(ipsi, (1 << s) + d * h_loc, h_loc)
            xr = x.reshape(*bshape, L, h_loc, 2, t)
            u, v = xr[..., 0, :], xr[..., 1, :]
            x = torch.stack(
                [add_mod(u, v, p3), shoup_mul(sub_mod(u, v, p3), w, wq, p3)], dim=-2
            ).reshape(*bshape, L, block)
        for s in range(logD - 1, -1, -1):  # cross-rank stages
            other, lower = swap(x, s)
            u, v = (x, other) if lower else (other, x)
            if lower:
                x = add_mod(u, v, p2)
            else:
                w, wq = tw_scalar(ipsi, (1 << s) + (d >> (logD - s)))
                x = shoup_mul(sub_mod(u, v, p2), w, wq, p2)
        return shoup_mul(x, n_inv[:, 0], n_inv[:, 1], p2)

    return fwd_local, inv_local


def dist_ntt_ring_fns(plan: NTTPlan, mesh: Mesh, axis: str, ndim: int = 2):
    """(fwd, inv) of the ring-exchange NTT for inputs of rank ``ndim``
    (..., L, n) with the trailing coefficient axis sharded over ``axis``
    (spec (None, ..., None, axis)): each takes and returns this rank's
    contiguous block of n/D coefficients."""
    fwd_local, inv_local = ring_ntt_local_fns(plan, mesh.groups[axis], mesh.shape[axis],
                                              mesh.device)

    def checked(fn):
        def run(x):
            if x.dim() != ndim:
                raise ValueError(f"input {tuple(x.shape)} is not of rank {ndim}")
            return fn(x)
        return run

    return checked(fwd_local), checked(inv_local)
