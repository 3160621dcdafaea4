"""Collectives of the sharded steps, on torch.distributed process groups.

The JAX package gets these from ``shard_map`` (``jax.lax.ppermute``,
``all_to_all(..., tiled=True)``, ``all_gather``, ``axis_index``); here each
is a call on the process group of one mesh axis. The transport follows from
the group's backend and the tensor's device, and nothing else:

- ``nccl`` on CUDA tensors: the collective runs on the card;
- ``gloo`` on CPU tensors: the CPU ranks of the tests;
- ``gloo`` on CUDA tensors: several ranks on one card, which NCCL refuses.
  The collective copies each buffer it exchanges to host memory, runs gloo
  there and copies the result back to the rank's device (``STAGED``). The
  rank's compute stays on its device.

On a group of one rank ``all_to_all`` and ``all_gather`` return their input
as it is, with no exchange and no copy to host memory, as a collective over
a mesh axis of size 1 does nothing in JAX. ``nccl`` on a CPU tensor raises
all the same. ``bytes_sent`` counts the bytes this rank sends to other
ranks (a pair (i, i) of ``ppermute`` is a local copy and sends nothing),
as ``ops.pie_kernels.launches`` counts K2's launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NCCL, GLOO, STAGED = "nccl", "gloo", "gloo staged through host memory"

bytes_sent = 0


def reset_bytes() -> None:
    global bytes_sent
    bytes_sent = 0


def _count(n: int) -> None:
    global bytes_sent
    bytes_sent += int(n)


def transport(group, device) -> str:
    """The transport a collective on ``group`` takes for tensors on ``device``."""
    backend = dist.get_backend(group)
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend cannot exchange tensors on {device}")
        return NCCL
    if backend == "gloo":
        return STAGED if device.type == "cuda" else GLOO
    raise ValueError(f"no transport for backend {backend!r}")


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if transport(group, x.device) == STAGED else x


def axis_index(group) -> int:
    """This rank's index along the axis of ``group``."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


class Pending:
    """A ppermute in flight: ``wait()`` returns the received tensor on the
    device of the tensor that was sent."""

    def __init__(self, works, out: torch.Tensor, device: torch.device):
        self._works, self._out, self._device = works, out, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._out.to(self._device)


def ppermute_start(x: torch.Tensor, pairs, group) -> Pending:
    """Start ``jax.lax.ppermute``: for each (src, dst) in ``pairs`` (axis
    indices), src's ``x`` goes to dst. A rank that receives nothing gets
    zeros; a pair (i, i) is a copy."""
    me = axis_index(group)
    dsts = [d for s, d in pairs if s == me]
    srcs = [s for s, d in pairs if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"rank {me} sends to {dsts} and receives from {srcs}: one each at most")
    if srcs == [me]:
        return Pending([], x.clone(), x.device)
    wire = _to_wire(x, group)
    out = torch.zeros_like(wire)
    ops = []
    if dsts:
        ops.append(dist.P2POp(dist.isend, wire, dist.get_global_rank(group, dsts[0]), group))
        _count(wire.numel() * wire.element_size())
    if srcs:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, srcs[0]), group))
    return Pending(dist.batch_isend_irecv(ops) if ops else [], out, x.device)


def ppermute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    return ppermute_start(x, pairs, group).wait()


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    block i of ``x`` along split_axis goes to rank i; the blocks received
    from ranks 0..D-1 are concatenated along concat_axis in that order."""
    D = axis_size(group)
    if D == 1:
        transport(group, x.device)  # raises where the exchange would
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % D:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split {D} ways")
    wire = _to_wire(torch.stack(x.chunk(D, dim=split_axis)), group)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    _count(wire.numel() * wire.element_size() * (D - 1) // D)
    return torch.cat(out.to(x.device).unbind(0), dim=concat_axis)


def all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The blocks of all ranks of ``group`` concatenated along ``axis``."""
    D = axis_size(group)
    if D == 1:
        transport(group, x.device)  # raises where the exchange would
        return x
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(D)]
    dist.all_gather(parts, wire, group=group)
    _count(wire.numel() * wire.element_size() * (D - 1))
    return torch.cat(parts, dim=axis).to(x.device)
