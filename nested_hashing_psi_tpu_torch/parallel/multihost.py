"""Multi-process execution: process groups, meshes of ranks, sharded tensors.

Counterpart of ``nested_hashing_psi_tpu.parallel.multihost``. One process
per rank joins one ``torch.distributed`` group (``init_distributed``); a
``Mesh`` lays the ranks out on named axes, with one process group per row
and per column (``global_mesh``); ``host_to_global`` cuts this rank's shard
out of a host array that every rank holds, and ``global_to_host`` gathers
the shards back to every rank. A torch tensor carries no sharding, so the
spec (a tuple with one entry per dimension: an axis name, a tuple of all
the mesh's axis names for the flattened mesh, or None) is an argument.

Axis placement follows the JAX package: dp, the outermost axis, is meant to
cross hosts (one result gather at the end), tp and the ring axes to stay
within one. The backend is always the caller's: ``gloo`` for CPU ranks, or
for several ranks on one card (``parallel.comm`` stages its buffers through
host memory); ``nccl`` for one card per rank, which ``init_distributed``
checks.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from nested_hashing_psi_tpu_torch.parallel import comm
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

TIMEOUT = timedelta(minutes=10)


def _store(coordinator: str | None, num_processes: int, process_id: int):
    """The rendezvous store: in-process for one process, a file for a
    ``file://`` coordinator, else TCP at ``[tcp://]host:port`` (rank 0
    serves it)."""
    if num_processes == 1:
        return dist.HashStore()
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator address")
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    host, port = coordinator.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes, process_id == 0, timeout=TIMEOUT)


def _one_rank_per_device(store, rank: int, world: int, ident: str) -> None:
    """NCCL refuses two ranks on one GPU: every rank posts its device's
    identity to the store and raises if another rank posted the same."""
    store.set(f"nhpsi/nccl_device/{rank}", ident)
    shared = [r for r in range(world) if r != rank
              and store.get(f"nhpsi/nccl_device/{r}").decode() == ident]
    if shared:
        raise ValueError(f"nccl needs one GPU per rank: rank {rank} shares {ident} "
                         f"with ranks {shared}; use backend='gloo' for several ranks "
                         "on one card")


def rank_device(process_id: int) -> torch.device:
    """The GPU of an nccl rank: ranks are laid out host by host, each
    host's ranks on its cards in order, so rank r takes card r mod the
    cards this host shows. More ranks than cards on a host gives two ranks
    one card, which ``init_distributed`` refuses."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise ValueError(f"nccl rank {process_id} needs a CUDA device (none visible)")
    return torch.device("cuda", process_id % count)


def init_distributed(coordinator: str | None, num_processes: int, process_id: int,
                     backend: str) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (idempotent: returns if a group exists). It probes
    nothing before joining. One process joins no coordinator: its group of
    one lives on an in-process store. ``backend`` is ``gloo`` or ``nccl``;
    an nccl rank makes ``rank_device(process_id)`` its current device, and
    raises if another rank holds the same card."""
    if dist.is_initialized():
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    store = _store(coordinator, num_processes, process_id)
    kw = {}
    if backend == "nccl":
        device = rank_device(process_id)
        torch.cuda.set_device(device)
        props = torch.cuda.get_device_properties(device)
        ident = f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"
        _one_rank_per_device(store, process_id, num_processes, ident)
        kw["device_id"] = device
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT, **kw)


def compute_device(device) -> torch.device:
    """The device a rank computes on: ``cpu``, or a card, which must exist
    (``resolve_device``: nothing falls back to the CPU). ``cuda`` without
    an index is the rank's current card (``init_distributed`` sets it for
    nccl; several gloo ranks on one card share card 0)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(eq=False)
class Mesh:
    """Ranks on named axes. ``shape`` and ``index`` map each axis to its
    size and to this rank's coordinate; ``groups`` to the process group of
    the ranks that differ from this one only along it. ``device`` is where
    this rank computes."""

    axis_names: tuple[str, ...]
    shape: dict
    index: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    def flat_index(self) -> int:
        """This rank's index on the flattened mesh (first axis outermost)."""
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + self.index[a]
        return i

    def _check(self, entry) -> None:
        if isinstance(entry, tuple) and entry != self.axis_names:
            raise ValueError(f"spec entry {entry} must be one axis or all of {self.axis_names}")

    def group(self, entry):
        """The process group of one spec entry: an axis, or the tuple of all
        the mesh's axes (the whole mesh, flattened)."""
        self._check(entry)
        return self.groups[entry]

    def coordinate(self, entry) -> tuple[int, int]:
        """(this rank's block index, block count) along a spec entry."""
        self._check(entry)
        if isinstance(entry, tuple):
            return self.flat_index(), self.size
        return self.index[entry], self.shape[entry]


def global_mesh(dp: int | None = None, tp: int = 1, axes=("dp", "tp"), *,
                device="cuda") -> Mesh:
    """Mesh over all ranks of the process group: (dp, tp) with dp outermost
    (rank = i * tp + j), or with one axis name, a line of all ranks. Every
    rank must call it, in the same order as any other mesh it builds."""
    world, rank = dist.get_world_size(), dist.get_rank()
    axes = tuple(axes)
    if len(axes) == 1:
        if tp != 1 or dp not in (None, world):
            raise ValueError(f"a one-axis mesh spans all {world} ranks")
        dims = (world,)
    else:
        if dp is None:
            dp = world // tp
        dims = (dp, tp)
        if len(axes) != 2:
            raise ValueError(f"axes {axes}: one or two names")
    if int(np.prod(dims)) != world:
        raise ValueError(f"mesh {'x'.join(map(str, dims))} != {world} ranks")
    grid = np.arange(world).reshape(dims)
    coords = dict(zip(axes, (int(c) for c in np.argwhere(grid == rank)[0])))
    groups = {}
    for k, a in enumerate(axes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, dims[k])
        mine, _ = dist.new_subgroups_by_enumeration([list(map(int, r)) for r in lines])
        groups[a] = mine
    groups[axes] = groups[axes[0]] if len(axes) == 1 else dist.new_group(list(range(world)))
    return Mesh(axes, dict(zip(axes, dims)), coords, groups, compute_device(device))


def _shard_slices(mesh: Mesh, spec, shape) -> tuple[slice, ...]:
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {tuple(shape)}")
    out = []
    for entry, size in zip(spec, shape):
        if entry is None:
            out.append(slice(None))
            continue
        i, k = mesh.coordinate(entry)
        if size % k:
            raise ValueError(f"dimension {size} of {tuple(shape)} does not split "
                             f"{k} ways over {entry}")
        out.append(slice(i * (size // k), (i + 1) * (size // k)))
    return tuple(out)


def host_to_global(mesh: Mesh, spec, host_array) -> torch.Tensor:
    """This rank's shard of ``host_array`` (identical on every rank) as a
    tensor on the mesh's device; uint32 residues become int32 (same bits)."""
    a = np.asarray(host_array)
    part = np.ascontiguousarray(a[_shard_slices(mesh, spec, a.shape)])
    if part.dtype == np.uint32:
        part = part.view(np.int32)
    return torch.from_numpy(part.copy()).to(mesh.device)


def global_to_host(local: torch.Tensor, mesh: Mesh, spec) -> np.ndarray:
    """Gather the shards of a sharded tensor to every rank: the whole array
    as numpy (int32 residues as uint32)."""
    x = local
    for d, entry in enumerate(spec):
        if entry is not None:
            x = comm.all_gather(x, d, mesh.group(entry))
    out = np.ascontiguousarray(x.detach().cpu().numpy())
    return out.view(np.uint32) if out.dtype == np.int32 else out
