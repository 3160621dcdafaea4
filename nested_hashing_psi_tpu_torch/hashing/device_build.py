"""The hierarchical cuckoo insert as torch operations, on the server's device.

The batched rounds of ``cuckoo.CuckooBuilder.insert_chunk`` and the chunked,
retried build of ``HierarchicalCuckooHashTable.insert_all`` (its serial
path, ``n_workers=1``), run on tensors of any device, with the outer and
inner tabulation hashes gathered on that device. The table it leaves is bit
for bit the serial NumPy build's for the same items and seed:

- chunk-local duplicates are dropped keeping first occurrences, as
  ``np.unique(..., return_index=True)`` does;
- every round draws its eviction depths from the same ``np.random.Philox``
  stream, on the host, and uploads them;
- where several pending pairs aim at one slot, the highest pending index
  wins (``scatter_reduce`` with ``amax``, deterministic), which is NumPy's
  last write;
- on ``CuckooFailure`` the build starts over with the seed bumped.

Items are (n, 2) int64 tensors holding the uint64 words [lo, hi] bit for
bit (a NumPy (n, 2) uint64 array is taken as it is). The build is the
batched PIE's: one table per hash function at both levels and no stash. The
NumPy build stays as the oracle and for its other callers.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooFailure
from nested_hashing_psi_tpu_torch.hashing.hierarchical import HierarchicalCuckooHashTable
from nested_hashing_psi_tpu_torch.hashing.tabulation import TabulationHashing
from nested_hashing_psi_tpu_torch.utils.profiling import synced_span

MASK32 = 0xFFFFFFFF


def as_item_tensor(items, device) -> torch.Tensor:
    """(n, 2) uint64 array or int64 tensor -> (n, 2) int64 tensor on
    ``device``, the same 64-bit words."""
    if isinstance(items, np.ndarray):
        items = torch.from_numpy(np.ascontiguousarray(items, dtype=np.uint64).view(np.int64))
    return items.to(device)


class DeviceTabulation:
    """``TabulationHashing``'s tables on a device: (n, 2) int64 items ->
    64-bit hashes (as int64 bits) and indices mod a table size."""

    def __init__(self, hasher: TabulationHashing, device):
        self.table = torch.from_numpy(hasher.table.view(np.int64)).to(device)

    def hash(self, items: torch.Tensor, hf_ind: int) -> torch.Tensor:
        chunks = items.contiguous().view(torch.uint8).reshape(-1, 16).long()
        tab = self.table[hf_ind]
        out = tab[0][chunks[:, 0]]
        for i in range(1, TabulationHashing.T_PARAM):
            out = out ^ tab[i][chunks[:, i]]
        return out

    def hash_index(self, items: torch.Tensor, hf_ind: int, table_size: int) -> torch.Tensor:
        """The hash as an unsigned 64-bit value mod ``table_size`` (< 2^31)."""
        h = self.hash(items, hf_ind)
        hi, lo = (h >> 32) & MASK32, h & MASK32
        return ((hi % table_size) * ((1 << 32) % table_size) + lo) % table_size


def first_occurrences(key: torch.Tensor) -> torch.Tensor:
    """Indices of the first occurrence of each distinct row of ``key``, in
    ascending order (``np.sort(np.unique(key, axis=0, return_index=True)[1])``)."""
    uniq, inverse = torch.unique(key, dim=0, return_inverse=True)
    ar = torch.arange(len(key), device=key.device)
    first = torch.full((len(uniq),), len(key), dtype=torch.int64, device=key.device)
    return first.scatter_reduce_(0, inverse, ar, "amin").sort().values


class DeviceCuckooBuilder:
    """``CuckooBuilder`` on tensors, one table per hash function and no
    stash: the same rounds, slots and draws. The table is kept as (n_bins *
    n_hash_functions * max_pp * table_size, 2) int64, a row per slot in
    ``CuckooBuilder``'s slot-key order. ``rounds`` and ``evictions`` count
    the batched rounds run and the occupants evicted."""

    def __init__(self, *, n_bins: int, hasher: DeviceTabulation, starting_hash_id: int,
                 n_hash_functions: int, table_size: int, max_items_per_position: int,
                 seed: int = 0, max_rounds: int = 2000, device):
        self.n_bins, self.hasher = n_bins, hasher
        self.starting_hash_id, self.n_hash_functions = starting_hash_id, n_hash_functions
        self.table_size, self.max_pp, self.max_rounds = table_size, max_items_per_position, max_rounds
        self.device = torch.device(device)
        cells = n_bins * n_hash_functions * table_size
        self.T = torch.zeros((cells * self.max_pp, 2), dtype=torch.int64, device=self.device)
        self.occ = torch.zeros(cells, dtype=torch.int64, device=self.device)
        self._rng = np.random.Generator(np.random.Philox(key=seed))
        self._tables = torch.arange(n_hash_functions, device=self.device)
        # the arbitration scratch: each round scatters stamps above every
        # earlier round's, so stale entries never win and nothing is cleared
        self._winner = torch.full((cells * self.max_pp,), -1, dtype=torch.int64,
                                  device=self.device)
        self._stamp = 0
        self.unplaced = 0
        self.rounds = self.evictions = 0

    def _positions(self, items: torch.Tensor) -> torch.Tensor:
        """(m, 2) items -> (m, n_hf) candidate positions."""
        return torch.stack([self.hasher.hash_index(items, self.starting_hash_id + h,
                                                   self.table_size)
                            for h in range(self.n_hash_functions)], dim=1)

    def insert_chunk(self, items: torch.Tensor, bin_ids: torch.Tensor) -> None:
        """``CuckooBuilder.insert_chunk`` on (m, 2) int64 items and (m,)
        int64 outer bin ids of the builder's device."""
        if len(items) == 0:
            return
        keep = first_occurrences(torch.stack([bin_ids, items[:, 0], items[:, 1]], dim=1))
        pend_items, pend_bins = items[keep], bin_ids[keep]
        pend_pos = self._positions(pend_items)
        n_hf, max_pp, ts, dev = self.n_hash_functions, self.max_pp, self.table_size, self.device

        for rnd in range(self.max_rounds):
            m = len(pend_items)
            if m == 0:
                break
            cell = (pend_bins[:, None] * n_hf + self._tables) * ts + pend_pos  # (m, n_hf)
            occ_h = self.occ[cell]
            free = occ_h < max_pp
            has_free = free.any(dim=1)
            first_free = free.to(torch.uint8).argmax(dim=1)  # the first free hash
            hf_sel = torch.where(has_free, first_free, rnd % n_hf)[:, None]
            cell_sel = cell.gather(1, hf_sel)[:, 0]
            depth_evict = torch.from_numpy(self._rng.integers(0, max_pp, size=m)).to(dev)
            depth_sel = torch.where(has_free, occ_h.gather(1, hf_sel)[:, 0], depth_evict)
            slot = (cell_sel // ts * max_pp + depth_sel) * ts + cell_sel % ts

            stamp = torch.arange(self._stamp, self._stamp + m, device=dev)
            self._stamp += m
            self._winner.scatter_reduce_(0, slot, stamp, "amax")
            winner = self._winner[slot] == stamp
            won = winner.nonzero()[:, 0]
            w_slot, w_free = slot[won], has_free[won]
            prev = self.T[w_slot]
            self.T[w_slot] = pend_items[won]
            self.occ[cell_sel[won][w_free]] += 1

            evicted = (~w_free).nonzero()[:, 0]
            ev_items, ev_bins = prev[evicted], pend_bins[won][evicted]
            lost = (~winner).nonzero()[:, 0]
            pend_items = torch.cat([pend_items[lost], ev_items])
            pend_bins = torch.cat([pend_bins[lost], ev_bins])
            pend_pos = torch.cat([pend_pos[lost], self._positions(ev_items)])
            self.rounds += 1
            self.evictions += len(evicted)

        self.unplaced += len(pend_items)

    def finish(self) -> torch.Tensor:
        """The table (n_bins, n_hash_functions, max_pp, table_size, 2) int64
        on the device; raises CuckooFailure where pairs stayed unplaced
        (``CuckooBuilder.finish`` with no stash)."""
        if self.unplaced:
            raise CuckooFailure(
                f"(Blocked) Cuckoo hashing error: {self.unplaced} items "
                f"unplaced after {self.max_rounds} rounds"
            )
        return self.T.view(self.n_bins, self.n_hash_functions, self.max_pp, self.table_size, 2)


def _outer_bin_ids(hct: HierarchicalCuckooHashTable, hasher: DeviceTabulation,
                   chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``HierarchicalCuckooHashTable._outer_bin_ids`` on the device."""
    s_size = hct.each_simple_table_size
    outer_pos = torch.stack([hasher.hash_index(chunk, h, s_size)
                             for h in range(hct.n_simple_hash_functions)])
    outer_pos = outer_pos + torch.arange(hct.n_simple_tables,
                                         device=chunk.device)[:, None] * s_size
    return chunk.repeat(hct.n_simple_hash_functions, 1), outer_pos.reshape(-1)


def insert_hierarchical(hct: HierarchicalCuckooHashTable, items, device,
                        chunk_items: int | None = None, retries: int = 2) -> None:
    """Build ``hct``'s nested table from (n, 2) items on ``device``, as
    ``hct.insert_all(items, chunk_items, retries, n_workers=1)`` builds it
    on the host; ``hct.table`` becomes an int64 tensor on ``device`` holding
    the same uint64 words. ``hct`` has one table per hash function at both
    levels and no stash, as the batched PIE needs. Span ``build.insert``
    (counts: the rounds and evictions of every attempt, the attempts)."""
    if hct.server_stash_size or not (hct.simple_multi_table and hct.cuckoo_multi_table):
        raise ValueError("the device build takes one table per hash function and no stash")
    device = torch.device(device)
    with synced_span("build.insert", device) as span:
        items = as_item_tensor(items, device)
        chunk_items = chunk_items or 1 << 21
        hasher = DeviceTabulation(hct.hasher, device)
        n_bins = hct.n_simple_tables * hct.each_simple_table_size
        rounds = evictions = 0
        last_err: CuckooFailure | None = None
        for attempt in range(retries + 1):
            builder = DeviceCuckooBuilder(
                n_bins=n_bins, hasher=hasher, starting_hash_id=hct.n_simple_hash_functions,
                n_hash_functions=hct.n_cuckoo_hash_functions,
                table_size=hct.each_cuckoo_table_size,
                max_items_per_position=hct.max_items_per_position,
                seed=hct.seed + attempt, device=device,
            )
            for i in range(0, len(items), chunk_items):
                builder.insert_chunk(*_outer_bin_ids(hct, hasher, items[i:i + chunk_items]))
            rounds, evictions = rounds + builder.rounds, evictions + builder.evictions
            try:
                table = builder.finish()
                break
            except CuckooFailure as e:
                last_err = e
        else:
            raise last_err
        span.counts = {"rounds": rounds, "evictions": evictions, "attempts": attempt + 1}
        hct.table = table.view(hct.n_simple_tables, hct.each_simple_table_size,
                               hct.n_cuckoo_tables, hct.max_items_per_position,
                               hct.each_cuckoo_table_size, 2)
