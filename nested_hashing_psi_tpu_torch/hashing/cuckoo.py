"""Blocked cuckoo hash tables with vectorized batched insertion.

The port's own copy of ``nested_hashing_psi_tpu.hashing.cuckoo``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Capability parity with the reference's CuckooHashTable
(reference src/Common/Hashing/CuckooHashTable.cpp:25-180): multi-table
(one per hash function) or combined blocked cuckoo tables, dummy = 0, random
evictions, optional stash, same table geometry `[table][depth][position]`.

Array-first redesign: the reference inserts one item at a time with a random
evict loop (inherently sequential; OpenMP across outer bins only). Here
insertion is a *bulk batched* algorithm over dense arrays -- every pending
item attempts placement each round, single-writer-per-slot arbitration via
np.unique, evicted occupants re-enter the pending pool. This (a) vectorizes
across the whole nested structure at once (all outer bins in one array op),
and (b) produces the dense
``(n_bins, n_tables, max_pp, table_size, 2)-uint64`` tensor that the FHE
slot-packing layer consumes directly, fusing the reference's separate
build-then-transpose steps (BatchedFHEHIPPIE.cpp:48-71).

The success-probability envelope of batched random-evict insertion matches
the sequential random-walk variant; `tests/test_hashing_eval.py` reproduces
the reference's failure-rate evaluation to validate the parameter table.
"""

from __future__ import annotations

import numpy as np

from nested_hashing_psi_tpu_torch.hashing.tabulation import TabulationHashing


class CuckooFailure(RuntimeError):
    """Raised when items cannot be placed (reference: CuckooHashTable.cpp:113)."""


class CuckooBuilder:
    """Incremental bulk cuckoo construction with bounded working memory.

    Items stream in through `insert_chunk` (each chunk runs the batched
    random-evict rounds against the shared table state); `finish` applies the
    stash fallback. Peak memory is O(chunk + table) instead of O(total items)
    -- the streamed-offline-build requirement for 2^24+ server sets
    (SURVEY.md section 7 hard-part 4).
    """

    def __init__(
        self,
        *,
        n_bins: int,
        hasher: TabulationHashing,
        starting_hash_id: int,
        n_hash_functions: int,
        table_size: int,
        max_items_per_position: int,
        stash_size: int = 0,
        multi_table: bool = True,
        seed: int = 0,
        max_rounds: int = 2000,
    ):
        self.n_bins = n_bins
        self.hasher = hasher
        self.starting_hash_id = starting_hash_id
        self.n_hash_functions = n_hash_functions
        self.table_size = table_size
        self.max_pp = max_items_per_position
        self.stash_size = stash_size
        self.multi_table = multi_table
        self.max_rounds = max_rounds
        n_tables = n_hash_functions if multi_table else 1
        self.n_tables = n_tables
        self.T = np.zeros(
            (n_bins, n_tables, self.max_pp, table_size, 2), dtype=np.uint64
        )
        self.stash = np.zeros((n_bins, stash_size, 2), dtype=np.uint64)
        self.occ = np.zeros((n_bins, n_tables, table_size), dtype=np.int64)
        self._rng = np.random.Generator(np.random.Philox(key=seed))
        self._tbl_of_hf = (
            np.arange(n_hash_functions)
            if multi_table
            else np.zeros(n_hash_functions, np.int64)
        ).astype(np.int64)
        self._unplaced_items: list[np.ndarray] = []
        self._unplaced_bins: list[np.ndarray] = []
        # scatter-arbitration scratch: one int32 per table slot (winner index
        # per round; no clearing needed -- only slots written this round are
        # read back). Lazily allocated on first insert.
        self._slot_winner: np.ndarray | None = None

    def _positions(self, items: np.ndarray) -> np.ndarray:
        """(m, 2) items -> (m, n_hf) candidate positions (one tabulation
        byte pass for all hash functions)."""
        m = len(items)
        out = np.empty((m, self.n_hash_functions), dtype=np.int64)
        for h in range(self.n_hash_functions):
            out[:, h] = self.hasher.hash_index(
                items, self.starting_hash_id + h, self.table_size
            )
        return out

    def insert_chunk(self, items: np.ndarray, bin_ids: np.ndarray) -> None:
        """Run the batched insertion rounds for one chunk of (item, bin)
        pairs against the shared table. Chunk-local duplicates are skipped
        (reference lookUp check, CuckooHashTable.cpp:78); duplicates across
        chunks each occupy a slot (documented divergence -- they only cost
        capacity, never correctness of the zero-test)."""
        if len(items) == 0:
            return
        key = np.stack(
            [bin_ids.astype(np.uint64), items[:, 0], items[:, 1]], axis=1
        )
        _, uniq_idx = np.unique(key, axis=0, return_index=True)
        pend_items = items[np.sort(uniq_idx)]
        pend_bins = bin_ids[np.sort(uniq_idx)].astype(np.int64)

        T, occ, rng = self.T, self.occ, self._rng
        n_tables, max_pp, table_size = self.n_tables, self.max_pp, self.table_size
        tbl_of_hf = self._tbl_of_hf

        # Candidate positions are computed ONCE per item and carried across
        # rounds (sliced exactly like pend_items); only evicted occupants --
        # a shrinking minority -- are re-hashed. With the scatter-based
        # winner arbitration below this removes the two per-round O(m log m)
        # costs (re-hashing everything, sorting slot keys) that dominated
        # the 2^22 build profile.
        pend_pos = self._positions(pend_items)  # (m, n_hf)

        for rnd in range(self.max_rounds):
            m = len(pend_items)
            if m == 0:
                break
            pos = pend_pos
            occ_h = occ[pend_bins[:, None], tbl_of_hf[None, :], pos]  # (m, n_hf)
            free = occ_h < max_pp
            has_free = free.any(axis=1)
            first_free_hf = np.argmax(free, axis=1)

            evict_hf = np.full(m, rnd % self.n_hash_functions, dtype=np.int64)
            hf_sel = np.where(has_free, first_free_hf, evict_hf)
            tbl_sel = tbl_of_hf[hf_sel]
            pos_sel = pos[np.arange(m), hf_sel]
            depth_free = occ_h[np.arange(m), hf_sel]
            depth_evict = rng.integers(0, max_pp, size=m)
            depth_sel = np.where(has_free, depth_free, depth_evict)

            # Single writer per slot: ONE pending item targeting each unique
            # (bin, table, pos, depth) wins this round; losers retry next
            # round. Arbitration by scatter (last write wins, then read
            # back): O(m), no sort; stale scratch entries are never read
            # because only this round's keys are consulted.
            slot_key = (
                (pend_bins * n_tables + tbl_sel) * max_pp + depth_sel
            ) * table_size + pos_sel
            if self._slot_winner is None:
                self._slot_winner = np.empty(
                    self.n_bins * n_tables * max_pp * table_size, dtype=np.int32
                )
            ar = np.arange(m, dtype=np.int32)
            self._slot_winner[slot_key] = ar
            winner = self._slot_winner[slot_key] == ar

            wb, wt, wp, wd = (
                pend_bins[winner],
                tbl_sel[winner],
                pos_sel[winner],
                depth_sel[winner],
            )
            w_items = pend_items[winner]
            w_free = has_free[winner]

            prev = T[wb, wt, wd, wp]  # occupants before write (0 for free case)
            T[wb, wt, wd, wp] = w_items
            occ[wb[w_free], wt[w_free], wp[w_free]] += 1

            evicted_mask = ~w_free
            ev_items = prev[evicted_mask]
            ev_bins = wb[evicted_mask]

            loser = ~winner
            pend_items = np.concatenate([pend_items[loser], ev_items])
            pend_bins = np.concatenate([pend_bins[loser], ev_bins])
            pend_pos = np.concatenate(
                [pend_pos[loser], self._positions(ev_items)]
            )

        if len(pend_items):
            self._unplaced_items.append(pend_items)
            self._unplaced_bins.append(pend_bins)

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        """Apply the stash fallback; raises CuckooFailure on overflow
        (reference: CuckooHashTable.cpp:104-113)."""
        if self._unplaced_items:
            pend_items = np.concatenate(self._unplaced_items)
            pend_bins = np.concatenate(self._unplaced_bins)
            stash_fill = np.zeros(self.n_bins, dtype=np.int64)
            leftover = 0
            for it, b in zip(pend_items, pend_bins):
                if stash_fill[b] < self.stash_size:
                    self.stash[b, stash_fill[b]] = it
                    stash_fill[b] += 1
                else:
                    leftover += 1
            if leftover:
                raise CuckooFailure(
                    f"(Blocked) Cuckoo hashing error: {leftover} items "
                    f"unplaced after {self.max_rounds} rounds"
                )
        return self.T, self.stash


def batched_cuckoo_insert(
    items: np.ndarray,
    bin_ids: np.ndarray,
    *,
    n_bins: int,
    hasher: TabulationHashing,
    starting_hash_id: int,
    n_hash_functions: int,
    table_size: int,
    max_items_per_position: int,
    stash_size: int = 0,
    multi_table: bool = True,
    seed: int = 0,
    max_rounds: int = 2000,
    chunk_items: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Insert (item, bin) pairs into per-bin blocked cuckoo tables, in bulk.

    chunk_items bounds working memory by streaming the pairs through a
    CuckooBuilder in slices. Returns (table, stash):
      table: (n_bins, n_tables, max_pp, table_size, 2) uint64, 0 = empty
      stash: (n_bins, stash_size, 2) uint64
    """
    builder = CuckooBuilder(
        n_bins=n_bins,
        hasher=hasher,
        starting_hash_id=starting_hash_id,
        n_hash_functions=n_hash_functions,
        table_size=table_size,
        max_items_per_position=max_items_per_position,
        stash_size=stash_size,
        multi_table=multi_table,
        seed=seed,
        max_rounds=max_rounds,
    )
    step = chunk_items or max(1, len(items))
    for i in range(0, len(items), step):
        builder.insert_chunk(items[i : i + step], bin_ids[i : i + step])
    return builder.finish()


class CuckooHashTable:
    """Flat blocked cuckoo table (client-side or per-bin server-side).

    Dense layout table[(1), n_tables, max_pp, table_size, 2]-uint64 -- the
    reference's `cuckooTable[hfInd][binDepth][binIndex]` as one array.
    """

    def __init__(
        self,
        hasher: TabulationHashing,
        each_table_size: int,
        n_hash_functions: int = 2,
        starting_hash_id: int = 0,
        max_stash_size: int = 0,
        multi_table: bool = True,
        max_items_per_position: int = 1,
        seed: int = 0,
    ):
        if n_hash_functions < 2:
            raise ValueError("Cuckoo table needs more than one hash function")
        if max_items_per_position < 1:
            raise ValueError("Bin size needs to be at least one")
        self.hasher = hasher
        self.each_table_size = each_table_size
        self.n_hash_functions = n_hash_functions
        self.starting_hash_id = starting_hash_id
        self.max_stash_size = max_stash_size
        self.multi_table = multi_table
        self.max_items_per_position = max_items_per_position
        self.seed = seed
        n_tables = n_hash_functions if multi_table else 1
        self.table = np.zeros(
            (n_tables, max_items_per_position, each_table_size, 2), dtype=np.uint64
        )
        self.stash = np.zeros((max_stash_size, 2), dtype=np.uint64)

    @property
    def n_tables(self) -> int:
        return self.table.shape[0]

    def insert_all(self, items: np.ndarray) -> None:
        T, stash = batched_cuckoo_insert(
            items,
            np.zeros(len(items), dtype=np.int64),
            n_bins=1,
            hasher=self.hasher,
            starting_hash_id=self.starting_hash_id,
            n_hash_functions=self.n_hash_functions,
            table_size=self.each_table_size,
            max_items_per_position=self.max_items_per_position,
            stash_size=self.max_stash_size,
            multi_table=self.multi_table,
            seed=self.seed,
        )
        self.table = T[0]
        self.stash = stash[0]

    def lookup(self, items: np.ndarray) -> np.ndarray:
        """Vectorized membership test: (n, 2) items -> (n,) bool."""
        items = np.atleast_2d(items)
        found = np.zeros(len(items), dtype=bool)
        for h in range(self.n_hash_functions):
            t = h if self.multi_table else 0
            pos = self.hasher.hash_index(
                items, self.starting_hash_id + h, self.each_table_size
            )
            slot = self.table[t, :, pos]  # (n, max_pp, 2)
            found |= (slot == items[:, None, :]).all(axis=2).any(axis=1)
        if self.max_stash_size:
            found |= (
                (self.stash[None, :, :] == items[:, None, :]).all(axis=2).any(axis=1)
            )
        return found
