"""Nested (hierarchical) cuckoo structure as one dense tensor.

The port's own copy of ``nested_hashing_psi_tpu.hashing.hierarchical``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Capability parity with the reference's HierarchicalCuckooHashTable
(reference src/Common/Hashing/HierarchicalCuckooHashTable.cpp:55-87):
outer simple-hash table(s) over hash ids [0, nSimpleHF), each outer cell an
inner blocked cuckoo table over hash ids [nSimpleHF, nSimpleHF + nCuckooHF).

Array-first redesign: instead of a vector-of-vectors of CuckooHashTable
objects inserted bin-by-bin under OpenMP, the whole structure is built in one
batched cuckoo pass where the outer cell index is simply part of the slot key.
The result is the dense tensor

    table[n_simple_tables, simple_size, n_cuckoo_tables, max_pp, cuckoo_size, 2]

which is already the layout the batched PIE's slot packing wants (the
reference separately transposes into `vectorizedHCT`, BatchedFHEHIPPIE.cpp:37-71).
"""

from __future__ import annotations

import numpy as np

from nested_hashing_psi_tpu_torch.config import HashTableParams
from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooBuilder, CuckooFailure
from nested_hashing_psi_tpu_torch.hashing.tabulation import TabulationHashing


class HierarchicalCuckooHashTable:
    def __init__(
        self,
        hasher: TabulationHashing,
        each_simple_table_size: int,
        each_cuckoo_table_size: int,
        server_stash_size: int = 0,
        n_simple_hash_functions: int = 2,
        n_cuckoo_hash_functions: int = 2,
        simple_multi_table: bool = True,
        cuckoo_multi_table: bool = True,
        max_items_per_position: int = 1,
        seed: int = 0,
    ):
        self.hasher = hasher
        self.each_simple_table_size = each_simple_table_size
        self.each_cuckoo_table_size = each_cuckoo_table_size
        self.server_stash_size = server_stash_size
        self.n_simple_hash_functions = n_simple_hash_functions
        self.n_cuckoo_hash_functions = n_cuckoo_hash_functions
        self.simple_multi_table = simple_multi_table
        self.cuckoo_multi_table = cuckoo_multi_table
        self.max_items_per_position = max_items_per_position
        self.seed = seed
        self.n_simple_tables = n_simple_hash_functions if simple_multi_table else 1
        self.n_cuckoo_tables = n_cuckoo_hash_functions if cuckoo_multi_table else 1
        self.table = np.zeros(
            (
                self.n_simple_tables,
                each_simple_table_size,
                self.n_cuckoo_tables,
                max_items_per_position,
                each_cuckoo_table_size,
                2,
            ),
            dtype=np.uint64,
        )
        self.stash = np.zeros(
            (self.n_simple_tables, each_simple_table_size, server_stash_size, 2),
            dtype=np.uint64,
        )

    @classmethod
    def from_params(
        cls, hasher: TabulationHashing, ht: HashTableParams, seed: int = 0
    ) -> "HierarchicalCuckooHashTable":
        return cls(
            hasher,
            ht.each_simple_table_size,
            ht.each_cuckoo_table_size,
            ht.server_stash_size,
            ht.n_simple_hash_functions,
            ht.n_cuckoo_hash_functions,
            ht.simple_multi_table,
            ht.cuckoo_multi_table,
            ht.max_items_per_position,
            seed=seed,
        )

    def insert_all(
        self,
        items: np.ndarray,
        chunk_items: int | None = None,
        retries: int = 2,
        n_workers: int | None = None,
    ) -> None:
        """Bulk-build the nested structure from (n, 2)-uint64 items.

        chunk_items streams the build in bounded-memory slices (default: up
        to ~2^21 pairs in flight) -- required for 2^24+ server sets. On
        CuckooFailure the build retries with a bumped eviction seed (the
        seed only steers eviction randomness, never the hash functions), the
        failure-recovery policy SURVEY.md section 5 plans.

        n_workers shards the build across worker processes by outer bin
        (the reference's OpenMP analogue, HierarchicalCuckooHashTable.cpp:65);
        None auto-enables all cores for >= 2^22 pair sets. The parallel path
        uses per-worker eviction streams, so the table layout differs from
        (but is distributed identically to) the serial build's.
        """
        if chunk_items is None:
            chunk_items = 1 << 21
        s_size = self.each_simple_table_size
        n_bins = self.n_simple_tables * s_size

        if n_workers is None:
            import os as _os

            big = len(items) * self.n_simple_hash_functions >= (1 << 22)
            n_workers = min(_os.cpu_count() or 1, 8) if big else 1
        n_workers = max(1, min(n_workers, n_bins))
        if n_workers > 1:
            from nested_hashing_psi_tpu_torch.hashing.parallel_build import spawn_safe

            if spawn_safe():
                return self._insert_all_parallel(
                    items, chunk_items, retries, n_workers
                )

        last_err: CuckooFailure | None = None
        for attempt in range(retries + 1):
            builder = CuckooBuilder(
                n_bins=n_bins,
                hasher=self.hasher,
                starting_hash_id=self.n_simple_hash_functions,
                n_hash_functions=self.n_cuckoo_hash_functions,
                table_size=self.each_cuckoo_table_size,
                max_items_per_position=self.max_items_per_position,
                stash_size=self.server_stash_size,
                multi_table=self.cuckoo_multi_table,
                seed=self.seed + attempt,
            )
            for i in range(0, max(len(items), 1), chunk_items):
                chunk = items[i : i + chunk_items]
                if len(chunk) == 0:
                    continue
                # Each item goes into every simple table (one per simple
                # hash fn); with a combined table every fn maps into table 0
                # (reference: generateMultiHashSimpleHashTable, HashUtils.cpp:71-86).
                all_items, bin_ids = self._outer_bin_ids(chunk)
                builder.insert_chunk(all_items, bin_ids)
            try:
                T, stash = builder.finish()
                break
            except CuckooFailure as e:
                last_err = e
        else:
            raise last_err

        self.table = T.reshape(
            self.n_simple_tables,
            s_size,
            self.n_cuckoo_tables,
            self.max_items_per_position,
            self.each_cuckoo_table_size,
            2,
        )
        self.stash = stash.reshape(
            self.n_simple_tables, s_size, self.server_stash_size, 2
        )

    def _outer_bin_ids(self, chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(chunk of items) -> (tiled items, outer bin ids) for every simple
        hash function (one pair per (item, simpleHF))."""
        s_size = self.each_simple_table_size
        outer_pos = np.stack(
            [
                self.hasher.hash_index(chunk, h, s_size)
                for h in range(self.n_simple_hash_functions)
            ],
            axis=0,
        )  # (nSimpleHF, chunk)
        if self.simple_multi_table:
            outer_tbl = np.repeat(np.arange(self.n_simple_tables), len(chunk))
            bin_ids = outer_tbl * s_size + outer_pos.reshape(-1)
        else:
            bin_ids = outer_pos.reshape(-1)
        all_items = np.tile(chunk, (self.n_simple_hash_functions, 1))
        return all_items, bin_ids.astype(np.int64)

    def _insert_all_parallel(
        self, items: np.ndarray, chunk_items: int, retries: int, n_workers: int
    ) -> None:
        """Outer-bin-sharded multi-process build (see insert_all)."""
        from nested_hashing_psi_tpu_torch.hashing.parallel_build import (
            parallel_hierarchical_insert,
        )

        s_size = self.each_simple_table_size
        n_bins = self.n_simple_tables * s_size
        T, stash = parallel_hierarchical_insert(
            items,
            n_bins=n_bins,
            simple_size=s_size,
            n_simple_hf=self.n_simple_hash_functions,
            multi_simple=self.simple_multi_table,
            hasher=self.hasher,
            starting_hash_id=self.n_simple_hash_functions,
            n_hash_functions=self.n_cuckoo_hash_functions,
            table_size=self.each_cuckoo_table_size,
            max_items_per_position=self.max_items_per_position,
            stash_size=self.server_stash_size,
            multi_table=self.cuckoo_multi_table,
            seed=self.seed,
            retries=retries,
            chunk_items=chunk_items,
            n_workers=n_workers,
        )
        self.table = T.reshape(
            self.n_simple_tables,
            s_size,
            self.n_cuckoo_tables,
            self.max_items_per_position,
            self.each_cuckoo_table_size,
            2,
        )
        self.stash = stash.reshape(
            self.n_simple_tables, s_size, self.server_stash_size, 2
        )
