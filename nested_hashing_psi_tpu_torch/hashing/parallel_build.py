"""Multi-process nested-cuckoo build (outer-bin sharding).

The port's own copy of ``nested_hashing_psi_tpu.hashing.parallel_build``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

The reference parallelizes bin inserts with OpenMP across outer bins
(reference src/Common/Hashing/HierarchicalCuckooHashTable.cpp:65-71).
Outer bins are fully independent in the batched builder too, so the build
shards across worker PROCESSES in two phases:

 - phase 1 (item-sharded): each worker tabulation-hashes its contiguous item
   range and writes the outer-bin id of every (simpleHF, item) pair into a
   shared-memory bin matrix -- the serial parent-side hashing was the Amdahl
   bottleneck of a bins-only split (measured 1.6x on 2 vCPUs; this form
   removes it).
 - barrier, then phase 2 (bin-sharded): each worker selects the pairs whose
   bin falls in its range (items gathered straight from the shared item
   block -- pairs are never materialized) and runs the batched cuckoo rounds
   for those bins, writing a disjoint slice of the output table.

Workers are SPAWNED, not forked: by the time the server's offline phase
runs, the parent may hold a live CUDA context, whose driver threads make
fork unsafe. The worker import graph is numpy-only. Each worker applies the
CuckooFailure retry contract (bumped eviction seed, hash functions
untouched) to ITS shard independently; per-worker Philox streams mean the
parallel table layout differs from (but is distributed identically to) the
serial build's -- layout randomness is builder-local and never coordinated
with the peer, so this is behavior-preserving for every protocol.
"""

from __future__ import annotations

import sys

import numpy as np

from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooBuilder, CuckooFailure


def spawn_safe() -> bool:
    """Spawned children re-import __main__; an interactive / stdin main
    cannot be re-imported (observed: child hangs re-reading stdin). All real
    entry points (CLI, drivers, pytest) run from files."""
    m = sys.modules.get("__main__")
    return bool(
        getattr(m, "__file__", None) or getattr(m, "__spec__", None)
    )


def _build_shard(
    shm_names: dict,
    n_items: int,
    n_simple_hf: int,
    item_lo: int,
    item_hi: int,
    bin_lo: int,
    bin_hi: int,
    n_bins: int,
    simple_size: int,
    multi_simple: bool,
    hasher,
    builder_kw: dict,
    seed: int,
    retries: int,
    chunk_items: int,
    worker: int,
    barrier,
    status_q,
) -> None:
    """Spawned worker: hash items [item_lo, item_hi), then (after the
    barrier) build bins [bin_lo, bin_hi)."""
    from multiprocessing import shared_memory

    shms = {}
    try:
        shms = {k: shared_memory.SharedMemory(name=v) for k, v in shm_names.items()}
        items = np.ndarray((n_items, 2), np.uint64, buffer=shms["items"].buf)
        bins = np.ndarray(
            (n_simple_hf, n_items), np.int64, buffer=shms["bins"].buf
        )

        # phase 1: outer-bin ids for this worker's item range, all simple HFs
        my_items = items[item_lo:item_hi]
        for h in range(n_simple_hf):
            pos = hasher.hash_index(my_items, h, simple_size)
            if multi_simple:
                pos = pos + h * simple_size
            bins[h, item_lo:item_hi] = pos
        # bounded wait: a sibling that died pre-barrier must not hang the
        # build -- BrokenBarrierError surfaces through the status queue
        barrier.wait(timeout=3600)

        # phase 2: batched cuckoo rounds for this worker's bin range
        flat_bins = bins.reshape(-1)
        sel = np.flatnonzero((flat_bins >= bin_lo) & (flat_bins < bin_hi))
        my_bins = flat_bins[sel] - bin_lo
        my_pair_items = items[sel % n_items]

        last_err: CuckooFailure | None = None
        for attempt in range(retries + 1):
            builder = CuckooBuilder(
                n_bins=bin_hi - bin_lo,
                hasher=hasher,
                seed=(seed + attempt) + (worker << 32),
                **builder_kw,
            )
            for i in range(0, max(len(my_pair_items), 1), chunk_items):
                builder.insert_chunk(
                    my_pair_items[i : i + chunk_items],
                    my_bins[i : i + chunk_items],
                )
            try:
                T, stash = builder.finish()
                break
            except CuckooFailure as e:
                last_err = e
        else:
            status_q.put(("err", worker, str(last_err)))
            return

        T_full = np.ndarray(
            _table_shape(n_bins, builder_kw), np.uint64, buffer=shms["table"].buf
        )
        T_full[bin_lo:bin_hi] = T
        if builder_kw["stash_size"]:
            S_full = np.ndarray(
                (n_bins, builder_kw["stash_size"], 2),
                np.uint64,
                buffer=shms["stash"].buf,
            )
            S_full[bin_lo:bin_hi] = stash
        status_q.put(("ok", worker, ""))
    except Exception as e:  # surface ANY worker failure to the parent
        try:
            status_q.put(("err", worker, f"{type(e).__name__}: {e}"))
        except Exception:
            pass
    finally:
        for s in shms.values():
            s.close()


def _table_shape(n_bins: int, builder_kw: dict) -> tuple:
    return (
        n_bins,
        builder_kw["n_hash_functions"] if builder_kw["multi_table"] else 1,
        builder_kw["max_items_per_position"],
        builder_kw["table_size"],
        2,
    )


def parallel_hierarchical_insert(
    items: np.ndarray,
    *,
    n_bins: int,
    simple_size: int,
    n_simple_hf: int,
    multi_simple: bool,
    hasher,
    starting_hash_id: int,
    n_hash_functions: int,
    table_size: int,
    max_items_per_position: int,
    stash_size: int = 0,
    multi_table: bool = True,
    seed: int = 0,
    retries: int = 2,
    chunk_items: int = 1 << 21,
    n_workers: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Parallel nested build over a full item set (hash + insert sharded).
    Returns (table, stash) as plain numpy arrays; raises CuckooFailure if
    any shard exhausts its retries."""
    from multiprocessing import get_context, shared_memory

    N = len(items)
    n_tables = n_hash_functions if multi_table else 1
    item_bounds = [N * w // n_workers for w in range(n_workers + 1)]
    bin_bounds = [n_bins * w // n_workers for w in range(n_workers + 1)]

    table_shape = (n_bins, n_tables, max_items_per_position, table_size, 2)
    shm_items = shared_memory.SharedMemory(create=True, size=max(8, N * 16))
    shm_bins = shared_memory.SharedMemory(
        create=True, size=max(8, n_simple_hf * N * 8)
    )
    shm_table = shared_memory.SharedMemory(
        create=True, size=int(np.prod(table_shape)) * 8
    )
    shm_stash = shared_memory.SharedMemory(
        create=True, size=max(8, n_bins * stash_size * 2 * 8)
    )
    all_shm = [shm_items, shm_bins, shm_table, shm_stash]
    try:
        np.ndarray((N, 2), np.uint64, buffer=shm_items.buf)[:] = items
        tbl_view = np.ndarray(table_shape, np.uint64, buffer=shm_table.buf)
        tbl_view[:] = 0
        stash_view = np.ndarray(
            (n_bins, stash_size, 2), np.uint64, buffer=shm_stash.buf
        )
        if stash_size:
            stash_view[:] = 0

        shm_names = {
            "items": shm_items.name,
            "bins": shm_bins.name,
            "table": shm_table.name,
            "stash": shm_stash.name,
        }
        builder_kw = dict(
            starting_hash_id=starting_hash_id,
            n_hash_functions=n_hash_functions,
            table_size=table_size,
            max_items_per_position=max_items_per_position,
            stash_size=stash_size,
            multi_table=multi_table,
        )
        ctx = get_context("spawn")
        status_q = ctx.SimpleQueue()
        barrier = ctx.Barrier(n_workers)
        procs = []
        for w in range(n_workers):
            p = ctx.Process(
                target=_build_shard,
                args=(
                    shm_names,
                    N,
                    n_simple_hf,
                    item_bounds[w],
                    item_bounds[w + 1],
                    bin_bounds[w],
                    bin_bounds[w + 1],
                    n_bins,
                    simple_size,
                    multi_simple,
                    hasher,
                    builder_kw,
                    seed,
                    retries,
                    max(1 << 18, chunk_items // n_workers),
                    w,
                    barrier,
                    status_q,
                ),
                daemon=True,
            )
            p.start()
            procs.append(p)
        errs = []
        for _ in range(n_workers):
            kind, w, msg = status_q.get()
            if kind != "ok":
                errs.append(f"worker {w}: {msg}")
        for p in procs:
            p.join()
        if errs:
            raise CuckooFailure("; ".join(errs))
        return np.array(tbl_view), np.array(stash_view)
    finally:
        for s in all_shm:
            s.close()
            try:
                s.unlink()
            except FileNotFoundError:
                pass
