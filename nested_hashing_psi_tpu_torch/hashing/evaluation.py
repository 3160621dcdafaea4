"""Cuckoo-hashing failure-rate evaluations.

Capability parity with the reference's statistical harnesses that justify the
benchmark parameter table (tests/CuckooHashingEvaluation.cpp:72-129
flat blocked tables, tests/HashingEvaluation.cpp:71-107 nested structure):
sweep slack ratios, count table-build failures over repeated trials with
fresh hash seeds, export CSV rows (slack, effective_slack, failures).

The port's copy of ``nested_hashing_psi_tpu.hashing.evaluation``: the same
functions, defaults and Philox-seeded items, on the port's hashing copies.
``main`` writes its CSV to ``--out`` or, by default, into
``eval_results_torch/`` at the repository's root.

Usage:
    python -m nested_hashing_psi_tpu_torch.hashing.evaluation cuckoo --nElem 4096 ...
    python -m nested_hashing_psi_tpu_torch.hashing.evaluation nested --nElem 4096 ...
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooFailure, CuckooHashTable
from nested_hashing_psi_tpu_torch.hashing.hierarchical import HierarchicalCuckooHashTable
from nested_hashing_psi_tpu_torch.hashing.tabulation import TabulationHashing

FLAT_SLACKS = (1.0, 1.05, 1.1, 1.15, 1.2, 1.3, 1.4, 1.5, 2, 2.5, 3)
NESTED_SLACKS = (1.0, 1.05, 1.1, 1.15, 1.2, 1.25, 1.3, 1.35, 1.4)


def _random_elements(n: int, seed: int) -> np.ndarray:
    rng = np.random.Generator(np.random.Philox(key=seed))
    items = rng.integers(1, 2**64, size=(n, 1), dtype=np.uint64)
    return np.concatenate([items, np.zeros_like(items)], axis=1)


def evaluate_flat(
    n_elem: int,
    n_runs: int,
    stash: int = 2,
    n_cuckoo_hf: int = 2,
    items_pp: int = 1,
    slacks=FLAT_SLACKS,
    item_seed: int = 4326418964,
    hash_seed: int = 2350176483526,
):
    """-> list of (slack, effective_slack, failures) rows."""
    elems = _random_elements(n_elem, item_seed)
    rows = []
    seed = hash_seed
    for slack in slacks:
        table_size = slack * n_elem / n_cuckoo_hf
        each = math.ceil(table_size / items_pp)
        eff = each * items_pp * n_cuckoo_hf / n_elem
        errors = 0
        for _ in range(n_runs):
            hasher = TabulationHashing(seed, n_cuckoo_hf)
            seed += 1
            ct = CuckooHashTable(
                hasher,
                each_table_size=each,
                n_hash_functions=n_cuckoo_hf,
                max_stash_size=stash,
                max_items_per_position=items_pp,
                seed=seed,
            )
            try:
                ct.insert_all(elems)
            except CuckooFailure:
                errors += 1
        rows.append((slack, eff, errors))
    return rows


def evaluate_nested(
    n_elem: int,
    n_runs: int,
    each_simple_table_size: int = 128,
    stash: int = 2,
    n_simple_hf: int = 3,
    n_cuckoo_hf: int = 2,
    item_pp_frac: float = 1.0,
    slacks=NESTED_SLACKS,
    item_seed: int = 4326418964,
    hash_seed: int = 2350176483526,
):
    """Nested structure sweep: slack split between inner table size and bin
    depth via sqrt(item_pp_frac) (reference HashingEvaluation.cpp:82-90)."""
    elems = _random_elements(n_elem, item_seed)
    avg_bin = -(-n_elem // each_simple_table_size)
    rows = []
    seed = hash_seed
    for slack in slacks:
        table_size = slack * avg_bin / n_cuckoo_hf
        root = math.sqrt(table_size)
        frac_root = math.sqrt(item_pp_frac)
        each_cuckoo = math.ceil(root * frac_root)
        items_pp = math.ceil(root / frac_root)
        eff = each_cuckoo * items_pp * n_cuckoo_hf / n_elem * each_simple_table_size
        errors = 0
        for _ in range(n_runs):
            hasher = TabulationHashing(seed, n_simple_hf + n_cuckoo_hf)
            seed += 1
            hct = HierarchicalCuckooHashTable(
                hasher,
                each_simple_table_size=each_simple_table_size,
                each_cuckoo_table_size=each_cuckoo,
                server_stash_size=stash,
                n_simple_hash_functions=n_simple_hf,
                n_cuckoo_hash_functions=n_cuckoo_hf,
                max_items_per_position=items_pp,
                seed=seed,
            )
            try:
                # serial build: trials measure the insertion envelope, and
                # worker processes would fight the machine's other jobs
                hct.insert_all(elems, n_workers=1)
            except CuckooFailure:
                errors += 1
        rows.append((slack, eff, errors))
    return rows


def _eval_dir() -> str:
    """``eval_results_torch/`` at the repository's root (``benchmarks.timing``)."""
    from nested_hashing_psi_tpu_torch.benchmarks.timing import EVAL_DIR

    return EVAL_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["cuckoo", "nested"])
    ap.add_argument("--nElem", type=int, default=1 << 20)
    ap.add_argument("--nRuns", type=int, default=16)
    ap.add_argument("--stash", type=int, default=2)
    ap.add_argument("--nSimpleHF", type=int, default=3)
    ap.add_argument("--nCuckooHF", type=int, default=2)
    ap.add_argument("--itemsPP", type=int, default=1)
    ap.add_argument("--eachSimpleTableSize", type=int, default=128)
    ap.add_argument("--itemPPfrac", type=float, default=1.0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.mode == "cuckoo":
        rows = evaluate_flat(
            args.nElem, args.nRuns, args.stash, args.nCuckooHF, args.itemsPP
        )
        default_name = (
            f"CT_nE_{args.nElem}_nR_{args.nRuns}_sts_{args.stash}"
            f"_nCH_{args.nCuckooHF}_nPP_{args.itemsPP}.csv"
        )
    else:
        rows = evaluate_nested(
            args.nElem,
            args.nRuns,
            args.eachSimpleTableSize,
            args.stash,
            args.nSimpleHF,
            args.nCuckooHF,
            args.itemPPfrac,
        )
        default_name = (
            f"NCT_nE_{args.nElem}_nR_{args.nRuns}_eSs_{args.eachSimpleTableSize}"
            f"_sts_{args.stash}_nSH_{args.nSimpleHF}_nCH_{args.nCuckooHF}"
            f"_frac_{args.itemPPfrac}.csv"
        )
    out = args.out or os.path.join(_eval_dir(), default_name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        for slack, eff, errors in rows:
            f.write(f"{slack},{eff},{errors}\n")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
