"""The port's hashing layer (``hashing/``, ``data/``): the counterpart of
tests/test_hashing.py, test for test, on the port's own copies (tabulation,
cuckoo, nested cuckoo, the data inputs). Host-only, as in the JAX package.
"""

import numpy as np
import pytest

from nested_hashing_psi_tpu_torch.data import FixedDataInput, RandomDataInput
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints, items_to_ints


def test_tabulation_deterministic_and_independent():
    h1 = TabulationHashing(seed=42, n_hash_functions=4)
    h2 = TabulationHashing(seed=42, n_hash_functions=4)
    items = items_from_ints([2, 3, 12345678901234567890, 2**127 - 5])
    np.testing.assert_array_equal(h1.hash_all(items), h2.hash_all(items))
    h3 = TabulationHashing(seed=43, n_hash_functions=4)
    assert not np.array_equal(h1.hash_all(items), h3.hash_all(items))
    # different hash functions differ
    assert not np.array_equal(h1.hash(items, 0), h1.hash(items, 1))


def test_tabulation_vectorized_matches_scalar():
    h = TabulationHashing(seed=7, n_hash_functions=2)
    items = items_from_ints([5, 999, 2**100 + 17])
    # scalar recomputation from the table definition
    for idx, v in enumerate([5, 999, 2**100 + 17]):
        for hf in range(2):
            res = 0
            vv = v
            for i in range(16):
                res ^= int(h.table[hf, i, vv & 0xFF])
                vv >>= 8
            assert res == int(h.hash(items, hf)[idx])


def test_cuckoo_insert_and_lookup():
    h = TabulationHashing(seed=11, n_hash_functions=3)
    ct = CuckooHashTable(h, each_table_size=40, n_hash_functions=3, max_items_per_position=2)
    items = items_from_ints(list(range(2, 102)))
    ct.insert_all(items)
    assert ct.lookup(items).all()
    absent = items_from_ints(list(range(500, 600)))
    assert not ct.lookup(absent).any()
    # every item sits at one of its hashed positions
    stored = ct.table.reshape(-1, 2)
    nonzero = stored[(stored != 0).any(axis=1)]
    assert len(nonzero) == 100


def test_cuckoo_items_at_hashed_positions():
    h = TabulationHashing(seed=13, n_hash_functions=2)
    ct = CuckooHashTable(h, each_table_size=64, n_hash_functions=2, max_items_per_position=2)
    items = items_from_ints(list(range(2, 80)))
    ct.insert_all(items)
    for t in range(ct.n_tables):
        for d in range(ct.max_items_per_position):
            for pos in range(ct.each_table_size):
                it = ct.table[t, d, pos]
                if (it == 0).all():
                    continue
                expect = h.hash_index(it[None, :], t, 64)[0]
                assert expect == pos


def test_cuckoo_stash_overflow_raises():
    from nested_hashing_psi_tpu_torch.hashing import CuckooFailure

    h = TabulationHashing(seed=17, n_hash_functions=2)
    ct = CuckooHashTable(h, each_table_size=4, n_hash_functions=2, max_items_per_position=1)
    items = items_from_ints(list(range(2, 40)))  # 38 items into 8 slots
    with pytest.raises(CuckooFailure):
        ct.insert_all(items)


def test_hierarchical_alignment():
    """Every client cuckoo slot aligns with a server inner table where the
    item must be found (the core nesting invariant; TestElGamal.cpp:184-201)."""
    n_simple, n_cuckoo = 2, 2
    h = TabulationHashing(seed=123, n_hash_functions=n_simple + n_cuckoo)
    hct = HierarchicalCuckooHashTable(
        h,
        each_simple_table_size=16,
        each_cuckoo_table_size=8,
        n_simple_hash_functions=n_simple,
        n_cuckoo_hash_functions=n_cuckoo,
        max_items_per_position=4,
    )
    items = items_from_ints(list(range(2, 202)))
    hct.insert_all(items)

    # For every item and every simple hash fn: the item must be inside the
    # inner cuckoo table at (simple table, simple pos) at one of its inner
    # hash positions.
    for s in range(n_simple):
        outer = h.hash_index(items, s, 16)
        for i, it in enumerate(items):
            inner = hct.table[s, outer[i]]  # (n_cuckoo_tables, max_pp, size, 2)
            found = False
            for ch in range(n_cuckoo):
                t = ch if hct.cuckoo_multi_table else 0
                pos = h.hash_index(it[None, :], n_simple + ch, 8)[0]
                if (inner[t, :, pos] == it).all(axis=1).any():
                    found = True
            assert found, f"item {i} missing under simple hf {s}"


def test_random_data_input_contract():
    """Reference TestDataInput semantics: generated intersection == actual
    set intersection, independently derivable by both parties."""
    gen_client_side = RandomDataInput(5000, 200, 73, set_generation_seed=999, bit_size=32)
    gen_server_side = RandomDataInput(5000, 200, 73, set_generation_seed=999, bit_size=32)

    client = gen_client_side.get_client_set()
    inter = gen_client_side.get_intersection_set()
    server = gen_server_side.get_server_set()

    assert len(client) == 200 and len(server) == 5000 and len(inter) == 73
    client_keys = set(map(tuple, client.tolist()))
    server_keys = set(map(tuple, server.tolist()))
    inter_keys = set(map(tuple, inter.tolist()))
    assert inter_keys == client_keys & server_keys
    # no 0/1 values
    for s in (client_keys, server_keys):
        assert (0, 0) not in s and (1, 0) not in s


def test_random_data_input_16bit_exact_intersection():
    """Small bit space: collision rejection keeps the intersection exact."""
    gen = RandomDataInput(400, 40, 7, set_generation_seed=5, bit_size=16)
    client = set(map(tuple, gen.get_client_set().tolist()))
    server = set(map(tuple, gen.get_server_set().tolist()))
    inter = set(map(tuple, gen.get_intersection_set().tolist()))
    assert inter == client & server
    assert len(inter) == 7


def test_fixed_data_input():
    gen = FixedDataInput(20, 6, 3)
    client = items_to_ints(gen.get_client_set())
    server = items_to_ints(gen.get_server_set())
    inter = items_to_ints(gen.get_intersection_set())
    assert client == list(range(2, 8))
    assert inter == [5, 6, 7]
    assert server == list(range(5, 25))
    assert set(inter) == set(client) & set(server)


def test_item_roundtrip():
    vals = [2, 65535, 2**64 - 1, 2**64, 2**127 - 1]
    assert items_to_ints(items_from_ints(vals)) == vals


def test_hierarchical_parallel_build_matches_invariants():
    """Multi-process (outer-bin-sharded) build places every item correctly
    (same nesting invariant as the serial test above) and fills the same
    number of slots as a serial build of the same input."""
    n_simple, n_cuckoo = 2, 2
    h = TabulationHashing(seed=321, n_hash_functions=n_simple + n_cuckoo)

    def build(n_workers):
        hct = HierarchicalCuckooHashTable(
            h,
            each_simple_table_size=16,
            each_cuckoo_table_size=8,
            n_simple_hash_functions=n_simple,
            n_cuckoo_hash_functions=n_cuckoo,
            max_items_per_position=4,
            seed=5,
        )
        hct.insert_all(items, n_workers=n_workers)
        return hct

    items = items_from_ints(list(range(1000, 1200)))
    par = build(2)
    ser = build(1)
    # same occupancy (layout may differ: per-worker eviction streams)
    occ_par = (par.table != 0).any(axis=-1).sum()
    occ_ser = (ser.table != 0).any(axis=-1).sum()
    assert occ_par == occ_ser == 2 * len(items)

    for s in range(n_simple):
        outer = h.hash_index(items, s, 16)
        for i, it in enumerate(items):
            inner = par.table[s, outer[i]]
            found = False
            for ch in range(n_cuckoo):
                t = ch if par.cuckoo_multi_table else 0
                pos = h.hash_index(it[None, :], n_simple + ch, 8)[0]
                if (inner[t, :, pos] == it).all(axis=1).any():
                    found = True
            assert found, f"item {i} missing under simple hf {s} (parallel)"
