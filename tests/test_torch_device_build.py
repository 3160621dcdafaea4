"""The server's build on its own device (``hashing/device_build.py``,
``fhe/device_encode.py``, ``BatchedFHEPIE._encode``) held to the plain
references it replaces on the server's path: the serial NumPy insert
(``HierarchicalCuckooHashTable.insert_all(..., n_workers=1)``) bit for bit,
the object-array packed encode (``BGVContext.make_plaintext_mont``) bit for
bit under BFV, flat BGV and leveled BGV, and the JAX package's PIE at the
same ``mask_seed``. On the CPU here; the ``gpu`` case holds the card's
build to the host's (the module imports the JAX package only inside the
test that compares with it, so ``-m gpu`` runs on a machine without JAX)."""

import contextlib
import types

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe.encoding import PackedEncoder, intt_numpy
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, plaintext_modulus_for_bit_size
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooFailure,
    HierarchicalCuckooHashTable,
    TabulationHashing,
    cuckoo,
    device_build,
    hierarchical,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu_torch.ops import mod64
from nested_hashing_psi_tpu_torch.ops.refmodel import _bitrev
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import (
    BatchedFHEPSIClient,
    BatchedFHEPSIServer,
)
from nested_hashing_psi_tpu_torch.protocol.runner import default_data, run_in_process
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(1)

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
T16 = 65537
HASH_SEED = 321


def _hct(simple, inner, pp, seed, cls=HierarchicalCuckooHashTable, tab=TabulationHashing):
    return cls(tab(HASH_SEED, 4), simple, inner, n_simple_hash_functions=2,
               n_cuckoo_hash_functions=2, max_items_per_position=pp, seed=seed)


def _items(n, bits=32, dup=0):
    items = RandomDataInput(n, 20, 5, 3, bits).get_server_set()
    return np.concatenate([items, items[:dup][::-1]]) if dup else items


def _serial_and_device(items, geometry, chunk_items=None, device="cpu"):
    """(the serial NumPy build, the device build, the device build's span)."""
    host, dev = _hct(*geometry), _hct(*geometry)
    host.insert_all(items, chunk_items=chunk_items, n_workers=1)
    device_build.insert_hierarchical(dev, items, device, chunk_items=chunk_items)
    return host, dev, TRACER.spans[-1]


def _same_table(host, dev):
    np.testing.assert_array_equal(dev.table.cpu().numpy().view(np.uint64), host.table)


# (items, duplicates, bits, (simple, inner, max_pp, seed), chunk_items)
INSERT_CASES = {
    "small": (600, 0, 32, (16, 24, 4, 5), 256),
    "evicts": (3000, 0, 32, (32, 12, 6, 1), None),
    "duplicates": (3000, 40, 32, (32, 12, 6, 2), 1000),
    "wide_items": (2000, 5, 80, (32, 12, 6, 4), None),
    "deep": (20000, 0, 32, (64, 24, 12, 3), 4096),
    "north_star_load": (1 << 15, 0, 32, (70, 24, 24, 9), 1 << 12),
}


@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_insert_matches_the_serial_numpy_build(case):
    n, dup, bits, geometry, chunk = INSERT_CASES[case]
    host, dev, span = _serial_and_device(_items(n, bits, dup), geometry, chunk)
    _same_table(host, dev)
    assert span.name == "build.insert" and span.counts["rounds"] > 0
    if case == "evicts":
        assert span.counts["evictions"] > 0


@contextlib.contextmanager
def _few_rounds(monkeypatch, rounds):
    """Both builders capped at ``rounds`` batched rounds, so that an
    attempt can fail and the retry with the bumped seed succeed."""
    class Host(cuckoo.CuckooBuilder):
        def __init__(self, **kw):
            super().__init__(**kw, max_rounds=rounds)

    class Dev(device_build.DeviceCuckooBuilder):
        def __init__(self, **kw):
            super().__init__(**kw, max_rounds=rounds)

    monkeypatch.setattr(hierarchical, "CuckooBuilder", Host)
    monkeypatch.setattr(device_build, "DeviceCuckooBuilder", Dev)
    yield


@pytest.mark.parametrize("seed, attempts", [(2, 2), (1, 3)])
def test_insert_retries_with_the_seed_bumped(monkeypatch, seed, attempts):
    items = items_from_ints(list(range(1000, 1300)))
    with _few_rounds(monkeypatch, 16):
        host, dev, span = _serial_and_device(items, (8, 8, 4, seed))
    _same_table(host, dev)
    assert span.counts["attempts"] == attempts


def test_insert_fails_as_the_serial_build_does(monkeypatch):
    items = items_from_ints(list(range(1000, 1100)))
    with pytest.raises(CuckooFailure) as host_err:
        _hct(2, 4, 2, 0).insert_all(items, n_workers=1)
    with pytest.raises(CuckooFailure) as dev_err:
        device_build.insert_hierarchical(_hct(2, 4, 2, 0), items, "cpu")
    assert str(dev_err.value) == str(host_err.value)


@pytest.mark.parametrize("layout", [dict(server_stash_size=2), dict(simple_multi_table=False),
                                    dict(cuckoo_multi_table=False)])
def test_insert_takes_the_batched_pie_layout_only(layout):
    """One table per hash function at both levels and no stash, as the
    batched PIE needs; anything else is refused before any work."""
    hct = HierarchicalCuckooHashTable(TabulationHashing(HASH_SEED, 4), 16, 8, **layout)
    with pytest.raises(ValueError, match="one table per hash function"):
        device_build.insert_hierarchical(hct, _items(50), "cpu")


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_first_occurrences_match_numpy(n):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 4, size=(n, 3))
    want = np.sort(np.unique(key, axis=0, return_index=True)[1]) if n else np.zeros(0)
    got = device_build.first_occurrences(torch.from_numpy(key))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [12, 4505, (1 << 31) - 1])
def test_device_hashes_match_the_tabulation(size):
    hasher = TabulationHashing(HASH_SEED, 4)
    items = _items(500, 80)
    dev = device_build.DeviceTabulation(hasher, "cpu")
    t_items = device_build.as_item_tensor(items, "cpu")
    for h in range(4):
        np.testing.assert_array_equal(dev.hash(t_items, h).numpy().view(np.uint64),
                                      hasher.hash(items, h))
        np.testing.assert_array_equal(dev.hash_index(t_items, h, size).numpy(),
                                      hasher.hash_index(items, h, size))


# ---------------------------------------------------------------- mod64 --

@pytest.mark.parametrize("t", [T16, T32, plaintext_modulus_for_bit_size(40),
                               plaintext_modulus_for_bit_size(48)])
def test_intt2_inverts_like_the_host_encoder(t):
    n = 64
    enc = PackedEncoder(n, t)
    vals = np.random.default_rng(t % 1000).integers(0, t, size=(3, n), dtype=np.int64)
    want = enc._big_ntt(vals.astype(object), inverse=True) if t > 1 << 31 else \
        intt_numpy(vals.astype(np.uint64), t, enc.psi)
    ipsi = pow(enc.psi, -1, t)
    tw = [pow(ipsi, int(r), t) for r in _bitrev(n)]
    planes = mod64.planes(np.array(tw, dtype=np.uint64), "cpu")
    quot = mod64.planes(np.array([(v << 64) // t for v in tw], dtype=object), "cpu")
    ninv = pow(n, -1, t)
    lo, hi = mod64.intt2_mod_t(mod64.planes(vals.astype(np.uint64), "cpu"), planes, quot,
                               mod64.split_u64(ninv), mod64.shoup64_host(ninv, t),
                               mod64.split_u64(t))
    got = mod64.u64_from_planes_np(lo.numpy(), hi.numpy())
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))


@pytest.mark.parametrize("t", [T16, T32, (1 << 61) - 1])
def test_shoup_quotients_of_tensors(t):
    w = np.random.default_rng(1).integers(1, t, size=257, dtype=np.int64)
    w2 = mod64.planes(w.astype(np.uint64), "cpu")
    c = (1 << 64) % t
    q = mod64.shoup_quotient2(w2, mod64.split_u64(c), mod64.shoup64_host(c, t),
                              mod64.split_u64(pow(t, -1, 1 << 64)), mod64.split_u64(t))
    want = np.array([(int(v) << 64) // t for v in w], dtype=object)
    np.testing.assert_array_equal(mod64.u64_from_planes_np(q[0].numpy(), q[1].numpy()),
                                  want.astype(np.uint64))


# --------------------------------------------------------------- encode --

def _object_encode(ctx, hct, mask_seed, H, D, P):
    """The packed table and masks as the server built them before its
    build moved to the device: the depth shuffle and the masks from one
    Philox stream, the mask fold in Python integers, the host encode."""
    rng = np.random.Generator(np.random.Philox(key=mask_seed))
    table = hct.table
    S, O = table.shape[:2]
    perm = np.argsort(rng.random((S, O, H, D)), axis=-1)
    vals = np.take_along_axis(table[..., 0], perm[..., None], axis=3)
    flat = vals.transpose(2, 3, 4, 0, 1).reshape(H * D * P, S * O).astype(object)
    mask = rng.integers(1, ctx.t, size=(D, S * O)).astype(object)
    flat[: D * P] = flat[: D * P] * np.repeat(mask, P, axis=0) % int(ctx.t)
    return (ctx.make_plaintext_mont(flat).reshape(H, D, P, ctx.L, ctx.n),
            ctx.make_plaintext_mont(mask))


ENCODE_CASES = {  # scheme, t, limbs, ring, leveled, host_table, item bits, encode_slab
    "bfv": ("bfv", T32, 6, 64, False, False, 32, 2048),
    "bfv_slabs": ("bfv", T32, 6, 64, False, False, 32, 5),
    "bfv_host_table": ("bfv", T32, 6, 64, False, True, 32, 7),
    "bfv_wide_items": ("bfv", T32, 6, 64, False, False, 63, 11),
    "bgv_flat": ("bgv", T32, 9, 64, False, False, 32, 2048),
    "bgv_leveled": ("bgv", T16, 6, 64, True, False, 16, 9),
    "bgv_leveled_host_table": ("bgv", T16, 6, 64, True, True, 16, 2048),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_matches_the_object_encode(case):
    scheme, t, limbs, ring, leveled, host_table, bits, slab = ENCODE_CASES[case]
    ctx = t_bfv.make_context(SchemeParams(ring, t, limbs, scheme=scheme), seed=2,
                             device="cpu")
    sk, _ = ctx.keygen()
    hct = _hct(16, 8, 3, 7)
    hct.insert_all(_items(150, bits), n_workers=1)
    pie = BatchedFHEPIE(ctx, hct, ctx.relin_keygen(sk), mask_seed=99, leveled=leveled,
                        host_table=host_table, encode_slab=slab)
    table, mask = _object_encode(ctx, hct, 99, 2, 3, 8)
    assert torch.equal(pie.table_pt, table) and torch.equal(pie.mask_pt, mask)
    assert pie.host_table == host_table
    span = TRACER.spans[-1]
    assert span.name == "build.encode" and span.counts == {"rows": 2 * 3 * 8 + 3}


@pytest.mark.parametrize("scheme, limbs", [("bfv", 6), ("bgv", 9)])
def test_device_built_pie_equals_the_jax_pie(scheme, limbs):
    """The torch insert and the device encode give the JAX package's table
    and masks at the same mask_seed."""
    from nested_hashing_psi_tpu.fhe import bfv as j_bfv
    from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
    from nested_hashing_psi_tpu.hashing import HierarchicalCuckooHashTable as JHierarchical
    from nested_hashing_psi_tpu.hashing import TabulationHashing as JTabulation
    from nested_hashing_psi_tpu.pie import batched_fhe as j_pie

    items = _items(400)
    jhct = _hct(16, 12, 4, 3, cls=JHierarchical, tab=JTabulation)
    jhct.insert_all(items, n_workers=1)
    thct = _hct(16, 12, 4, 3)
    device_build.insert_hierarchical(thct, items, "cpu")
    kw = dict(ring_dim=64, plaintext_modulus=T32, num_limbs=limbs, scheme=scheme)
    jctx = j_bfv.make_context(JSchemeParams(**kw), seed=4)
    tctx = t_bfv.make_context(SchemeParams(**kw), seed=5, device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    jpie = j_pie.BatchedFHEPIE(jctx, jhct, jrlk, mask_seed=11)
    tpie = BatchedFHEPIE(tctx, thct, trlk, mask_seed=11)
    table, mask = convert.pie_tables_to_numpy(tpie)
    np.testing.assert_array_equal(table, np.asarray(jpie.table_pt))
    np.testing.assert_array_equal(mask, np.asarray(jpie.mask_pt))


def _tiny_params(bgv=False):
    psi = PSIParams(server_set_size=300, client_set_size=12, intersection_set_size=5,
                    hash_seed=987654321, item_seed=123456789, bit_size=32, fhe=True,
                    batched=True, bgv=bgv, ring_dim=128, num_limbs=10)
    ht = HashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=4)
    return psi, ht


@pytest.mark.parametrize("bgv", [False, True])
def test_server_builds_on_its_device_and_records_the_split(bgv):
    psi, ht = _tiny_params(bgv)
    before = len(TRACER.spans)
    _, server, ok = run_in_process(psi, ht, device="cpu")
    assert ok and isinstance(server.server_table.table, torch.Tensor)
    host = HierarchicalCuckooHashTable.from_params(server.hasher, ht,
                                                   seed=psi.item_seed ^ 0x7A11)
    host.insert_all(server.server_set, n_workers=1)
    np.testing.assert_array_equal(server.server_table.table.numpy().view(np.uint64), host.table)
    mine = TRACER.spans[before:]
    assert [s.name for s in mine] == ["build.insert", "build.encode", "server.offline"]
    insert, encode, offline = mine
    assert all(offline.start_ns <= s.start_ns and s.end_ns <= offline.end_ns
               for s in (insert, encode))
    assert insert.parent == encode.parent == "server.offline"
    assert encode.counts == {"rows": 2 * 4 * 12 + 4}
    assert server.offline_computation_us == offline.duration_us


@pytest.mark.gpu
def test_card_build_equals_the_host_build_at_2_18():
    """The card's insert and encode against the serial NumPy insert and the
    object encode at 2^18 items, at the north star's load per bin (ring
    4096 keeps the object encode to seconds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    items = RandomDataInput(1 << 18, 16, 5, 3, 32).get_server_set()
    host, dev, span = _serial_and_device(items, (70, 48, 48, 7), device="cuda")
    assert dev.table.is_cuda and span.counts["rounds"] > 0
    _same_table(host, dev)
    ctx = t_bfv.make_context(SchemeParams(4096, T32, 6, scheme="bfv"), seed=2, device="cuda")
    sk, _ = ctx.keygen()
    pie = BatchedFHEPIE(ctx, dev, ctx.relin_keygen(sk), mask_seed=5)
    table, mask = _object_encode(ctx, host, 5, 2, 48, 48)
    assert torch.equal(pie.table_pt, table) and torch.equal(pie.mask_pt, mask)


def test_parties_set_the_host_allocator_once(monkeypatch):
    """With the build off the host, nothing else grows the host's heap:
    constructing a party sets the allocator to keep freed memory mapped,
    once per process; the wire layer sets nothing."""
    import ctypes

    from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel
    from nested_hashing_psi_tpu_torch.utils import host_heap

    calls = []
    monkeypatch.setattr(host_heap, "_heap_kept", False)
    monkeypatch.setattr(ctypes, "CDLL", lambda name: types.SimpleNamespace(
        mallopt=lambda param, value: calls.append((param, value)) or 1))
    a, b = LoopbackChannel.pair()
    convert.send(a, torch.arange(6, dtype=torch.int32))
    assert torch.equal(convert.receive(b, "cpu"), torch.arange(6, dtype=torch.int32))
    assert calls == []
    psi, ht = _tiny_params()
    BatchedFHEPSIServer(default_data(psi), psi, ht, a, device="cpu")
    BatchedFHEPSIClient(default_data(psi), psi, ht, b, device="cpu")
    assert calls == [(-3, 32 << 20), (-1, 1 << 30), (-2, 128 << 20)]
