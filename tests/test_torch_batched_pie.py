"""Port batched PIE against the JAX package on one nested table.

For the same mask_seed the port's packed table and masks are bit-identical
to ``pie.batched_fhe.BatchedFHEPIE``'s (both draw numpy Philox). The online
step on the same (JAX-encrypted) query and relin key gives identical result
ciphertexts (the JAX side under ``jax.enable_x64(True)``, matching the
port's float64 estimates), identical decrypted slots and the same
intersection.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.fhe import bfv as j_bfv
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints, items_to_ints
from nested_hashing_psi_tpu.pie import batched_fhe as j_pie
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.pie import batched_fhe as t_pie

torch.set_num_threads(1)

HASH_SEED = 122333444455555
N_SIMPLE_HF, N_CUCKOO_HF, SIMPLE_SIZE, CUCKOO_SIZE, MAX_PP = 2, 2, 16, 8, 3
RING, L = 64, 6
T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
CLIENT_VALS = [105, 131, 159, 4242, 9999]  # 3 hits, 2 misses


@pytest.fixture(scope="module")
def setup():
    hasher = TabulationHashing(HASH_SEED, N_SIMPLE_HF + N_CUCKOO_HF)
    hct = HierarchicalCuckooHashTable(
        hasher,
        each_simple_table_size=SIMPLE_SIZE,
        each_cuckoo_table_size=CUCKOO_SIZE,
        n_simple_hash_functions=N_SIMPLE_HF,
        n_cuckoo_hash_functions=N_CUCKOO_HF,
        max_items_per_position=MAX_PP,
        seed=7,
    )
    hct.insert_all(items_from_ints(list(range(100, 160))))
    client_table = CuckooHashTable(
        hasher, each_table_size=SIMPLE_SIZE, n_hash_functions=N_SIMPLE_HF,
        starting_hash_id=0, max_items_per_position=1, seed=8,
    )
    client_table.insert_all(items_from_ints(CLIENT_VALS))
    kw = dict(ring_dim=RING, plaintext_modulus=T32, num_limbs=L, scheme="bfv")
    jctx = j_bfv.BFVContext(JSchemeParams(**kw), seed=4)
    tctx = t_bfv.BFVContext(SchemeParams(**kw), seed=5, device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    jpie = j_pie.BatchedFHEPIE(jctx, hct, jrlk, mask_seed=99)
    tpie = t_pie.BatchedFHEPIE(tctx, hct, trlk, mask_seed=99, encode_slab=7)
    jops = j_pie.BatchedFHEClientOps(jctx, client_table, N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE)
    idx_ct, minus_ct = jops.encrypt_query(jsk)
    return dict(hct=hct, jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jpie=jpie, tpie=tpie,
                jops=jops, client_table=client_table, idx=idx_ct, minus=minus_ct)


def test_tables_bit_identical(setup):
    jpie, tpie = setup["jpie"], setup["tpie"]
    table, mask = convert.pie_tables_to_numpy(tpie)
    np.testing.assert_array_equal(table, np.asarray(jpie.table_pt))
    np.testing.assert_array_equal(mask, np.asarray(jpie.mask_pt))
    assert (tpie.mul_limbs, tpie.ship_limbs) == (jpie.mul_limbs, jpie.ship_limbs)
    assert {"table_pt", "mask_pt", "rlk_b", "rlk_a"} <= set(tpie.state_dict())


def test_tables_carried_across(setup):
    """A port PIE built with another mask_seed, loaded with the JAX
    package's table and masks, answers exactly like the matching one."""
    jpie, tpie = setup["jpie"], setup["tpie"]
    other = t_pie.BatchedFHEPIE(tpie.ctx, setup["hct"], tpie.rlk, mask_seed=7)
    assert not torch.equal(other.table_pt, tpie.table_pt)
    convert.load_pie_tables(other, np.asarray(jpie.table_pt), np.asarray(jpie.mask_pt))
    i = convert.from_numpy(np.asarray(setup["idx"].data), "cpu")
    m = convert.from_numpy(np.asarray(setup["minus"].data), "cpu")
    assert torch.equal(other(i, m).data, tpie(i, m).data)


def test_position_sum_matches(setup):
    jctx, tpie = setup["jctx"], setup["tpie"]
    idx = np.asarray(setup["idx"].data)
    want = j_pie.position_sum(jctx, jnp.asarray(idx), setup["jpie"].table_pt)
    got = t_pie.position_sum(tpie.ctx, convert.from_numpy(idx, "cpu"), tpie.table_pt)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def test_forward_matches_and_decrypts(setup):
    jctx, jpie, tpie = setup["jctx"], setup["jpie"], setup["tpie"]
    idx, minus = setup["idx"], setup["minus"]
    with jax.enable_x64(True):
        want = jax.jit(
            lambda i, m, tbl, msk, rk: j_pie.batched_pie_forward(
                jctx, rk, i, m, tbl, msk,
                mul_limbs=jpie.mul_limbs, ship_limbs=jpie.ship_limbs,
            )
        )(idx.data, minus.data, jpie.table_pt, jpie.mask_pt, jpie.rlk)
    got = tpie(convert.from_numpy(np.asarray(idx.data), "cpu"),
               convert.from_numpy(np.asarray(minus.data), "cpu"))
    assert got.data.shape == (MAX_PP, 2, tpie.ship_limbs, RING)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))

    t_slots, _ = tpie.ctx.decrypt(got, setup["tsk"], length=tpie.batch_slots)
    j_slots, _ = jctx.decrypt(want, setup["jsk"], length=jpie.batch_slots)
    np.testing.assert_array_equal(np.asarray(t_slots, dtype=object), np.asarray(j_slots, dtype=object))
    tops = t_pie.BatchedFHEClientOps(tpie.ctx, setup["client_table"], N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE)
    got_items = tops.extract_intersection(np.asarray(t_slots))
    np.testing.assert_array_equal(got_items, setup["jops"].extract_intersection(np.asarray(j_slots)))
    assert sorted(items_to_ints(got_items)) == [105, 131, 159]


def test_run_many_matches_run(setup):
    tpie = setup["tpie"]
    i = convert.from_numpy(np.asarray(setup["idx"].data), "cpu")
    m = convert.from_numpy(np.asarray(setup["minus"].data), "cpu")
    one = tpie.run(Ciphertext(i, "bfv"), Ciphertext(m, "bfv")).data
    many = tpie.run_many(torch.stack([i, i]), torch.stack([m, m]))
    assert torch.equal(many[0], one) and torch.equal(many[1], one)


def _query(setup):
    return (convert.from_numpy(np.asarray(setup["idx"].data), "cpu"),
            convert.from_numpy(np.asarray(setup["minus"].data), "cpu"))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_run_streamed_matches_forward(setup, width):
    """Chunks of the index summed against their table slices in place, then
    one combine: identical to the one-shot online step."""
    tpie = setup["tpie"]
    i, m = _query(setup)
    chunks = ((p0, i[:, p0 : p0 + width]) for p0 in range(0, CUCKOO_SIZE, width))
    got = tpie.run_streamed(chunks, Ciphertext(m, "bfv"))
    assert torch.equal(got.data, tpie(i, m).data)


@pytest.fixture(scope="module")
def host_pie(setup):
    tpie = setup["tpie"]
    return t_pie.BatchedFHEPIE(tpie.ctx, setup["hct"], tpie.rlk, mask_seed=99,
                               encode_slab=7, host_table=True)


def test_host_table_is_bit_identical(setup, host_pie):
    tpie = setup["tpie"]
    assert host_pie.table_pt.device.type == "cpu"
    assert torch.equal(host_pie.table_pt, tpie.table_pt)
    assert torch.equal(host_pie.mask_pt, tpie.mask_pt)
    # position-major host layout: every slice of positions is contiguous
    assert host_pie._host_positions().is_contiguous()


@pytest.mark.parametrize("pos_chunk", [None, 1, 2, 4, 3])  # 3 is lowered to 2
def test_host_table_run_matches_device_table(setup, host_pie, pos_chunk):
    i, m = _query(setup)
    got = host_pie._run_host_table(Ciphertext(i, "bfv"), Ciphertext(m, "bfv"), pos_chunk)
    assert torch.equal(got.data, setup["tpie"](i, m).data)


def test_host_table_run_streamed_and_many(setup, host_pie):
    i, m = _query(setup)
    want = setup["tpie"](i, m).data
    assert torch.equal(host_pie.run(Ciphertext(i, "bfv"), Ciphertext(m, "bfv")).data, want)
    chunks = ((p0, i[:, p0 : p0 + 4]) for p0 in (0, 4))
    assert torch.equal(host_pie.run_streamed(chunks, Ciphertext(m, "bfv")).data, want)
    many = host_pie.run_many(torch.stack([i, i]), torch.stack([m, m]))
    assert torch.equal(many[0], want) and torch.equal(many[1], want)


def test_host_table_matches_jax_host_table(setup, host_pie):
    """The JAX package's host-resident PIE (same mask_seed, same slab) has
    the same table and answers the same query bit for bit."""
    jpie, jctx = setup["jpie"], setup["jctx"]
    jhost = j_pie.BatchedFHEPIE(jctx, setup["hct"], jpie.rlk, mask_seed=99,
                                host_table=True, encode_slab=7)
    np.testing.assert_array_equal(jhost.table_pt, convert.to_numpy(host_pie.table_pt))
    with jax.enable_x64(True):
        want = jhost.run(setup["idx"], setup["minus"])
    i, m = _query(setup)
    got = host_pie.run(Ciphertext(i, "bfv"), Ciphertext(m, "bfv"))
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))


def test_port_client_query_decrypts_to_intersection(setup):
    """The port's own client ops (its keys, its encryption) against the port
    PIE loaded with the same table: the zero slots are the intersection."""
    tctx = setup["tctx"]
    tsk, _ = tctx.keygen()
    rlk = tctx.relin_keygen(tsk)
    hct_pie = setup["tpie"]
    ops = t_pie.BatchedFHEClientOps(tctx, setup["client_table"], N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE)
    idx_ct, minus_ct = ops.encrypt_query(tsk)
    res = t_pie.batched_pie_forward(
        tctx, rlk, idx_ct.data, minus_ct.data, hct_pie.table_pt, hct_pie.mask_pt,
        mul_limbs=hct_pie.mul_limbs, ship_limbs=hct_pie.ship_limbs,
    )
    slots, _ = tctx.decrypt(res, tsk, length=hct_pie.batch_slots)
    assert sorted(items_to_ints(ops.extract_intersection(np.asarray(slots)))) == [105, 131, 159]


def test_unported_paths_raise(setup):
    """Every BFV product pipeline is ported: mul_limbs=0 (and None on a
    direct call) takes the flat full-basis product, bit-equal to the JAX
    package's; the leveled chain is BGV-only in both packages."""
    jctx, tctx, tpie = setup["jctx"], setup["tctx"], setup["tpie"]
    ip = np.random.default_rng(3).integers(0, 1 << 30, size=(2, MAX_PP, 2, L, RING), dtype=np.uint32)
    tip = convert.from_numpy(ip, "cpu")
    with pytest.raises(AssertionError, match="BGV-only"):
        t_pie.combine_ip(tctx, tpie.rlk, tip, tip[0, 0], tpie.mask_pt, leveled=True)
    with pytest.raises(AssertionError, match="leveled PIE requires BGV"):
        t_pie.BatchedFHEPIE(tctx, setup["hct"], tpie.rlk, leveled=True)
    with jax.enable_x64(True):
        want = jax.jit(lambda i, m, k, rk: j_pie.combine_ip(jctx, rk, i, m, k, mul_limbs=0))(
            ip, ip[0, 0], setup["jpie"].mask_pt, setup["jpie"].rlk)
    for mul_limbs in (0, None):
        got = t_pie.combine_ip(tctx, tpie.rlk, tip, tip[0, 0], tpie.mask_pt, mul_limbs=mul_limbs)
        assert got.data.shape == (MAX_PP, 2, L, RING) and got.form == want.form == "bfv"
        np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))
    flat = t_pie.BatchedFHEPIE(tctx, setup["hct"], tpie.rlk, mask_seed=99, mul_limbs=0)
    assert flat.mul_limbs is None and torch.equal(flat.table_pt, tpie.table_pt)


def test_fhe_pie_rejects_combined_tables():
    """The batched FHE PIE refuses combined tables, as the reference's
    BatchedFHEHIPPIE.cpp:18-21 (tests/test_elgamal.py's check, on the port)."""
    hct = HierarchicalCuckooHashTable(
        TabulationHashing(11, 4), each_simple_table_size=8, each_cuckoo_table_size=12,
        n_simple_hash_functions=2, n_cuckoo_hash_functions=2, max_items_per_position=3,
        cuckoo_multi_table=False, seed=1)
    ctx = t_bfv.make_context(SchemeParams(ring_dim=32, plaintext_modulus=65537, num_limbs=3),
                             seed=2, device="cpu")
    sk, _ = ctx.keygen()
    with pytest.raises(ValueError, match="combined"):
        t_pie.BatchedFHEPIE(ctx, hct, ctx.relin_keygen(sk))
