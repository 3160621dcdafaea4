"""The port's SimpleFHE PIE and client ops against the JAX package.

For the same mask_seed the port's table, selectors, masks and hash-function
permutation are the JAX package's bit for bit (both draw numpy Philox in the
same order). On the JAX package's keys, Galois keys and query, the online
step (``SimpleFHEPIE._run_impl``: ct x pt products, EvalSum ladder, selector
merge, mask, hash-function shuffle) gives identical result ciphertexts under
BFV and BGV, the JAX side under ``jax.enable_x64(True)``; the chunked run
(last chunk zero-padded) equals the single-shot run. The port's own
encryption is randomised and is checked through decryption.
"""

import numpy as np
import jax
import pytest
import torch

from nested_hashing_psi_tpu.fhe import bfv as j_bfv
from nested_hashing_psi_tpu.fhe import bgv as j_bgv
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints, items_to_ints
from nested_hashing_psi_tpu.pie import simple_fhe as j_pie
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.pie import simple_fhe as t_pie

torch.set_num_threads(1)

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
RING, L = 64, 6
N_SIMPLE_HF, N_CUCKOO_HF, SIMPLE_SIZE, CUCKOO_SIZE, MAX_PP = 2, 2, 8, 10, 6
CLIENT_VALS = [205, 231, 247, 4242]  # 3 hits, 1 miss


@pytest.fixture(scope="module", params=["bfv", "bgv"])
def setup(request):
    scheme = request.param
    hasher = TabulationHashing(4711, N_SIMPLE_HF + N_CUCKOO_HF)
    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=SIMPLE_SIZE, each_cuckoo_table_size=CUCKOO_SIZE,
        n_simple_hash_functions=N_SIMPLE_HF, n_cuckoo_hash_functions=N_CUCKOO_HF,
        max_items_per_position=MAX_PP, seed=5,
    )
    hct.insert_all(items_from_ints(list(range(200, 250))))
    client_table = CuckooHashTable(
        hasher, each_table_size=SIMPLE_SIZE, n_hash_functions=N_SIMPLE_HF,
        max_items_per_position=1, seed=6,
    )
    client_table.insert_all(items_from_ints(CLIENT_VALS))
    kw = dict(ring_dim=RING, plaintext_modulus=T32, num_limbs=L, scheme=scheme)
    jctx = j_bfv.make_context(JSchemeParams(**kw), seed=1)
    tctx = t_bfv.make_context(SchemeParams(**kw), seed=2, device="cpu")
    jsk, _ = jctx.keygen()
    jgks = jctx.galois_keygen(jsk, jctx.sum_ladder_elements())
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    tgks = convert.galois_keys_from_numpy(
        {k: (np.asarray(g.b_mont), np.asarray(g.a_mont)) for k, g in jgks.items()}, "cpu"
    )
    jpie = j_pie.SimpleFHEPIE(jctx, hct, jgks, mask_seed=5)
    tpie = t_pie.SimpleFHEPIE(tctx, hct, tgks, mask_seed=5)
    args = (client_table, N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE, MAX_PP)
    jops, tops = j_pie.SimpleFHEClientOps(jctx, *args), t_pie.SimpleFHEClientOps(tctx, *args)
    jidx = jops.encrypt_query(jsk)
    return dict(hct=hct, jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jgks=jgks, tgks=tgks,
                jpie=jpie, tpie=tpie, jops=jops, tops=tops, jidx=jidx,
                idx=convert.from_numpy(np.asarray(jidx.data), "cpu"))


def test_tables_bit_identical(setup):
    jpie, tpie = setup["jpie"], setup["tpie"]
    table, sel, mask, hf_perm = convert.simple_pie_tables_to_numpy(tpie)
    np.testing.assert_array_equal(table, np.asarray(jpie.table_pt))
    np.testing.assert_array_equal(sel, np.asarray(jpie.sel_pt))
    np.testing.assert_array_equal(mask, np.asarray(jpie.mask_pt))
    np.testing.assert_array_equal(hf_perm, jpie.hf_perm)
    np.testing.assert_array_equal(tpie.bin_perm, jpie.bin_perm)
    assert {"table_pt", "sel_pt", "mask_pt", "hf_perm", "gk_b", "gk_a"} <= set(tpie.state_dict())
    assert sorted(tpie.gk_elements) == sorted(setup["jgks"])


def test_run_impl_matches(setup):
    """The online step on the JAX query and Galois keys: the JAX package's
    result bits, form and scale."""
    jpie, tpie = setup["jpie"], setup["tpie"]
    with jax.enable_x64(True):
        want = jpie.run(setup["jidx"])
    got = tpie.run(Ciphertext(setup["idx"], setup["tctx"].default_form))
    assert got.data.shape == (tpie.n_pies, N_CUCKOO_HF, 2, L, RING)
    assert (got.form, got.scale) == (want.form, want.scale)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))


@pytest.mark.parametrize("chunk", [3, 5])
def test_chunked_run_matches_single_shot(setup, chunk):
    """Pie chunks of one width, the last one zero-padded, give the one-shot
    result bit for bit."""
    tpie = setup["tpie"]
    assert tpie.n_pies % chunk != 0
    ct = Ciphertext(setup["idx"], setup["tctx"].default_form)
    assert torch.equal(tpie.run(ct, pie_chunk=chunk).data, tpie.run(ct).data)


def test_tables_carried_across(setup):
    """A port PIE built with another mask_seed, loaded with the JAX
    package's tables, answers exactly like the matching one."""
    jpie, tpie = setup["jpie"], setup["tpie"]
    other = t_pie.SimpleFHEPIE(setup["tctx"], setup["hct"], setup["tgks"], mask_seed=9)
    assert not torch.equal(other.mask_pt, tpie.mask_pt)
    convert.load_simple_pie_tables(other, np.asarray(jpie.table_pt), np.asarray(jpie.sel_pt),
                                   np.asarray(jpie.mask_pt), jpie.hf_perm)
    ct = Ciphertext(setup["idx"], setup["tctx"].default_form)
    assert torch.equal(other.run(ct).data, tpie.run(ct).data)


def test_index_vectors_match(setup):
    np.testing.assert_array_equal(setup["tops"].build_index_vectors(),
                                  setup["jops"].build_index_vectors())


def test_port_query_decrypts_to_intersection(setup, monkeypatch):
    """The port's own encryption (in chunks of 5 rows) through the port PIE:
    the zero slots are the intersection, in the JAX package's decrypt too."""
    tctx, tops, tpie = setup["tctx"], setup["tops"], setup["tpie"]
    monkeypatch.setattr(tops, "ENC_CHUNK_BYTES", 5 * 2 * L * RING * 4)
    idx = tops.encrypt_query(setup["tsk"])
    res = tpie.run(idx)
    flat = Ciphertext(res.data.reshape(-1, 2, L, RING), res.form, res.scale)
    slots, _ = tctx.decrypt(flat, setup["tsk"], length=MAX_PP)
    got = tops.extract_intersection(np.asarray(slots).reshape(tpie.n_pies, N_CUCKOO_HF, MAX_PP))
    assert sorted(items_to_ints(got)) == [205, 231, 247]
    jctx = setup["jctx"]
    data, form, scale = convert.ciphertext_to_numpy(flat)
    with jax.enable_x64(True):
        jslots, _ = jctx.decrypt(j_bgv.Ciphertext(jax.numpy.asarray(data), form, scale),
                                 setup["jsk"], length=MAX_PP)
    np.testing.assert_array_equal(np.asarray(jslots, dtype=object),
                                  np.asarray(slots, dtype=object))
