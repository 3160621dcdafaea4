"""The port's BGV batched PIE, leveled and flat, against the JAX package.

Mirrors tests/test_leveled_pie.py for the port: the leveled and flat PIEs
find the same intersection, the leveled result ships L - (H-1) limbs and its
noise stays within budget, and the 48-bit, three-hash-function BGV
configuration raises the JAX package's security error. Deterministic steps
are held bit-exact against the JAX package on its own keys and query
(``combine_ip``'s flat and leveled branches from the same ip / minus / mask /
relin key, and the whole PIE on the same mask_seed), the JAX side under
``jax.enable_x64(True)``.
"""

import numpy as np
import jax
import pytest
import torch

from nested_hashing_psi_tpu.config import HashTableParams as JHashTableParams
from nested_hashing_psi_tpu.config import PSIParams as JPSIParams
from nested_hashing_psi_tpu.fhe.bgv import BGVContext as JBGVContext
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints, items_to_ints
from nested_hashing_psi_tpu.pie import batched_fhe as j_pie
from nested_hashing_psi_tpu.protocol import batched_fhe as j_proto
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext
from nested_hashing_psi_tpu_torch.fhe.params import (
    LIMB_BITS,
    MAX_LOG_Q_128,
    SchemeParams,
    default_num_limbs,
    leveled_default,
    plaintext_modulus_for_bit_size,
)
from nested_hashing_psi_tpu_torch.pie import batched_fhe as t_pie
from nested_hashing_psi_tpu_torch.protocol import batched_fhe as t_proto

torch.set_num_threads(1)

T16 = 65537
RING, L = 256, 8
N_SIMPLE_HF, SIMPLE_SIZE, CUCKOO_SIZE, MAX_PP = 2, 16, 8, 4


def _setup(n_cuckoo_hf):
    """The JAX test's geometry: one nested table, the JAX package's keys and
    query, and the same keys in a port context."""
    hasher = TabulationHashing(31337, N_SIMPLE_HF + n_cuckoo_hf)
    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=SIMPLE_SIZE, each_cuckoo_table_size=CUCKOO_SIZE,
        n_simple_hash_functions=N_SIMPLE_HF, n_cuckoo_hash_functions=n_cuckoo_hf,
        max_items_per_position=MAX_PP, seed=3,
    )
    hct.insert_all(items_from_ints(list(range(200, 260))))
    client_table = CuckooHashTable(
        hasher, each_table_size=SIMPLE_SIZE, n_hash_functions=N_SIMPLE_HF,
        max_items_per_position=1, seed=4,
    )
    client_table.insert_all(items_from_ints([205, 231, 4242]))
    jctx = JBGVContext(JSchemeParams(ring_dim=RING, plaintext_modulus=T16, num_limbs=L), seed=9)
    tctx = BGVContext(SchemeParams(ring_dim=RING, plaintext_modulus=T16, num_limbs=L), seed=10,
                      device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    jops = j_pie.BatchedFHEClientOps(jctx, client_table, N_SIMPLE_HF, n_cuckoo_hf, CUCKOO_SIZE)
    idx_ct, minus_ct = jops.encrypt_query(jsk)
    return dict(hct=hct, jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jrlk=jrlk, trlk=trlk,
                client_table=client_table, H=n_cuckoo_hf,
                idx=convert.from_numpy(np.asarray(idx_ct.data), "cpu"),
                minus=convert.from_numpy(np.asarray(minus_ct.data), "cpu"),
                jidx=idx_ct, jminus=minus_ct)


@pytest.fixture(scope="module", params=[2, 3], ids=["H2", "H3"])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def pies(setup):
    """Port PIEs, flat and leveled, with one mask_seed."""
    kw = dict(mask_seed=7)
    return {lev: t_pie.BatchedFHEPIE(setup["tctx"], setup["hct"], setup["trlk"], leveled=lev, **kw)
            for lev in (False, True)}


def _extract(setup, slots):
    ops = t_pie.BatchedFHEClientOps(setup["tctx"], setup["client_table"], N_SIMPLE_HF,
                                    setup["H"], CUCKOO_SIZE)
    return sorted(items_to_ints(ops.extract_intersection(np.asarray(slots))))


def test_leveled_matches_flat(setup, pies):
    tctx, tsk, H = setup["tctx"], setup["tsk"], setup["H"]
    flat = pies[False](setup["idx"], setup["minus"])
    lev = pies[True](setup["idx"], setup["minus"])
    assert pies[False].leveled is False and pies[True].leveled is True
    assert pies[True].mul_limbs is None and pies[False].mul_limbs is None
    assert flat.data.shape[-2] == L and flat.form == "bgv"
    Lf = L - (H - 1)
    assert lev.data.shape[-2] == Lf, "leveled result must drop one limb per mult"
    slots_f, _ = tctx.decrypt(flat, tsk, length=pies[False].batch_slots)
    assert _extract(setup, slots_f) == [205, 231]
    dctx, dsk = tctx.context_for_limbs(Lf), tctx.shrink_key_to(tsk, Lf)
    slots_l, noise = dctx.decrypt(lev, dsk, length=pies[True].batch_slots)
    assert _extract(setup, slots_l) == [205, 231]
    assert noise < dctx.params.q.bit_length() - 10, f"leveled noise too high: {noise}"


@pytest.mark.parametrize("leveled", [False, True], ids=["flat", "leveled"])
def test_combine_ip_matches(setup, leveled):
    """combine_ip on the same ip / minus / mask / relin key, deterministic
    inputs from a numpy seed: the JAX package's bits, form and scale."""
    jctx, tctx, H = setup["jctx"], setup["tctx"], setup["H"]
    rng = np.random.default_rng(H)
    p = np.array(jctx.q_primes, np.uint64).reshape(L, 1)

    def res(shape):
        return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)

    ip, minus, mask = res((H, 2, 2, L, RING)), res((2, L, RING)), res((2, L, RING))
    if leveled:  # the leveled chain's contexts exist before tracing
        jctx.context_for_limbs(L - (H - 1))
    with jax.enable_x64(True):
        want = jax.jit(lambda i, m, k, rk: j_pie.combine_ip(jctx, rk, i, m, k, leveled=leveled))(
            ip, minus, mask, setup["jrlk"])
    got = t_pie.combine_ip(tctx, setup["trlk"], *(convert.from_numpy(a, "cpu") for a in (ip, minus, mask)),
                           leveled=leveled)
    assert (got.form, got.scale) == (want.form, want.scale)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))


def test_pie_matches_jax(setup, pies):
    """The whole leveled PIE (same mask_seed, the JAX query): same tables,
    same result bits."""
    jctx = setup["jctx"]
    jpie = j_pie.BatchedFHEPIE(jctx, setup["hct"], setup["jrlk"], mask_seed=7, leveled=True)
    tpie = pies[True]
    table, mask = convert.pie_tables_to_numpy(tpie)
    np.testing.assert_array_equal(table, np.asarray(jpie.table_pt))
    np.testing.assert_array_equal(mask, np.asarray(jpie.mask_pt))
    with jax.enable_x64(True):
        want = jpie.run(setup["jidx"], setup["jminus"])
    got = tpie(setup["idx"], setup["minus"])
    assert (got.form, got.scale) == (want.form, want.scale)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))


def test_multi_query_frame_scale_quirk(setup, pies):
    """The multi-query reply's frame says scale 1 (the JAX server's
    [is_bgv, 1]) while a leveled result carries the q_l^-1 mod t factors
    that mod_switch tracked down the chain (times each other through the
    products). Decrypted with the frame's scale, a Q = 2 query's slots are
    the Q = 1 slots times that factor, so the zero masks agree."""
    tctx, tsk, tpie = setup["tctx"], setup["tsk"], pies[True]
    i, m = setup["idx"], setup["minus"]
    one = tpie.run(Ciphertext(i, "bgv"), Ciphertext(m, "bgv"))
    many = tpie.run_many(torch.stack([i, i]), torch.stack([m, m]))
    Lf, factor = one.data.shape[-2], one.scale
    assert factor != 1
    dctx, dsk = tctx.context_for_limbs(Lf), tctx.shrink_key_to(tsk, Lf)
    s1, _ = dctx.decrypt(one, dsk, length=tpie.batch_slots)
    s2, _ = dctx.decrypt(Ciphertext(many, "bgv", 1), dsk, length=tpie.batch_slots)
    s1, s2 = np.asarray(s1, dtype=object), np.asarray(s2, dtype=object)
    for q in range(2):
        np.testing.assert_array_equal(s2[q], s1 * factor % T16)
        np.testing.assert_array_equal(s2[q] == 0, s1 == 0)


def test_leveled_asserts(setup):
    """The JAX package's leveled asserts: BGV with t < 2^31, and
    L - (H-1) >= 2."""
    hct, rlk, H = setup["hct"], setup["trlk"], setup["H"]
    short = BGVContext(SchemeParams(ring_dim=RING, plaintext_modulus=T16, num_limbs=H),
                       device="cpu")
    with pytest.raises(AssertionError, match="not enough limbs"):
        t_pie.BatchedFHEPIE(short, hct, rlk, leveled=True)
    big_t = (1 << 32) + (1 << 20) + (1 << 19) + 1
    big = BGVContext(SchemeParams(ring_dim=RING, plaintext_modulus=big_t, num_limbs=L),
                     device="cpu")
    with pytest.raises(AssertionError, match="t < 2"):
        t_pie.BatchedFHEPIE(big, hct, rlk, leveled=True)
    assert leveled_default("bgv", T16, 2) and not leveled_default("bfv", T16, 2)


def test_48bit_3hf_bgv_raises_the_jax_security_error():
    """48-bit items with three cuckoo hash functions under BGV: the flat
    budget exceeds the HEStd_128 cap at ring 16384 in both packages."""
    kw = dict(bit_size=48, fhe=True, batched=True, bgv=True)
    ht = dict(each_cuckoo_table_size=5000, n_cuckoo_hash_functions=3)
    with pytest.raises(ValueError) as want:
        j_proto._scheme_params(JPSIParams(**kw), JHashTableParams(**ht))
    with pytest.raises(ValueError) as got:
        t_proto._scheme_params(PSIParams(**kw), HashTableParams(**ht))
    assert str(got.value) == str(want.value) and "exceeds the 128-bit" in str(got.value)


def test_leveled_default_predicate():
    """Leveled for BGV at a device-sized t with a cross-hash product only
    (tests/test_leveled_pie.py's predicate, on the port)."""
    assert leveled_default("bgv", 65537, 2) is True
    assert leveled_default("bfv", 65537, 2) is False  # HPS: additive noise
    assert leveled_default("bgv", (1 << 32) + 1, 2) is False  # t too big
    assert leveled_default("bgv", 65537, 1) is False  # no ct x ct product


def test_leveled_limb_budget_smaller_at_depth():
    assert default_num_limbs(17, 2, 500, "bgv", leveled=True) < default_num_limbs(17, 2, 500,
                                                                                  "bgv")


def test_48bit_3hf_fits_security_cap():
    """48-bit items, three cuckoo hash functions: the HPS BFV budget fits
    under HEStd_128 at ring 16384 (the flat BGV one does not, above)."""
    t = plaintext_modulus_for_bit_size(48)
    limbs = default_num_limbs(t.bit_length(), 2, 5000, "bfv")
    assert limbs * LIMB_BITS <= MAX_LOG_Q_128[16384]
    SchemeParams(16384, t, num_limbs=limbs, scheme="bfv").validate_security()


def test_mask_plaintext_limb_slice_is_child_encoding():
    """Plaintext RNS limbs are independent: the first L' limbs of a
    full-basis Montgomery plaintext are the child context's encoding."""
    ctx = BGVContext(SchemeParams(64, 65537, num_limbs=5), seed=2, device="cpu")
    child = ctx.drop_limb_context()
    vals = np.arange(1, 33, dtype=np.int64).astype(object)
    full = ctx.make_plaintext_mont(vals).numpy()
    np.testing.assert_array_equal(full[: child.L], child.make_plaintext_mont(vals).numpy())
