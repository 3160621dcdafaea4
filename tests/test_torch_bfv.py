"""The port's BFV scheme on its own keys: the counterpart of tests/test_bfv.py,
of tests/test_basis.py's ``BFVMulConverter`` oracles and of
tests/test_bfv_rescale.py's rescale tests, test for test, on the CPU.

Each test runs the JAX test's steps on the port (``fhe/bfv.py``,
``ops/basis.py``, ``pie/batched_fhe.py``) at its sizes and seeds, with the
port's own generator: Delta-encoding round trips, additions and plaintext
products, the t-scaling bridge with its Delta-lifting relinearisation, the
textbook HPS product (big t, a depth-3 chain, the PIE's zero test), the
base converter against exact integer oracles (its base sizing, the
centered extension, Shenoy-Kumaresan aux -> q across the centered range,
and scale_round within its documented slack), the drop-limb rescale of a
ciphertext, the rescaled PIE against the full-basis one, the limb models,
and the 6-limb basis at ring 16384 with its noise margin.
"""

import numpy as np
import pytest

from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bfv import BFVContext, make_context
from nested_hashing_psi_tpu_torch.fhe.params import (
    SchemeParams,
    bfv_mul_limbs,
    bfv_ship_limbs,
    default_num_limbs,
)
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints, items_to_ints
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEClientOps, BatchedFHEPIE

CPU = "cpu"
T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1  # the reference's 32-bit table


def ctx_small(t=65537, n=64, limbs=8, seed=41):
    return BFVContext(
        SchemeParams(ring_dim=n, plaintext_modulus=t, num_limbs=limbs, scheme="bfv"),
        seed=seed, device=CPU,
    )


def _ints(slots):
    return [int(v) for v in slots]


def _product(*vals, t=65537):
    out = np.ones(len(vals[0]), dtype=object)
    for v in vals:
        out = (out * np.asarray(v).astype(object)) % t
    return [int(v) for v in out]


def test_bfv_encrypt_decrypt():
    ctx = ctx_small()
    sk, pk = ctx.keygen()
    vals = np.random.default_rng(0).integers(0, 65537, size=64)
    for enc in (lambda m: ctx.encrypt_sk(m, sk), lambda m: ctx.encrypt_pk(m, pk)):
        ct = enc(ctx.make_plaintext_rns(vals))
        assert ct.form == "bfv"
        slots, _ = ctx.decrypt(ct, sk)
        np.testing.assert_array_equal(np.asarray(slots, np.int64), vals)


def test_bfv_add_and_ct_pt():
    ctx = ctx_small(seed=43)
    sk, _ = ctx.keygen()
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 65537, size=64), rng.integers(0, 65537, size=64)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    s, _ = ctx.decrypt(ctx.ct_add(ca, cb), sk)
    np.testing.assert_array_equal(np.asarray(s, np.int64), (a + b) % 65537)
    m, _ = ctx.decrypt(ctx.ct_pt_mul(ca, ctx.make_plaintext_mont(b)), sk)
    assert _ints(m) == _product(a, b)


def test_bfv_ct_ct_mul_mixed_form_via_bridge():
    """A BGV-form operand takes the t-scaling bridge; relinearisation
    Delta-lifts the product back to BFV form."""
    ctx = ctx_small(seed=47, limbs=10)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 65537, size=64), rng.integers(0, 65537, size=64)
    ca = ctx._to_mul_form(ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk))
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    assert ca.form == "bgv" and cb.form == "bfv"
    prod = ctx.ct_ct_mul_relin(ca, cb, rlk)
    assert prod.form == "bfv" and prod.scale != 1
    slots, noise = ctx.decrypt(prod, sk)
    assert _ints(slots) == _product(a, b)
    assert noise < 10 * 31 - 10


def _zero_test(ctx):
    """(a - a) * b: the PIE's zero test, decrypted."""
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    a = np.arange(2, 66)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cneg = ctx.encrypt_sk(ctx.make_plaintext_rns([-int(v) for v in a]), sk)
    other = ctx.encrypt_sk(ctx.make_plaintext_rns(np.arange(1, 65)), sk)
    slots, _ = ctx.decrypt(ctx.ct_ct_mul_relin(ctx.ct_add(ca, cneg), other, rlk), sk)
    return _ints(slots)


def test_bfv_zero_slots_survive_pipeline():
    assert _zero_test(ctx_small(seed=53, limbs=10)) == [0] * 64


def test_bfv_hps_mul():
    ctx = ctx_small(seed=59, limbs=6)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 65537, size=64), rng.integers(0, 65537, size=64)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    prod = ctx.ct_ct_mul_relin(ca, cb, rlk)
    assert prod.form == "bfv" and prod.scale == 1  # HPS keeps the form and the scale
    slots, _ = ctx.decrypt(prod, sk)
    assert _ints(slots) == _product(a, b)


def test_bfv_hps_mul_big_t():
    ctx = ctx_small(t=T32, seed=61, limbs=8)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(7)
    a = rng.integers(0, T32, size=64).astype(object)
    b = rng.integers(0, T32, size=64).astype(object)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    slots, _ = ctx.decrypt(ctx.ct_ct_mul_relin(ca, cb, rlk), sk)
    assert _ints(slots) == _product(a, b, t=T32)


def test_bfv_hps_depth_chain_low_limbs():
    """Three sequential products at 6 limbs (186-bit q)."""
    ctx = ctx_small(seed=67, limbs=6)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(8)
    vals = [rng.integers(0, 65537, size=64) for _ in range(4)]
    cts = [ctx.encrypt_sk(ctx.make_plaintext_rns(v), sk) for v in vals]
    acc = cts[0]
    for ct in cts[1:]:
        acc = ctx.ct_ct_mul_relin(acc, ct, rlk)
    slots, _ = ctx.decrypt(acc, sk)
    assert _ints(slots) == _product(*vals)


def test_bfv_hps_zero_slots():
    assert _zero_test(ctx_small(seed=71, limbs=6)) == [0] * 64


def test_bfv_bridge_still_available():
    ctx = ctx_small(seed=73, limbs=10)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(9)
    a, b = rng.integers(0, 65537, size=64), rng.integers(0, 65537, size=64)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    prod = ctx.relinearize(ctx.ct_ct_mul_bridge(ca, cb), rlk)
    assert prod.form == "bfv" and prod.scale != 1
    slots, _ = ctx.decrypt(prod, sk)
    assert _ints(slots) == _product(a, b)


# ---------------------------------------------------------------------------
# BFVMulConverter against exact integer oracles (tests/test_basis.py)
# ---------------------------------------------------------------------------


def _signed_residues(values, primes) -> np.ndarray:
    return np.stack([np.array([int(v) % p for v in values], np.uint32) for p in primes])


def _run(fn, *arrays) -> np.ndarray:
    return convert.to_numpy(fn(*(convert.from_numpy(a, CPU) for a in arrays)))


@pytest.fixture(scope="module")
def mc():
    return BFVMulConverter(ntt_primes(4, 31, 2 * 64), 65537, 64)


def _q(primes) -> int:
    return int(np.prod([int(p) for p in primes], dtype=object))


def test_mulconv_base_sizing(mc):
    # B > 2 * 2|y| with |y| <= (9/4) t n q
    assert mc.B > 9 * 65537 * 64 * _q(mc.q_primes)
    assert not set(mc.aux_primes) & set(mc.q_primes)


def test_mulconv_extend_centered(mc):
    rng = np.random.default_rng(3)
    mags = [int(v) for v in rng.integers(0, 1 << 60, size=64)]
    vals = [m if i % 2 else -m for i, m in enumerate(mags)]
    out = _run(mc.extend_q_to_aux, _signed_residues(vals, mc.q_primes))
    np.testing.assert_array_equal(out, _signed_residues(vals, mc.aux_primes))


def test_mulconv_exact_to_q_full_range(mc):
    """Exact across the centered range, values near +-B/2 included."""
    rng = np.random.default_rng(4)
    B = mc.B
    nbytes = (B.bit_length() + 15) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % B - B // 2 for _ in range(61)]
    vals += [-(B // 2) + 1, 0, B // 2 - 1]
    out = _run(mc.exact_to_q, _signed_residues(vals, mc.aux_primes))
    np.testing.assert_array_equal(out, _signed_residues(vals, mc.q_primes))


def test_mulconv_scale_round_oracle(mc):
    """scale_round then exact_to_q == round(t d / q), within the lazy
    conversion's shift of -u (u in [0, L)) and the documented +-1."""
    rng = np.random.default_rng(5)
    q, t, n = _q(mc.q_primes), 65537, 64
    bound = n * q * q // 4
    nbytes = (bound.bit_length() + 15) // 8
    ds = [int.from_bytes(rng.bytes(nbytes), "little") % (2 * bound) - bound for _ in range(64)]
    y = _run(mc.scale_round, _signed_residues(ds, mc.q_primes),
             _signed_residues(ds, mc.aux_primes))
    out = _run(mc.exact_to_q, y)
    want = []
    for d in ds:
        r = (t * d) % q
        if r > q // 2:
            r -= q
        want.append((t * d - r) // q)
    ok = np.zeros(out.shape[-1], bool)
    for delta in range(-len(mc.q_primes), 2):
        ok |= (out == _signed_residues([w + delta for w in want], mc.q_primes)).all(axis=0)
    assert ok.all()


# ---------------------------------------------------------------------------
# the drop-limb rescale and the rescaled PIE (tests/test_bfv_rescale.py)
# ---------------------------------------------------------------------------


def test_rescale_ct_preserves_message():
    ctx = make_context(SchemeParams(ring_dim=64, plaintext_modulus=65537, num_limbs=7,
                                    scheme="bfv"), seed=3, device=CPU)
    assert isinstance(ctx, BFVContext)
    sk, pk = ctx.keygen()
    slots = np.random.default_rng(4).integers(0, 65537, size=64)
    ct = ctx.encrypt_pk(ctx.make_plaintext_rns(slots), pk)
    for n_limbs in (5, 3, 2):
        down = ctx.rescale_ct(ct, n_limbs)
        assert down.data.shape[-2] == n_limbs
        got, noise = ctx.decrypt(down, sk, length=64)
        np.testing.assert_array_equal(np.asarray(got, np.int64), slots)
        assert noise < 31 * n_limbs - 17 - 2  # the t * small floor, far below budget


def _pie_setup(n_cuckoo_hf, seed):
    hasher = TabulationHashing(424242, 2 + n_cuckoo_hf)
    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=16, each_cuckoo_table_size=8,
        n_simple_hash_functions=2, n_cuckoo_hash_functions=n_cuckoo_hf,
        max_items_per_position=4, seed=seed)
    hct.insert_all(items_from_ints(list(range(200, 280))))
    client_table = CuckooHashTable(hasher, 16, 2, starting_hash_id=0,
                                   max_items_per_position=1, seed=seed + 1)
    client_table.insert_all(items_from_ints([205, 231, 4040]))
    return hct, client_table


@pytest.mark.parametrize("n_cuckoo_hf", [2, 3])
def test_rescaled_pie_matches_full_basis(n_cuckoo_hf):
    hct, client_table = _pie_setup(n_cuckoo_hf, 31)
    ctx = make_context(SchemeParams(ring_dim=64, plaintext_modulus=65537, num_limbs=8,
                                    scheme="bfv"), seed=5, device=CPU)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    flat = BatchedFHEPIE(ctx, hct, rlk, mask_seed=7, mul_limbs=0)
    resc = BatchedFHEPIE(ctx, hct, rlk, mask_seed=7)  # mul and ship limbs from the model
    assert resc.mul_limbs is not None and resc.mul_limbs < ctx.L
    assert resc.ship_limbs <= resc.mul_limbs
    ops = BatchedFHEClientOps(ctx, client_table, 2, n_cuckoo_hf, 8)
    idx_ct, minus_ct = ops.encrypt_query(sk)
    r_flat, r_resc = flat.run(idx_ct, minus_ct), resc.run(idx_ct, minus_ct)
    assert r_resc.data.shape[-2] == resc.ship_limbs
    s_flat, _ = ctx.decrypt(r_flat, sk, length=flat.batch_slots)
    s_resc, noise = ctx.decrypt(r_resc, sk, length=resc.batch_slots)
    np.testing.assert_array_equal(np.asarray(s_flat, np.uint64), np.asarray(s_resc, np.uint64))
    assert noise < 31 * resc.ship_limbs - 17 - 2
    assert sorted(items_to_ints(ops.extract_intersection(np.asarray(s_resc)))) == [205, 231]


def test_mul_limb_models():
    assert bfv_mul_limbs(33, 7, 1) == 5 and bfv_ship_limbs(33, 5) == 4  # the sweep's t
    assert bfv_mul_limbs(17, 8, 1) == 4 and bfv_ship_limbs(17, 4) == 3
    assert bfv_mul_limbs(33, 9, 2) == 7  # H = 3 chains need one more product's budget
    assert bfv_mul_limbs(49, 4, 1) == 4  # never above the context's basis


def test_ring16384_l6_rescaled_margin():
    """6 limbs at 32-bit t with the mask-first rescaled pipeline (the
    opt-in --numLimbs 6; the default stays 7): the measured noise leaves
    at least 10 bits on the ship basis."""
    assert default_num_limbs(T32.bit_length(), 1, 12, "bfv") == 7
    hct, client_table = _pie_setup(2, 77)
    ctx = make_context(SchemeParams(ring_dim=16384, plaintext_modulus=T32, num_limbs=6,
                                    scheme="bfv"), seed=9, device=CPU)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    pie = BatchedFHEPIE(ctx, hct, rlk)
    assert pie.mul_limbs == 5 and pie.ship_limbs == 4
    ops = BatchedFHEClientOps(ctx, client_table, 2, 2, 8)
    idx_ct, minus_ct = ops.encrypt_query(sk)
    slots, noise = ctx.decrypt(pie.run(idx_ct, minus_ct), sk, length=pie.batch_slots)
    budget = 31 * pie.ship_limbs - T32.bit_length() - 1
    assert noise < budget - 10, (noise, budget)
    assert sorted(items_to_ints(ops.extract_intersection(np.asarray(slots)))) == [205, 231]
