"""Port BGV scheme ops (and the full-basis BFV product) against the JAX package.

Deterministic ops run on the same inputs (the JAX package's own keys and
ciphertexts, carried across with ``convert``) and must match bit for bit:
the tensor product and relinearisation, the modulus switch with the scale
it tracks, the host CRT decode of a BGV phase, the automorphisms of the
EvalSum ladder, and the full-basis BFV HPS product. The JAX side runs under
``jax.enable_x64(True)`` (the port computes its float estimates in float64).
Randomised ops (the port's own keygen, Galois keys, public-key encryption)
are checked through decryption, since the two packages draw from different
generators.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.fhe import bfv as j_bfv
from nested_hashing_psi_tpu.fhe import bgv as j_bgv
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe import bgv as t_bgv
from nested_hashing_psi_tpu_torch.fhe.galois import rotation_galois_element
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams

torch.set_num_threads(1)

T16 = 65537
T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
T40 = (1 << 40) + (1 << 22) + (1 << 20) + 1
RING = 64


def x64():
    return jax.enable_x64(True)


def _np(x):
    return convert.to_numpy(x)


def _pair(t, L, scheme="bgv", seed=3):
    """(JAX context, port context, JAX sk, port sk, JAX rlk, port rlk): the
    same scheme in both packages, the JAX keys carried into the port."""
    kw = dict(ring_dim=RING, plaintext_modulus=t, num_limbs=L, scheme=scheme)
    jctx = j_bfv.make_context(JSchemeParams(**kw), seed=seed)
    tctx = t_bfv.make_context(SchemeParams(**kw), seed=seed + 1, device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    return jctx, tctx, jsk, tsk, jrlk, trlk


@pytest.fixture(scope="module")
def bgv16():
    return _pair(T16, 5)


def _vals(t, seed, rows=2):
    return np.random.default_rng(seed).integers(0, min(t, 1 << 62), size=(rows, RING - 3))


def _enc(jctx, jsk, vals):
    """A JAX-encrypted ciphertext and its port copy (same form and scale)."""
    ct = jctx.encrypt_sk(jctx.make_plaintext_rns(vals), jsk)
    return ct, convert.ciphertext_from_numpy(np.asarray(ct.data), "cpu", ct.form, ct.scale)


def _same(got, want):
    assert (got.form, got.scale) == (want.form, want.scale)
    np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))


def test_make_context_takes_the_scheme():
    for scheme, cls in (("bgv", t_bgv.BGVContext), ("bfv", t_bfv.BFVContext)):
        ctx = t_bfv.make_context(SchemeParams(RING, T16, 3, scheme=scheme), device="cpu")
        assert type(ctx) is cls and ctx.default_form == scheme


@pytest.mark.parametrize("t", [T16, T32], ids=["t16", "t32"])
def test_tensor_product_relinearize_match(t):
    jctx, tctx, jsk, tsk, jrlk, trlk = _pair(t, 6)
    m1, m2 = _vals(t, 1), _vals(t, 2)
    ja, ta = _enc(jctx, jsk, m1)
    jb, tb = _enc(jctx, jsk, m2)
    with x64():
        jprod = jctx.ct_ct_mul(ja, jb)
        jrel = jctx.relinearize(jprod, jrlk)
    tprod = tctx.ct_ct_mul(ta, tb)
    _same(tprod, jprod)
    _same(tctx.relinearize(tprod, trlk), jrel)
    _same(tctx.ct_ct_mul_relin(ta, tb, trlk), jrel)
    slots, _ = tctx.decrypt(tctx.relinearize(tprod, trlk), tsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), (m1.astype(object) * m2) % t)


def test_add_and_plaintext_product_match(bgv16):
    jctx, tctx, jsk, *_ = bgv16
    ja, ta = _enc(jctx, jsk, _vals(T16, 3))
    jb, tb = _enc(jctx, jsk, _vals(T16, 4))
    pt = _vals(T16, 5).astype(object)
    with x64():
        jsum = jctx.ct_add(ja, jb)
        jmul = jctx.ct_pt_mul(ja, jctx.make_plaintext_mont(pt))
    _same(tctx.ct_add(ta, tb), jsum)
    _same(tctx.ct_pt_mul(ta, tctx.make_plaintext_mont(pt)), jmul)


@pytest.mark.parametrize("L", [3, 5, 8])
def test_mod_switch_matches(L):
    """The switch of a fresh ciphertext and of a relinearised product (whose
    message carries a scale), then once more in the child: same bits and
    the same tracked scale q_l^-1 mod t at each step."""
    jctx, tctx, jsk, tsk, jrlk, trlk = _pair(T16, L, seed=L)
    m1, m2 = _vals(T16, 10 + L), _vals(T16, 20 + L)
    ja, ta = _enc(jctx, jsk, m1)
    jb, tb = _enc(jctx, jsk, m2)
    with x64():
        jprod = jctx.ct_ct_mul_relin(ja, jb, jrlk)
    tprod = tctx.ct_ct_mul_relin(ta, tb, trlk)
    for jct, tct in ((ja, ta), (jprod, tprod)):
        with x64():
            want = jctx.mod_switch(jct)
        got = tctx.mod_switch(tct)
        _same(got, want)
        assert got.scale == pow(jctx.q_primes[-1], -1, T16)
        if L > 2:
            with x64():
                want2 = jctx.drop_limb_context().mod_switch(want)
            got2 = tctx.drop_limb_context().mod_switch(got)
            _same(got2, want2)
    slots, _ = tctx.decrypt(got, tsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), (m1.astype(object) * m2) % T16)


@pytest.mark.parametrize("t", [T16, T32, T40], ids=["t16", "t32", "t40"])
def test_phase_to_mt_bgv_matches(t):
    """The host CRT decode of BGV phases (float64 route below 2^33, the
    native __int128 kernel or the exact object route above), and the whole
    decrypt, against the JAX package on the same phase."""
    jctx, tctx, jsk, tsk, *_ = _pair(t, 4)
    m = _vals(t, 7, rows=3)
    jct, tct = _enc(jctx, jsk, m)
    phase = np.asarray(jctx.decrypt_phase(jct, jsk), dtype=np.uint64)
    np.testing.assert_array_equal(_np(tctx.decrypt_phase(tct, tsk)), phase.astype(np.uint32))
    with x64():
        jm, jnoise = jctx._phase_to_mt(phase)
    tm, tnoise = tctx._phase_to_mt(phase)
    np.testing.assert_array_equal(np.asarray(tm, dtype=object), np.asarray(jm, dtype=object))
    assert tnoise == jnoise
    slots, _ = tctx.decrypt(tct, tsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), m.astype(object))


def test_noise_bits_exact_matches(bgv16):
    jctx, tctx, jsk, tsk, *_ = bgv16
    jct, tct = _enc(jctx, jsk, _vals(T16, 8, rows=1))
    assert tctx.noise_bits_exact(tct, tsk) == jctx.noise_bits_exact(jct, jsk)


@pytest.fixture(scope="module")
def galois():
    """A BGV pair with the JAX package's Galois keys for the whole EvalSum
    ladder, carried into the port."""
    jctx, tctx, jsk, tsk, *_ = _pair(T16, 5, seed=11)
    els = jctx.sum_ladder_elements()
    assert tctx.sum_ladder_elements() == els
    jgks = jctx.galois_keygen(jsk, els)
    tgks = convert.galois_keys_from_numpy(
        {k: (np.asarray(g.b_mont), np.asarray(g.a_mont)) for k, g in jgks.items()}, "cpu"
    )
    return jctx, tctx, jsk, tsk, jgks, tgks


def test_galois_keys_carried_both_ways(galois):
    _, _, _, _, jgks, tgks = galois
    back = convert.galois_keys_to_numpy(tgks)
    assert sorted(back) == sorted(jgks)
    for k, (b, a) in back.items():
        np.testing.assert_array_equal(b, np.asarray(jgks[k].b_mont))
        np.testing.assert_array_equal(a, np.asarray(jgks[k].a_mont))


@pytest.mark.parametrize("which", [0, 2, 4, -1])  # rotations by 1, 4, 16; conjugation
def test_automorphism_matches(galois, which):
    jctx, tctx, jsk, _, jgks, tgks = galois
    k = jctx.sum_ladder_elements()[which]
    jct, tct = _enc(jctx, jsk, _vals(T16, 30 + which))
    with x64():
        want = jctx.automorphism(jct, k, jgks[k])
    _same(tctx.automorphism(tct, k, tgks[k]), want)


def test_rotate_conjugate_eval_sum_match(galois):
    jctx, tctx, jsk, tsk, jgks, tgks = galois
    m = _vals(T16, 40, rows=1)
    jct, tct = _enc(jctx, jsk, m)
    with x64():
        jrot = jctx.rotate_slots(jct, 2, jgks)
        jconj = jctx.conjugate(jct, jgks)
        jsum = jctx.eval_sum_all_slots(jct, jgks)
    _same(tctx.rotate_slots(tct, 2, tgks), jrot)
    _same(tctx.conjugate(tct, tgks), jconj)
    tsum = tctx.eval_sum_all_slots(tct, tgks)
    _same(tsum, jsum)
    slots, _ = tctx.decrypt(tsum, tsk)
    assert set(np.asarray(slots, dtype=object).ravel()) == {int(m.sum()) % T16}


def test_port_galois_keys_rotate():
    """The port's own keygen and Galois keys (its generator): a rotation by
    r and the conjugation permute the decrypted slots as the JAX package's
    do."""
    _, tctx, _, _, _, _ = _pair(T16, 4, seed=13)
    sk, _ = tctx.keygen()
    half = RING // 2
    k_rot = rotation_galois_element(RING, 3)
    gks = tctx.galois_keygen(sk, [k_rot, 2 * RING - 1])
    m = np.arange(1, RING + 1)
    ct = tctx.encrypt_sk(tctx.make_plaintext_rns(m), sk)
    rot, _ = tctx.decrypt(tctx.rotate_slots(ct, 3, gks), sk)
    want = np.concatenate([np.roll(m[:half], -3), np.roll(m[half:], -3)])
    np.testing.assert_array_equal(np.asarray(rot, np.int64), want)
    conj, _ = tctx.decrypt(tctx.conjugate(ct, gks), sk)
    np.testing.assert_array_equal(np.asarray(conj, np.int64), np.concatenate([m[half:], m[:half]]))


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_encrypt_pk_port_decrypt_jax(scheme):
    """Port keygen + public-key encryption, JAX decryption of the same key."""
    jctx, tctx, *_ = _pair(T32, 4, scheme=scheme)
    sk, pk = tctx.keygen()
    m = _vals(T32, 50)
    ct = tctx.encrypt_pk(tctx.make_plaintext_rns(m), pk)
    jsk = j_bgv.SecretKey(*(jnp.asarray(a) for a in convert.secret_key_to_numpy(sk)))
    data, form, scale = convert.ciphertext_to_numpy(ct)
    with x64():
        slots, _ = jctx.decrypt(j_bgv.Ciphertext(jnp.asarray(data), form, scale), jsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), m.astype(object))


@pytest.fixture(scope="module")
def bfv32():
    return _pair(T32, 6, scheme="bfv", seed=21)


def test_full_basis_bfv_products_match(bfv32):
    """The full-basis HPS product (mul_limbs = 0), fused with relin and
    not, the t-scaling bridge with its Delta-lifting relinearisation, and
    the drop-limb rescale of a ciphertext."""
    jctx, tctx, jsk, tsk, jrlk, trlk = bfv32
    m1, m2 = _vals(T32, 61), _vals(T32, 62)
    ja, ta = _enc(jctx, jsk, m1)
    jb, tb = _enc(jctx, jsk, m2)
    with x64():
        j_relin = jctx.ct_ct_mul_relin(ja, jb, jrlk)
        j_mul = jctx.ct_ct_mul(ja, jb)
        j_bridge = jctx.relinearize(jctx.ct_ct_mul_bridge(ja, jb), jrlk)
        j_rescaled = jctx.rescale_ct(ja, 4)
    got = tctx.ct_ct_mul_relin(ta, tb, trlk)
    _same(got, j_relin)
    _same(tctx.ct_ct_mul(ta, tb), j_mul)
    bridge = tctx.relinearize(tctx.ct_ct_mul_bridge(ta, tb), trlk)
    _same(bridge, j_bridge)
    _same(tctx.rescale_ct(ta, 4), j_rescaled)
    want = (m1.astype(object) * m2) % T32
    for ct in (got, bridge):
        slots, _ = tctx.decrypt(ct, tsk, RING - 3)
        np.testing.assert_array_equal(np.asarray(slots, dtype=object), want)
