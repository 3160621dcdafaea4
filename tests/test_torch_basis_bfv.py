"""Port basis conversions and BFV scheme ops against the JAX package.

Deterministic ops run on the same inputs (seeded numpy residues, or the JAX
package's own keys and ciphertexts carried across with ``convert``) and
must match bit for bit. The port computes its float overflow estimates in
float64 (ops/basis.py); the JAX side therefore runs under
``jax.enable_x64(True)``, where it does too. Randomised ops (keys,
encryption) are checked through decryption in the other package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.fhe import bfv as j_bfv
from nested_hashing_psi_tpu.fhe import bgv as j_bgv
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.ops import basis as j_basis
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe import bgv as t_bgv
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops import basis as t_basis
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

torch.set_num_threads(1)

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
RING, L, MUL, SHIP = 64, 6, 5, 3


def x64():
    return jax.enable_x64(True)


def _rand(shape, ps, seed):
    rng = np.random.default_rng(seed)
    p = np.array(ps, np.uint64).reshape(len(ps), 1)
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)


def _t(a):
    return convert.from_numpy(a, "cpu")


@pytest.mark.parametrize("n_drop", [1, 2, 3])
def test_rns_rescale_matches(n_drop):
    src = ntt_primes(L, 31, 2 * RING)
    x = _rand((2, 3, L, RING), src, seed=n_drop)
    with x64():
        want = np.asarray(j_basis.RNSRescale(src, n_drop).rescale(jnp.asarray(x)))
    got = t_basis.RNSRescale(src, n_drop).rescale(_t(x))
    np.testing.assert_array_equal(convert.to_numpy(got), want)


@pytest.fixture(scope="module")
def converters():
    q = ntt_primes(MUL, 31, 2 * RING, avoid=(T32,))
    jc, tc = j_basis.BFVMulConverter(q, T32, RING), t_basis.BFVMulConverter(q, T32, RING)
    assert tc.aux_primes == jc.aux_primes and tc.K == jc.K
    return q, jc, tc


@pytest.mark.parametrize("stage", ["extend", "extend_lazy", "scale_round", "exact_to_q"])
def test_bfv_mul_converter_stage_matches(converters, stage):
    q, jc, tc = converters
    aux = jc.aux_primes
    xq = _rand((3, len(q), RING), q, seed=11)
    xa = _rand((3, len(aux), RING), aux, seed=12)
    with x64():
        if stage == "extend":
            want = jc.extend_q_to_aux(jnp.asarray(xq))
            got = tc.extend_q_to_aux(_t(xq))
        elif stage == "extend_lazy":
            want = jc.extend_q_to_aux(jnp.asarray(xq), correction=False)
            got = tc.extend_q_to_aux(_t(xq), correction=False)
        elif stage == "scale_round":
            want = jc.scale_round(jnp.asarray(xq), jnp.asarray(xa))
            got = tc.scale_round(_t(xq), _t(xa))
        else:
            # a centered y with |y| < B/2: the exact conversion's domain
            y = np.asarray(jc.extend_q_to_aux(jnp.asarray(xq)))
            want = jc.exact_to_q(jnp.asarray(y))
            got = tc.exact_to_q(_t(y))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.fixture(scope="module")
def contexts():
    """The same scheme in both packages; the JAX context's keys are carried
    into the port."""
    kw = dict(ring_dim=RING, plaintext_modulus=T32, num_limbs=L, scheme="bfv")
    jctx = j_bfv.BFVContext(JSchemeParams(**kw), seed=3)
    tctx = t_bfv.BFVContext(SchemeParams(**kw), seed=4, device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    return jctx, tctx, jsk, jrlk, tsk, trlk


def _jax_rescaled_mul(jctx):
    """The JAX package's hps_mul_relin_rescaled as one jitted program (eager
    dispatch compiles every op). Its child contexts and rescalers are built
    eagerly first, as BatchedFHEPIE does: built inside the trace they would
    hold tracers."""
    mctx = jctx.context_for_limbs(MUL)
    mctx.mulconv
    jctx._rescaler(MUL)
    jctx.context_for_limbs(SHIP)
    mctx._rescaler(SHIP)
    return jax.jit(
        lambda a, b, rk: jctx.hps_mul_relin_rescaled(a, b, rk, MUL, ship_limbs=SHIP)
    )


def _vals(seed, rows=2):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(rows, RING - 3))


def test_context_constants_match(contexts):
    jctx, tctx, *_ = contexts
    for name in ("p", "pinv", "r2", "t_mont", "q_half", "delta_mont", "noise_mont"):
        np.testing.assert_array_equal(
            getattr(tctx, name).numpy(), np.asarray(getattr(jctx, name)).astype(np.int64),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        tctx.qk_mod_qj.numpy(), np.asarray(jctx.qk_mod_qj).astype(np.int64)
    )


def test_plaintexts_match(contexts):
    jctx, tctx, *_ = contexts
    v = _vals(1)
    np.testing.assert_array_equal(
        convert.to_numpy(tctx.make_plaintext_rns(v)), np.asarray(jctx.make_plaintext_rns(v))
    )
    np.testing.assert_array_equal(
        convert.to_numpy(tctx.make_plaintext_mont(v.astype(object))),
        np.asarray(jctx.make_plaintext_mont(v.astype(object))),
    )


def test_tensor_product_matches(contexts):
    jctx, tctx, *_ = contexts
    a = _rand((3, 2, L, RING), jctx.q_primes, seed=21)
    b = _rand((3, 2, L, RING), jctx.q_primes, seed=22)
    want = j_bgv.tensor_product(jnp.asarray(a), jnp.asarray(b), jctx.p, jctx.pinv, jctx.r2)
    got = t_bgv.tensor_product(_t(a), _t(b), tctx.p, tctx.pinv, tctx.r2)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def test_key_switch_coeffs_matches(contexts):
    jctx, tctx, _, jrlk, _, trlk = contexts
    poly = _rand((2, L, RING), jctx.q_primes, seed=31)
    jd0, jd1 = jax.jit(jctx._key_switch_coeffs)(jnp.asarray(poly), jrlk)
    td0, td1 = tctx._key_switch_coeffs(_t(poly), trlk)
    np.testing.assert_array_equal(convert.to_numpy(td0), np.asarray(jd0))
    np.testing.assert_array_equal(convert.to_numpy(td1), np.asarray(jd1))


def test_hps_mul_relin_rescaled_matches(contexts):
    """The fused rescaled ct x ct + relin on the same (JAX-encrypted)
    ciphertexts and relin key: identical bits, and the product decrypts."""
    jctx, tctx, jsk, jrlk, tsk, trlk = contexts
    m1, m2 = _vals(41), _vals(42)
    a = jctx.encrypt_sk(jctx.make_plaintext_rns(m1), jsk)
    b = jctx.encrypt_sk(jctx.make_plaintext_rns(m2), jsk)
    with x64():
        want = _jax_rescaled_mul(jctx)(a, b, jrlk)
    got = tctx.hps_mul_relin_rescaled(
        t_bgv.Ciphertext(_t(np.asarray(a.data)), "bfv"),
        t_bgv.Ciphertext(_t(np.asarray(b.data)), "bfv"),
        trlk, MUL, ship_limbs=SHIP,
    )
    assert got.data.shape[-2] == SHIP
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))
    slots, _ = tctx.decrypt(got, tsk, length=RING - 3)
    np.testing.assert_array_equal(
        np.asarray(slots, dtype=object), (m1.astype(object) * m2) % T32
    )


def test_encrypt_jax_decrypt_port(contexts):
    jctx, tctx, jsk, _, tsk, _ = contexts
    m = _vals(51)
    ct = jctx.encrypt_sk(jctx.make_plaintext_rns(m), jsk)
    slots, _ = tctx.decrypt(convert.ciphertext_from_numpy(np.asarray(ct.data), "cpu"), tsk, RING - 3)
    want, _ = jctx.decrypt(ct, jsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), np.asarray(want, dtype=object))
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), m.astype(object))


def test_encrypt_port_decrypt_jax():
    """Port keygen + encryption (its own generator), JAX decryption."""
    kw = dict(ring_dim=RING, plaintext_modulus=T32, num_limbs=L, scheme="bfv")
    jctx = j_bfv.BFVContext(JSchemeParams(**kw), seed=0)
    tctx = t_bfv.make_context(SchemeParams(**kw), seed=None, device="cpu")
    tsk, _ = tctx.keygen()
    m = _vals(61)
    ct = tctx.encrypt_sk(tctx.make_plaintext_rns(m), tsk)
    s_mont, s_ntt = convert.secret_key_to_numpy(tsk)
    jsk = j_bgv.SecretKey(s_mont=jnp.asarray(s_mont), s_ntt=jnp.asarray(s_ntt))
    jct = j_bgv.Ciphertext(jnp.asarray(convert.to_numpy(ct.data)), "bfv", 1)
    slots, _ = jctx.decrypt(jct, jsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), m.astype(object))
    # the port's own relin key works in both packages' rescaled mult
    rlk = tctx.relin_keygen(tsk)
    prod = tctx.hps_mul_relin_rescaled(ct, ct, rlk, MUL, ship_limbs=SHIP)
    slots, _ = tctx.decrypt(prod, tsk, RING - 3)
    want = (m.astype(object) ** 2) % T32
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), want)
    b_mont, a_mont = convert.relin_key_to_numpy(rlk)
    jrlk = j_bgv.RelinKey(b_mont=jnp.asarray(b_mont), a_mont=jnp.asarray(a_mont))
    jprod = _jax_rescaled_mul(jctx)(jct, jct, jrlk)
    slots, _ = jctx.decrypt(jprod, jsk, RING - 3)
    np.testing.assert_array_equal(np.asarray(slots, dtype=object), want)
