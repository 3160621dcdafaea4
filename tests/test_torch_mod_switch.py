"""The port's BGV modulus switch: the counterpart of tests/test_mod_switch.py,
test for test, on the CPU: correctness, scale tracking and noise reduction.
"""

import numpy as np
import pytest

from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams


@pytest.fixture(scope="module")
def ctx():
    return BGVContext(
        SchemeParams(ring_dim=64, plaintext_modulus=65537, num_limbs=8), seed=71, device="cpu"
    )


def test_mod_switch_preserves_message(ctx):
    sk, _ = ctx.keygen()
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 65537, size=64)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    small = ctx.mod_switch(ct)
    assert small.data.shape[-2] == ctx.L - 1
    child = ctx.drop_limb_context()
    slots, noise = child.decrypt(small, ctx.shrink_key(sk))
    np.testing.assert_array_equal(np.asarray(slots, np.int64), vals)
    assert noise < (ctx.L - 1) * 31 - 10


def test_mod_switch_after_mult_reduces_relative_noise(ctx):
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 65537, size=64)
    b = rng.integers(0, 65537, size=64)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    prod = ctx.ct_ct_mul_relin(ca, cb, rlk)
    noise_before = ctx.noise_bits_exact(prod, sk)

    small = ctx.mod_switch(prod)
    child = ctx.drop_limb_context()
    sk_small = ctx.shrink_key(sk)
    slots, _ = child.decrypt(small, sk_small)
    np.testing.assert_array_equal(
        np.asarray(slots, np.int64), (a.astype(object) * b) % 65537
    )
    noise_after = child.noise_bits_exact(small, sk_small)
    # noise shrinks by ~log2(q_l) = 31 bits (minus the rounding term)
    assert noise_after < noise_before - 20


def test_mod_switch_twice(ctx):
    sk, _ = ctx.keygen()
    vals = np.arange(64)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    s1 = ctx.mod_switch(ct)
    child = ctx.drop_limb_context()
    s2 = child.mod_switch(s1)
    grand = child.drop_limb_context()
    slots, _ = grand.decrypt(s2, child.shrink_key(ctx.shrink_key(sk)))
    np.testing.assert_array_equal(np.asarray(slots, np.int64), vals)
