"""The port's BGV scheme on its own keys: the counterpart of tests/test_bgv.py,
test for test, on the CPU (``fhe/bgv.py``, ``fhe/encoding.py``):
encode/encrypt/decrypt round trips and homomorphic operations, the
semantics the reference gets from OpenFHE (TestOpenFHE.cpp:8-104).
"""

import numpy as np

from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.fhe.encoding import PackedEncoder
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams


def small_ctx(t=65537, n=64, limbs=6, seed=3):
    return BGVContext(
        SchemeParams(ring_dim=n, plaintext_modulus=t, num_limbs=limbs), seed=seed, device="cpu"
    )


def test_encoder_roundtrip_small_t():
    enc = PackedEncoder(64, 65537)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 65537, size=64)
    coeffs = enc.encode(vals)
    back = enc.decode(coeffs)
    np.testing.assert_array_equal(back.astype(np.int64), vals)


def test_encoder_roundtrip_big_t():
    t = (1 << 32) + (1 << 20) + (1 << 19) + 1
    enc = PackedEncoder(32, t)
    rng = np.random.default_rng(1)
    vals = [int(v) for v in rng.integers(0, 2**32, size=32)]
    back = enc.decode(enc.encode(vals))
    assert [int(v) for v in back] == vals


def test_encoder_negative_and_padding():
    enc = PackedEncoder(64, 65537)
    coeffs = enc.encode([-5, 3])
    back = enc.decode(coeffs, length=4)
    assert int(back[0]) == 65537 - 5
    assert int(back[1]) == 3
    assert int(back[2]) == 0 and int(back[3]) == 0


def test_encrypt_decrypt_sk():
    ctx = small_ctx()
    sk, pk = ctx.keygen()
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 65537, size=64)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    slots, noise = ctx.decrypt(ct, sk)
    np.testing.assert_array_equal(np.asarray(slots, dtype=np.int64), vals)
    # the cheap estimate floors at ~log2(q)-51; must still show margin
    assert noise < 6 * 31 - 40
    # exact fresh noise: |t*e + m| ~ t * 6*sigma -> well under 30 bits
    assert ctx.noise_bits_exact(ct, sk) < 30


def test_encrypt_decrypt_pk():
    ctx = small_ctx(seed=5)
    sk, pk = ctx.keygen()
    vals = [7, 0, 65536, 12345]
    ct = ctx.encrypt_pk(ctx.make_plaintext_rns(vals), pk)
    slots, _ = ctx.decrypt(ct, sk, length=4)
    assert [int(v) for v in slots] == vals


def test_batched_encrypt():
    ctx = small_ctx(seed=7)
    sk, _ = ctx.keygen()
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 65537, size=(5, 64))
    cts = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    assert cts.data.shape == (5, 2, ctx.L, 64)
    slots, _ = ctx.decrypt(cts, sk)
    np.testing.assert_array_equal(np.asarray(slots, np.int64), vals)


def test_homomorphic_add():
    ctx = small_ctx(seed=11)
    sk, _ = ctx.keygen()
    a = np.arange(64) % 65537
    b = (np.arange(64) * 7 + 3) % 65537
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    slots, _ = ctx.decrypt(ctx.ct_add(ca, cb), sk)
    np.testing.assert_array_equal(np.asarray(slots, np.int64), (a + b) % 65537)


def test_ct_pt_mul():
    ctx = small_ctx(seed=13)
    sk, _ = ctx.keygen()
    rng = np.random.default_rng(4)
    a = rng.integers(0, 65537, size=64)
    b = rng.integers(0, 65537, size=64)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    res = ctx.ct_pt_mul(ct, ctx.make_plaintext_mont(b))
    slots, noise = ctx.decrypt(res, sk)
    np.testing.assert_array_equal(
        np.asarray(slots, np.int64), (a.astype(object) * b) % 65537
    )


def test_ct_ct_mul_and_relin():
    ctx = small_ctx(seed=17, limbs=8)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 65537, size=64)
    b = rng.integers(0, 65537, size=64)
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    expected = (a.astype(object) * b) % 65537

    # 3-component decrypt (pre-relin)
    c3 = ctx.ct_ct_mul(ca, cb)
    slots3, _ = ctx.decrypt(c3, sk)
    np.testing.assert_array_equal(np.asarray(slots3, np.int64), expected)

    # relinearized decrypt
    c2 = ctx.relinearize(c3, rlk)
    slots2, noise = ctx.decrypt(c2, sk)
    np.testing.assert_array_equal(np.asarray(slots2, np.int64), expected)
    assert noise < 8 * 31 - 10  # budget holds


def test_depth2_chain():
    """(a*b)*c with relin between: the batched PIE's nCuckooHF=3 shape."""
    ctx = small_ctx(seed=19, limbs=10)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    rng = np.random.default_rng(6)
    a, b, c = (rng.integers(0, 65537, size=64) for _ in range(3))
    ca = ctx.encrypt_sk(ctx.make_plaintext_rns(a), sk)
    cb = ctx.encrypt_sk(ctx.make_plaintext_rns(b), sk)
    cc = ctx.encrypt_sk(ctx.make_plaintext_rns(c), sk)
    ab = ctx.ct_ct_mul_relin(ca, cb, rlk)
    abc = ctx.ct_ct_mul_relin(ab, cc, rlk)
    slots, noise = ctx.decrypt(abc, sk)
    expected = (a.astype(object) * b * c) % 65537
    np.testing.assert_array_equal(np.asarray(slots, np.int64), expected)


def test_big_t_encrypt_decrypt():
    t = (1 << 32) + (1 << 20) + (1 << 19) + 1
    ctx = small_ctx(t=t, n=32, limbs=7, seed=23)
    sk, _ = ctx.keygen()
    vals = [0, 1, 2**32, t - 1, 123456789012]
    vals = [v % t for v in vals]
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    slots, _ = ctx.decrypt(ct, sk, length=len(vals))
    assert [int(v) for v in slots] == vals
