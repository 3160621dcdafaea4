"""The port's rotations and automorphisms: the counterpart of
tests/test_galois.py, test for test, on the CPU (EvalRotate / EvalSum
semantics, the reference's TestOpenFHE rotation smoke test).
"""

import numpy as np
import pytest

from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.fhe.galois import (
    automorphism_ntt_perm,
    ntt_exponent_map,
    slot_to_ntt_pos,
)
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams


@pytest.fixture(scope="module")
def ctx_and_keys():
    ctx = BGVContext(
        SchemeParams(ring_dim=64, plaintext_modulus=65537, num_limbs=8), seed=31, device="cpu"
    )
    sk, _ = ctx.keygen()
    els = set(ctx.sum_ladder_elements())
    els.add(pow(5, 1, 128))        # rot 1
    els.add(pow(5, 3, 128))        # rot 3
    els.add(pow(5, -1, 128))       # rot -1 (shift right)
    gks = ctx.galois_keygen(sk, sorted(els))
    return ctx, sk, gks


def test_slot_structure_maps_are_bijections():
    E, pos = ntt_exponent_map(64)
    assert sorted(E) == list(range(1, 128, 2))
    s2n = slot_to_ntt_pos(64)
    assert sorted(s2n) == list(range(64))
    perm = automorphism_ntt_perm(64, 5)
    assert sorted(perm) == list(range(64))


def test_rotate_slots(ctx_and_keys):
    ctx, sk, gks = ctx_and_keys
    n, half = 64, 32
    vals = np.arange(1, n + 1)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    for r in (1, 3):
        rot = ctx.rotate_slots(ct, r, gks)
        slots, _ = ctx.decrypt(rot, sk)
        got = np.asarray(slots, np.int64)
        expected = np.concatenate(
            [np.roll(vals[:half], -r), np.roll(vals[half:], -r)]
        )
        np.testing.assert_array_equal(got, expected)


def test_rotate_right(ctx_and_keys):
    ctx, sk, gks = ctx_and_keys
    n, half = 64, 32
    vals = np.arange(1, n + 1)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    rot = ctx.rotate_slots(ct, -1, gks)
    slots, _ = ctx.decrypt(rot, sk)
    expected = np.concatenate([np.roll(vals[:half], 1), np.roll(vals[half:], 1)])
    np.testing.assert_array_equal(np.asarray(slots, np.int64), expected)


def test_conjugate_swaps_halves(ctx_and_keys):
    ctx, sk, gks = ctx_and_keys
    n, half = 64, 32
    vals = np.arange(1, n + 1)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    conj = ctx.conjugate(ct, gks)
    slots, _ = ctx.decrypt(conj, sk)
    expected = np.concatenate([vals[half:], vals[:half]])
    np.testing.assert_array_equal(np.asarray(slots, np.int64), expected)


def test_eval_sum_all_slots(ctx_and_keys):
    ctx, sk, gks = ctx_and_keys
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 65537, size=64)
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    summed = ctx.eval_sum_all_slots(ct, gks)
    slots, noise = ctx.decrypt(summed, sk)
    total = int(vals.sum()) % 65537
    assert all(int(v) == total for v in slots)
    assert noise < 8 * 31 - 10
