"""The port's host copies (primes, params, encoding, galois) give the same
results as the JAX package's originals, including the big-t encode path at
t = 2^32 + 2^20 + 2^19 + 1 (the main path's 32-bit items)."""

import numpy as np
import pytest

from nested_hashing_psi_tpu.fhe import encoding as j_enc
from nested_hashing_psi_tpu.fhe import galois as j_galois
from nested_hashing_psi_tpu.fhe import params as j_params
from nested_hashing_psi_tpu.ops import primes as j_primes
from nested_hashing_psi_tpu.ops import refmodel as j_ref
from nested_hashing_psi_tpu_torch.fhe import encoding as t_enc
from nested_hashing_psi_tpu_torch.fhe import galois as t_galois
from nested_hashing_psi_tpu_torch.fhe import params as t_params
from nested_hashing_psi_tpu_torch.ops import primes as t_primes

T16, T32 = 65537, (1 << 32) + (1 << 20) + (1 << 19) + 1


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_primes_equal(n):
    for count, avoid in ((6, ()), (9, (T32,))):
        assert t_primes.ntt_primes(count, 31, 2 * n, avoid) == j_primes.ntt_primes(
            count, 31, 2 * n, avoid
        )
    p = t_primes.ntt_primes(1, 31, 2 * n)[0]
    assert t_primes.primitive_root_of_unity(p, 2 * n) == j_primes.primitive_root_of_unity(p, 2 * n)
    rs, ms = [3, 5, 7], list(t_primes.ntt_primes(3, 31, 2 * n))
    assert t_primes.crt_reconstruct(rs, ms) == j_primes.crt_reconstruct(rs, ms)
    assert t_primes.centered(ms[0] - 1, ms[0]) == j_primes.centered(ms[0] - 1, ms[0])


@pytest.mark.parametrize("bits", [16, 32, 40, 48])
@pytest.mark.parametrize("ring", [128, 16384])
def test_params_rules_equal(bits, ring):
    t = t_params.plaintext_modulus_for_bit_size(bits)
    assert t == j_params.plaintext_modulus_for_bit_size(bits)
    tb = t.bit_length()
    for P, H in ((12, 2), (48, 3), (7, 2)):
        assert t_params.bfv_batched_client_limbs(tb, P, H, ring) == \
            j_params.bfv_batched_client_limbs(tb, P, H, ring)
        for scheme in ("bfv", "bgv"):
            assert t_params.default_num_limbs(tb, H - 1, P, scheme, ring_dim=ring) == \
                j_params.default_num_limbs(tb, H - 1, P, scheme, ring_dim=ring)
    for L in (4, 6, 9):
        mul = t_params.bfv_mul_limbs(tb, L, 1, ring)
        assert mul == j_params.bfv_mul_limbs(tb, L, 1, ring)
        assert t_params.bfv_ship_limbs(tb, mul, ring) == j_params.bfv_ship_limbs(tb, mul, ring)
    sp_t = t_params.SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=6, scheme="bfv")
    sp_j = j_params.SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=6, scheme="bfv")
    assert sp_t.q_primes == sp_j.q_primes and sp_t.q == sp_j.q
    assert t_params.validate_wire_scheme_params(ring, t, 6, "bfv") == sp_t


def test_main_path_parameters():
    """The 2^20 x 2048 main-path geometry: L = 6, mul 5, ship 4."""
    L = t_params.bfv_batched_client_limbs(33, 12, 2, 16384)
    mul = t_params.bfv_mul_limbs(33, L, 1, 16384)
    assert (L, mul, t_params.bfv_ship_limbs(33, mul, 16384)) == (6, 5, 4)


@pytest.mark.parametrize("n", [64, 512])
def test_refmodel_ntt_and_slot_order_equal(n):
    p = t_primes.ntt_primes(1, 31, 2 * n)[0]
    psi = t_primes.primitive_root_of_unity(p, 2 * n)
    x = np.random.default_rng(n).integers(0, p, size=(3, n), dtype=np.uint64)
    np.testing.assert_array_equal(t_enc.ntt_numpy(x, p, psi), j_ref.ntt_numpy(x, p, psi))
    np.testing.assert_array_equal(t_enc.intt_numpy(x, p, psi), j_ref.intt_numpy(x, p, psi))
    np.testing.assert_array_equal(t_enc.slot_to_ntt_pos(n), j_galois.slot_to_ntt_pos(n))


@pytest.mark.parametrize("n", [16, 64, 1024])
def test_galois_tables_equal(n):
    """Every function of fhe/galois.py, the EvalSum ladder's elements among
    the automorphisms."""
    E_t, pos_t = t_galois.ntt_exponent_map(n)
    E_j, pos_j = j_galois.ntt_exponent_map(n)
    np.testing.assert_array_equal(E_t, E_j)
    assert pos_t == pos_j
    np.testing.assert_array_equal(t_galois.slot_exponents(n), j_galois.slot_exponents(n))
    np.testing.assert_array_equal(t_galois.slot_to_ntt_pos(n), j_galois.slot_to_ntt_pos(n))
    assert t_enc.slot_to_ntt_pos is t_galois.slot_to_ntt_pos
    assert t_galois.conjugation_galois_element(n) == j_galois.conjugation_galois_element(n)
    for r in (0, 1, 3, n // 4, n // 2 - 1, n):
        k = t_galois.rotation_galois_element(n, r)
        assert k == j_galois.rotation_galois_element(n, r)
        np.testing.assert_array_equal(t_galois.automorphism_ntt_perm(n, k),
                                      j_galois.automorphism_ntt_perm(n, k))
    k = 2 * n - 1
    np.testing.assert_array_equal(t_galois.automorphism_ntt_perm(n, k),
                                  j_galois.automorphism_ntt_perm(n, k))


@pytest.mark.parametrize("t", [T16, T32], ids=["t16", "t32"])
@pytest.mark.parametrize("n", [64, 256])
def test_encoder_equal(t, n):
    te, je = t_enc.PackedEncoder(n, t), j_enc.PackedEncoder(n, t)
    assert te.psi == je.psi
    rng = np.random.default_rng(n)
    vals = rng.integers(-(t // 2), t // 2, size=(3, n - 5))
    obj = vals.astype(object)
    obj[0, 0] = -(1 << 70)  # forces the object-array encode path
    qs = t_primes.ntt_primes(4, 31, 2 * n, (t,))
    for v in (vals, obj, [int(x) for x in vals[1]]):
        c_t, c_j = te.encode(v), je.encode(v)
        np.testing.assert_array_equal(np.asarray(c_t, dtype=object), np.asarray(c_j, dtype=object))
        np.testing.assert_array_equal(te.to_rns(c_t, qs), je.to_rns(c_j, qs))
        np.testing.assert_array_equal(
            np.asarray(te.decode(c_t, 7), dtype=object), np.asarray(je.decode(c_j, 7), dtype=object)
        )
