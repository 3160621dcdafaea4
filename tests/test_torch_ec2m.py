"""The port's binary-field (GF(2^m)) curves: the counterpart of
tests/test_ec2m.py, test for test, on ``crypto/ec2m.py``,
``utils/native_ec2m.py`` and the port's ElGamal protocol (the run on the
CPU: ``device="cpu"``). Group laws, serialization round trips, the ElGamal
gadget stack over K-163 and a SimpleElGamal run on a binary curve.
"""

import pytest

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.crypto.ec import EcGroup, ec_group
from nested_hashing_psi_tpu_torch.crypto.ec2m import BINARY_CURVES, BinaryEcGroup
from nested_hashing_psi_tpu_torch.crypto.elgamal import AddHomElGamal
from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process


def test_factory_dispatch():
    assert isinstance(ec_group("P-256"), EcGroup)
    assert isinstance(ec_group("K-163"), BinaryEcGroup)
    assert isinstance(ec_group("B-233"), BinaryEcGroup)
    with pytest.raises(ValueError):
        ec_group("X-999")


@pytest.mark.parametrize("name", list(BINARY_CURVES))
def test_generator_and_order(name):
    g = BinaryEcGroup(name)
    assert g.is_on_curve(g.g)
    # raw double-and-add (no order reduction): n*G must be infinity
    R = None
    for bit in bin(g.order)[2:]:
        R = g.add(R, R)
        if bit == "1":
            R = g.add(R, g.g)
    assert R is None
    # Hasse bound on the full group order h*n (FIPS 186-4 cofactors)
    h = 2 if (name[0] == "B" or name == "K-163") else 4
    assert abs(h * g.order - ((1 << g.m) + 1)) < (1 << (g.m // 2 + 2))


@pytest.mark.parametrize("name", ["K-163", "B-163", "B-233"])
def test_group_laws(name):
    import random

    rnd = random.Random(7)
    g = BinaryEcGroup(name)
    k1 = rnd.randrange(1, g.order)
    k2 = rnd.randrange(1, g.order)
    P, Q = g.mul_gen(k1), g.mul_gen(k2)
    assert g.mul_gen(k1) == g.mul(g.g, k1)
    assert g.add(P, Q) == g.add(Q, P) == g.mul_gen((k1 + k2) % g.order)
    assert g.add(P, g.neg(P)) is None
    assert g.add(g.add(P, Q), g.neg(Q)) == P
    assert g.multi_mul([g.g, P], [k2, 1]) == g.add(Q, P)
    assert g.add(P, P) == g.mul(P, 2)


@pytest.mark.parametrize("name", ["K-163", "B-163", "K-233", "B-283"])
def test_point_serialization(name):
    import random

    rnd = random.Random(3)
    g = BinaryEcGroup(name)
    for _ in range(4):
        P = g.mul_gen(rnd.randrange(1, g.order))
        data = g.to_bytes(P)
        assert len(data) == g.nbytes + 1
        assert g.from_bytes(data) == P
    assert g.from_bytes(g.to_bytes(None)) is None
    P = g.mul_gen(12345)
    assert g.from_bytes(g.to_bytes(g.neg(P))) == g.neg(P)


def test_elgamal_gadgets_binary_curve():
    eg = AddHomElGamal(ec_group("K-163"))
    eg.keygen()
    a, b = eg.encrypt(17), eg.encrypt(25)
    assert eg.decrypts_to_zero(eg.add(eg.add(a, b), eg.encrypt(-42)))
    assert eg.decrypts_to_zero(eg.add(eg.mult_by_const(a, 3), eg.encrypt(-51)))
    idx = [eg.encrypt(0), eg.encrypt(1), eg.encrypt(0)]
    res = eg.indexed_randomized_equality(
        idx, [10, 55, 70], eg.encrypt(-55), eg.encrypt_zero()
    )
    assert eg.decrypts_to_zero(res)
    ct = eg.encrypt(777)
    rt = eg.ct_from_bytes(eg.ct_to_bytes(ct))
    assert eg.decrypts_to_zero(eg.add(rt, eg.encrypt(-777)))


def test_simple_elgamal_e2e_binary_curve():
    params = PSIParams(
        server_set_size=60,
        client_set_size=4,
        intersection_set_size=2,
        bit_size=16,
        curve_name="K-163",
    )
    ht = HashTableParams(
        each_simple_table_size=8,
        each_cuckoo_table_size=6,
        n_simple_hash_functions=2,
        n_cuckoo_hash_functions=2,
        max_items_per_position=3,
    )
    client, _, ok = run_in_process(params, ht, device="cpu")
    assert ok
    assert len(client.intersection_calculated) == 2


def test_native_binary_matches_python():
    """Native PCLMUL backend (nhpsi_ec2m.cpp) vs the pure-Python group law:
    identical affine results for every batch entry point."""
    import random

    import pytest

    from nested_hashing_psi_tpu_torch.utils import native_ec2m

    if native_ec2m.get_lib() is None:
        pytest.skip("native binary EC backend unavailable")

    for curve in ["B-163", "K-233", "B-283", "K-571"]:
        g = BinaryEcGroup(curve)
        assert g._native is not None, curve
        py = BinaryEcGroup(curve)
        py._native = None
        py._g_table = py._build_fixed_base_table(py.g)

        rng = random.Random(99)
        ks = [rng.randrange(0, g.order) for _ in range(5)] + [0, 1, g.order - 1]
        pts = [py.mul_gen(k + 3) for k in range(4)]

        for k in ks:
            assert g.mul(g.g, k) == py.mul(py.g, k), (curve, k)
            assert g.mul_gen(k) == py.mul_gen(k), (curve, k)
        assert g.mul_many(pts[0], ks) == [py.mul(pts[0], k) for k in ks]
        assert g.mul_batch(pts, ks[:4]) == [
            py.mul(P, k) for P, k in zip(pts, ks[:4])
        ]
        assert g.mul_gen_batch(ks) == [py.mul_gen(k) for k in ks]
        flat_p = pts * 2
        flat_s = (ks[:4] + ks[:4])[: len(flat_p)]
        assert g.multi_mul_groups(flat_p, flat_s, 2, 4) == [
            py.multi_mul(flat_p[:4], flat_s[:4]),
            py.multi_mul(flat_p[4:], flat_s[4:]),
        ]
        assert g.sum_groups(flat_p, 2, 4) == py.sum_groups(flat_p, 2, 4)
