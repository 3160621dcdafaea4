"""The port's native EC backend (``utils/native_ec.py`` over the repo's
``native/nhpsi_ec.cpp``, built into ``build/nhpsi_torch/``) against the
port's pure-Python group law: the counterpart of tests/test_native_ec.py,
test for test. Identical affine results for every batch entry point across
P-192/224/256 (4 limbs), P-384 (6) and P-521 (9); the edge cases; batched
SEC1 decompression, native for p = 3 mod 4 and Tonelli for P-224.
"""

import random

import pytest

from nested_hashing_psi_tpu_torch.crypto.ec import EcGroup
from nested_hashing_psi_tpu_torch.utils import native_ec


@pytest.fixture(autouse=True)
def _native_built():
    """The port builds its library through a temporary file and a rename
    (utils.native.build_and_load), so it is there wherever g++ is."""
    assert native_ec.get_lib() is not None


@pytest.mark.parametrize("curve", ["P-192", "P-224", "P-256", "P-384", "P-521"])
def test_native_matches_python(curve):
    g = EcGroup(curve)
    assert g._native is not None
    py = EcGroup(curve)
    py._native = None
    py._g_table = py._build_fixed_base_table(py.g)

    rng = random.Random(1234)
    scalars = [rng.randrange(0, g.order) for _ in range(6)] + [0, 1, g.order - 1]
    pts_py = [py.mul_gen(k + 7) for k in range(6)]

    # single mul + fixed-base
    for k in scalars:
        assert g.mul(g.g, k) == py.mul(py.g, k)
        assert g.mul_gen(k) == py.mul_gen(k)

    # shared-base batch
    assert g.mul_many(pts_py[0], scalars) == py.mul_many(pts_py[0], scalars)
    # pairwise batch
    ks = scalars[: len(pts_py)]
    assert g.mul_batch(pts_py, ks) == [py.mul(P, k) for P, k in zip(pts_py, ks)]
    # generator batch
    assert g.mul_gen_batch(scalars) == [py.mul_gen(k) for k in scalars]

    # multi-exponentiation (incl. zero scalars and infinity points)
    pts = pts_py + [None]
    ss = ks + [5]
    assert g.multi_mul(pts, ss) == py.multi_mul(pts, ss)
    assert g.multi_mul(pts_py[:3], [0, 0, 0]) is None

    # grouped multi-exp + grouped sums
    flat_p = pts_py * 2
    flat_s = (ks + ks)[: len(flat_p)]
    got = g.multi_mul_groups(flat_p, flat_s, 2, len(pts_py))
    want = [
        py.multi_mul(flat_p[i * len(pts_py) : (i + 1) * len(pts_py)],
                     flat_s[i * len(pts_py) : (i + 1) * len(pts_py)])
        for i in range(2)
    ]
    assert got == want
    got = g.sum_groups(flat_p, 2, len(pts_py))
    want = []
    for i in range(2):
        acc = None
        for pt in flat_p[i * len(pts_py) : (i + 1) * len(pts_py)]:
            acc = py.add(acc, pt)
        want.append(acc)
    assert got == want


def test_native_edge_cases():
    g = EcGroup("P-256")
    assert g.mul(None, 5) is None
    assert g.mul(g.g, 0) is None
    assert g.mul_many(None, [1, 2]) == [None, None]
    # k*G + (order-k)*G = infinity through the native multi-exp
    k = 123456789
    assert g.multi_mul([g.g, g.g], [k, g.order - k]) is None


def test_points_from_bytes_batch_roundtrip():
    """Batched SEC1 decompression (native when available): identical to the
    per-point path for P-256 (p = 3 mod 4, native) and P-224 (p = 1 mod 4,
    Python Tonelli fallback), including the infinity encoding."""
    from nested_hashing_psi_tpu_torch.crypto.ec import EcGroup

    for curve in ("P-256", "P-224"):
        g = EcGroup(curve)
        pts = [g.mul(g.g, 7 + 13 * i) for i in range(9)] + [None]
        data = b"".join(g.to_bytes(p) for p in pts)
        got = g.points_from_bytes(data, len(pts))
        assert got == pts, curve
        per_point = [
            g.from_bytes(data[i * (g.nbytes + 1) : (i + 1) * (g.nbytes + 1)])
            for i in range(len(pts))
        ]
        assert got == per_point, curve
