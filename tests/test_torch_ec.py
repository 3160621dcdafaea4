"""The port's EC groups (crypto/ec.py, crypto/ec2m.py, utils/native_ec*.py)
against themselves and the JAX package, on P-192, P-256, K-163 and B-233.

- the port's native group law against its pure-Python law, every batch
  entry point, point for point;
- the generator's order, negation and the curve equation;
- SEC1-compressed serialization: round trips (batched and per point) and
  bytes equal to the JAX package's;
- the port's group law against the JAX package's pure-Python law, bit for
  bit on the same scalars. Every JAX group here takes its pure-Python law
  (``jax_pure_python_ec``), so no port test starts the JAX package's
  in-place native build;
- the port's EC libraries build into build/nhpsi_torch/ through a temporary
  file and a rename.
"""

import os
import random

import pytest

from nested_hashing_psi_tpu.crypto import ec as j_ec
from nested_hashing_psi_tpu.utils import native_ec as j_native_ec
from nested_hashing_psi_tpu.utils import native_ec2m as j_native_ec2m
from nested_hashing_psi_tpu_torch.crypto import ec as t_ec
from nested_hashing_psi_tpu_torch.utils import native, native_ec, native_ec2m

CURVES = ["P-192", "P-256", "K-163", "B-233"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def jax_pure_python_ec(monkeypatch):
    """JAX parties use the pure-Python group law (no in-place build)."""
    monkeypatch.setattr(j_native_ec, "for_curve", lambda *a, **k: None)
    monkeypatch.setattr(j_native_ec2m, "for_curve", lambda *a, **k: None)


def port_group(name: str, native_law: bool, monkeypatch):
    """The port's group for ``name``, with its native or pure-Python law."""
    if native_law:
        g = t_ec.ec_group(name)
        assert g._native is not None, "the port's native EC library did not build"
        return g
    with monkeypatch.context() as m:
        m.setattr(native_ec, "for_curve", lambda *a, **k: None)
        m.setattr(native_ec2m, "for_curve", lambda *a, **k: None)
        g = t_ec.ec_group(name)
    assert g._native is None
    return g


def _scalars(group, n: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(1, group.order) for _ in range(n)]


@pytest.mark.parametrize("name", CURVES)
def test_native_law_equals_pure_python(name, monkeypatch):
    nat, py = port_group(name, True, monkeypatch), port_group(name, False, monkeypatch)
    ks = _scalars(nat, 6, 1)
    pts = [py.mul_gen(k) for k in ks[:3]]
    assert [nat.mul_gen(k) for k in ks[:3]] == pts
    assert nat.mul_gen_batch(ks) == py.mul_gen_batch(ks)
    assert nat.mul(pts[0], ks[3]) == py.mul(pts[0], ks[3])
    assert nat.mul_batch(pts, ks[3:]) == py.mul_batch(pts, ks[3:])
    assert nat.mul_many(pts[1], ks[:4]) == py.mul_many(pts[1], ks[:4])
    # two groups of three pairs, one of them holding the identity
    grp_pts = pts + [None, pts[0], pts[2]]
    assert nat.multi_mul_groups(grp_pts, ks, 2, 3) == py.multi_mul_groups(grp_pts, ks, 2, 3)
    assert nat.multi_mul(pts, ks[:3]) == py.multi_mul(pts, ks[:3])
    sums = pts + [py.neg(pts[0]), pts[0], None]
    assert nat.sum_groups(sums, 2, 3) == py.sum_groups(sums, 2, 3)
    assert nat.add(pts[0], pts[1]) == py.add(pts[0], pts[1])


@pytest.mark.parametrize("name", CURVES)
def test_generator_order_and_curve(name, monkeypatch):
    for native_law in (True, False):
        g = port_group(name, native_law, monkeypatch)
        assert g.is_on_curve(g.g)
        assert g.mul(g.g, g.order) is None and g.mul_gen(g.order) is None
        assert g.mul_gen(g.order - 1) == g.neg(g.g)
        assert g.add(g.g, g.neg(g.g)) is None
        assert g.add(g.g, g.g) == g.mul_gen(2)
        p = g.mul_gen(_scalars(g, 1, 2)[0])
        assert g.is_on_curve(p) and g.add(p, None) == p


@pytest.mark.parametrize("name", CURVES)
def test_serialization_round_trip_and_bytes(name, monkeypatch):
    nat = port_group(name, True, monkeypatch)
    jg = j_ec.ec_group(name)
    assert jg._native is None
    pts = [nat.mul_gen(k) for k in _scalars(nat, 5, 3)] + [None]
    data = b"".join(nat.to_bytes(p) for p in pts)
    assert data == b"".join(jg.to_bytes(p) for p in pts)
    assert len(data) == len(pts) * (nat.nbytes + 1)
    assert [nat.from_bytes(nat.to_bytes(p)) for p in pts] == pts
    assert nat.points_from_bytes(data, len(pts)) == pts
    assert jg.points_from_bytes(data, len(pts)) == pts
    bad = bytearray(nat.to_bytes(pts[0]))
    bad[-1] ^= 1
    try:  # a flipped x either misses the curve or decodes to another point
        assert nat.from_bytes(bytes(bad)) != pts[0]
    except ValueError:
        pass


@pytest.mark.parametrize("name", CURVES)
def test_port_law_equals_jax_pure_python(name, monkeypatch):
    """The port's native law and the JAX package's pure-Python law give the
    same points on the same scalars."""
    t, j = port_group(name, True, monkeypatch), j_ec.ec_group(name)
    assert type(t).__name__ == type(j).__name__
    assert (t.order, t.g, t.nbytes) == (j.order, j.g, j.nbytes)
    ks = _scalars(t, 4, 4)
    pts = j.mul_gen_batch(ks[:2])
    assert t.mul_gen_batch(ks[:2]) == pts
    assert t.mul_batch(pts, ks[2:]) == j.mul_batch(pts, ks[2:])
    assert t.multi_mul_groups(pts + pts, ks, 2, 2) == j.multi_mul_groups(pts + pts, ks, 2, 2)
    assert t.sum_groups(pts + [t.g, None], 2, 2) == j.sum_groups(pts + [j.g, None], 2, 2)


def test_curve_tables_and_dispatch_equal_jax():
    from nested_hashing_psi_tpu.crypto import ec2m as j_ec2m
    from nested_hashing_psi_tpu_torch.crypto import ec2m as t_ec2m

    assert t_ec.CURVES == j_ec.CURVES
    assert t_ec2m.BINARY_CURVES == j_ec2m.BINARY_CURVES
    for name in ("P-224", "B-163", "K-233"):
        assert type(t_ec.ec_group(name)).__name__ == type(j_ec.ec_group(name)).__name__
    with pytest.raises(ValueError, match="unknown"):
        t_ec.ec_group("P-999")


def test_ec_libraries_build_into_build_dir_by_rename(tmp_path, monkeypatch):
    """The loaders target build/nhpsi_torch/, never native/build/; a build
    writes a temporary file and renames it over the target, whose name is
    keyed by the source and the host CPU, so a library built on another
    host is rebuilt, not loaded."""
    for mod, src in ((native_ec, "nhpsi_ec.cpp"), (native_ec2m, "nhpsi_ec2m.cpp")):
        assert mod._SO.startswith(os.path.join(REPO, "build", "nhpsi_torch") + os.sep)
        assert mod._SRC == os.path.join(REPO, "native", src)
        assert mod.get_lib() is not None
    calls = []
    real_run, real_replace = native.subprocess.run, native.os.replace
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: calls.append(("g++", cmd[-1])) or real_run(cmd, **kw))
    monkeypatch.setattr(native.os, "replace",
                        lambda a, b: calls.append(("rename", a, b)) or real_replace(a, b))
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int one() { return 1; }\n')
    so = str(tmp_path / "out" / "libone.so")
    target = native.built_path(str(src), so)
    assert os.path.dirname(target) == os.path.dirname(so) and target.endswith(".so")
    assert target != so
    lib = native.build_and_load(str(src), so)
    assert lib.one() == 1
    tmp = calls[0][1]
    assert calls == [("g++", tmp), ("rename", tmp, target)] and tmp != target
    assert sorted(os.listdir(tmp_path / "out")) == [os.path.basename(target)]
    native.build_and_load(str(src), so)  # up to date: no second build
    assert len(calls) == 2
    # another host's CPU (or another source) names another file: built anew
    monkeypatch.setattr(native, "_host_cpu", lambda: "another host")
    other = native.built_path(str(src), so)
    assert other != target
    assert native.build_and_load(str(src), so).one() == 1
    assert calls[2:] == [("g++", calls[2][1]), ("rename", calls[2][1], other)]
    src.write_text('extern "C" int one() { return 2; }\n')
    assert native.built_path(str(src), so) not in (target, other)
