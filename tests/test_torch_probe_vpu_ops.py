"""A1, the uint32 op-rate probe: the port's plain version
(``benchmarks/bench_vpu_ops.py`` of nested_hashing_psi_tpu_torch, which
the wrapper takes on a CPU tensor) against the JAX probe's Pallas kernel
(``benchmarks/bench_vpu_ops.py``) in interpret mode on the CPU, with its
shape globals lowered to one (8, 8, 128) tile.

Every mix is bit-exact. ``fmul`` follows its stated rule: subnormal inputs
and results flush to signed zero (XLA computes it so), and NaNs compare as
one class (the payload is the platform's)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nested_hashing_psi_tpu_torch.benchmarks import bench_vpu_ops as t_vpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 8, 128)


@pytest.fixture(scope="module")
def j_vpu():
    """The JAX probe script, imported from its file (benchmarks/ is not a
    package); each test lowers its globals with monkeypatch."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_vpu_ops", os.path.join(REPO, "benchmarks", "bench_vpu_ops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax(j_vpu, monkeypatch, name, x_u32, k):
    monkeypatch.setattr(j_vpu, "B", x_u32.shape[0])
    monkeypatch.setattr(j_vpu, "M", x_u32.shape[1])
    monkeypatch.setattr(j_vpu, "N", x_u32.shape[2])
    monkeypatch.setattr(j_vpu, "TB", x_u32.shape[0])
    monkeypatch.setattr(j_vpu, "K", k)
    with pltpu.force_tpu_interpret_mode():
        return np.array(j_vpu.make(name)(jnp.asarray(x_u32)))


def _port(name, x_u32, k):
    return t_vpu.vpu_ops(torch.from_numpy(x_u32.view(np.int32)), name, k).numpy().view(np.uint32)


def _same_under_rule(got, want, name):
    if name != "fmul":
        return np.array_equal(got, want)
    both_nan = np.isnan(got.view(np.float32)) & np.isnan(want.view(np.float32))
    return bool(((got == want) | both_nan).all())


def test_mixes_are_the_jax_probes(j_vpu):
    assert t_vpu.MIXES == tuple(j_vpu.OPS)
    assert (t_vpu.SHAPE, t_vpu.K) == ((j_vpu.B, j_vpu.M, j_vpu.N), j_vpu.K)


@pytest.mark.parametrize("name", t_vpu.MIXES)
def test_plain_matches_pallas_interpret(j_vpu, monkeypatch, name):
    """64 chained applications over every 32-bit pattern range (the JAX
    probe's own inputs are below 2^31; after one application every mix
    spans the full range)."""
    x = np.random.default_rng(7).integers(0, 1 << 32, size=SHAPE, dtype=np.uint64)
    x = x.astype(np.uint32)
    want = _jax(j_vpu, monkeypatch, name, x, t_vpu.K)
    got = _port(name, x, t_vpu.K)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same_under_rule(got, want, name)
    assert t_vpu.same(torch.from_numpy(got.view(np.int32)),
                      torch.from_numpy(want.view(np.int32)), name) == 0


def _f32_bits(values):
    return np.array(values, np.float32).view(np.uint32)


def test_fmul_rule_on_edge_values(j_vpu, monkeypatch):
    """One application on chosen patterns: subnormal inputs, a product that
    underflows below the smallest normal, signed zeros, infinities times
    zero (NaN) and NaN inputs, against the Pallas kernel in interpret mode."""
    tiny = np.float32(1.5e-39)
    xs = _f32_bits([tiny, -tiny, 1e-20, -1e-20, 0.0, -0.0, np.inf, np.nan, 1.0, -3.5,
                    2.0**-126, 1e-30] * 86)[:1024]
    x = xs.reshape(1, 8, 128)
    want = _jax(j_vpu, monkeypatch, "fmul", x, 1)
    got = _port("fmul", x, 1)
    assert _same_under_rule(got, want, "fmul")
    # the rule itself: a subnormal input gives zero of the product's sign
    c = (x.astype(np.uint64) + t_vpu.C_OFFSET).astype(np.uint32)
    flat = got.reshape(-1).view(np.float32)
    sub_in = np.abs(x.reshape(-1).view(np.float32)) == tiny
    assert (flat[sub_in] == 0).all()
    assert (np.signbit(flat[sub_in]) == (np.signbit(x.reshape(-1).view(np.float32)[sub_in])
                                         ^ np.signbit(c.reshape(-1).view(np.float32)[sub_in]))).all()
    assert np.isnan(flat).any() and not (np.abs(flat[flat != 0]) < 2.0**-126).any()


def test_plain_at_large_k_stays_32_bit():
    """4096 applications of the wrapping mixes keep every value in 32 bits
    and agree with a numpy uint32 reference (numpy wraps natively)."""
    x = np.random.default_rng(3).integers(0, 1 << 32, size=(2, 4, 16), dtype=np.uint64)
    x = x.astype(np.uint32)
    c = x + np.uint32(t_vpu.C_OFFSET)
    v = x.copy()
    for _ in range(4096):
        v = v * c + c
    assert np.array_equal(_port("addmul", x, 4096), v)


def test_wrapper_rejects_bad_input():
    x = torch.zeros(SHAPE, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_vpu.vpu_ops(x.float(), "add")
    with pytest.raises(ValueError, match="unknown mix"):
        t_vpu.vpu_ops(x, "div")
    with pytest.raises(ValueError):
        t_vpu.vpu_ops(x, "add", -1)
    before = t_vpu.launches
    t_vpu.vpu_ops(x, "add")
    assert t_vpu.launches == before  # the CPU takes the plain version: no launch


def test_main_on_cpu_prints_rates(capsys):
    res = t_vpu.main(["--device", "cpu", "--shape", "2", "8", "128", "--mixes", "add", "mont",
                      "fmul", "--iters", "1"])
    out = capsys.readouterr().out
    assert set(res) == {"add", "mont", "fmul"}
    assert out.count("G applications/s") == 3 and "cpu: the plain PyTorch version" in out
    assert all(r["mismatches"] == 0 and r["max_abs_err"] == 0 for r in res.values())


def test_fold_floor_covers_every_mix():
    """chip_smoke.py's fold check reads one floor per mix; only ``add``,
    which one three-input IADD3 takes twice, sits below one instruction."""
    assert set(t_vpu.MIN_ARITH) == set(t_vpu.MIXES)
    assert {m for m, f in t_vpu.MIN_ARITH.items() if f < 1} == {"add"}


def test_main_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda run is the card's (chip_smoke.py)")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        t_vpu.main([])
