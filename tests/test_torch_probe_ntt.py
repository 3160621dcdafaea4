"""A2 and A3, the lazy-butterfly and NTT-anatomy probes: the port's plain
versions (which the wrappers take on a CPU tensor) against the JAX probes'
Pallas kernels (``benchmarks/bench_ntt_lazy_probe.py``,
``benchmarks/bench_ntt_anatomy.py``) in interpret mode on the CPU, with
their shape globals lowered to 2 limbs and 8 rows, bit for bit; and the
port's split-plan tables against the JAX package's ``SplitNTTPlan``."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nested_hashing_psi_tpu.ops.ntt_pallas import SplitNTTPlan as JSplitPlan
from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_anatomy as t_anat
from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_lazy_probe as t_lazy
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMBS, ROWS = 2, 8


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def j_probes():
    """The JAX probe scripts, imported from their files (benchmarks/ is not
    a package); each test lowers their globals with monkeypatch."""
    return {"lazy": _load("bench_ntt_lazy_probe"), "anatomy": _load("bench_ntt_anatomy")}


def _plans(n):
    ps = ntt_primes(LIMBS, 31, 2 * n)
    return ps, SplitNTTPlan(n, ps), JSplitPlan(n, ps)


def _inputs(n, ps, seed):
    x = np.random.default_rng(seed).integers(0, min(ps), size=(ROWS, LIMBS, n), dtype=np.uint64)
    return x.astype(np.uint32)


@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
def test_split_plan_tables_equal_jax(n):
    ps = ntt_primes(3, 31, 2 * n)
    t, j = SplitNTTPlan(n, ps), JSplitPlan(n, ps)
    assert (t.m1, t.m2, t.log1, t.log2) == (j.m1, j.m2, j.log1, j.log2)
    for name in ("s1", "s2", "tw", "s1_v2", "s2_v2", "p_arr"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    # from n = 2^12 up the v2 tables differ from the plain ones
    assert (t.s1_v2 != t.s1).any() == (n >= 1 << 12)


def _jax_run(j_probes, monkeypatch, probe, jplan, which, x):
    mod = j_probes[probe]
    monkeypatch.setattr(mod, "N", x.shape[-1])
    monkeypatch.setattr(mod, "LIMBS", x.shape[1])
    with pltpu.force_tpu_interpret_mode():
        return np.array(mod.make_variant(jplan, which)(jnp.asarray(x)))


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("which", t_lazy.VARIANTS)
def test_lazy_probe_plain_matches_pallas_interpret(j_probes, monkeypatch, which, n):
    ps, tplan, jplan = _plans(n)
    x = _inputs(n, ps, seed=n + 1)
    want = _jax_run(j_probes, monkeypatch, "lazy", jplan, which, x)
    got = t_lazy.lazy_probe(torch.from_numpy(x.view(np.int32)), tplan, which)
    assert got.dtype == torch.int32 and tuple(got.shape) == x.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("which", t_anat.VARIANTS)
def test_anatomy_probe_plain_matches_pallas_interpret(j_probes, monkeypatch, which, n):
    ps, tplan, jplan = _plans(n)
    x = _inputs(n, ps, seed=n + 2)
    want = _jax_run(j_probes, monkeypatch, "anatomy", jplan, which, x)
    got = t_anat.anatomy_probe(torch.from_numpy(x.view(np.int32)), tplan, which)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_lazy_forms_and_moves_identities():
    """lazy_ps is lazy (the pre-split mulhi is exact); lazy's outputs leave
    [0, p) (they wrap, as the JAX probe says); moves is one Shoup product."""
    n = 1 << 12
    ps, plan, _ = _plans(n)
    x = torch.from_numpy(_inputs(n, ps, seed=5).view(np.int32))
    lazy = t_lazy.lazy_probe_plain(x, plan, "lazy")
    assert torch.equal(lazy, t_lazy.lazy_probe_plain(x, plan, "lazy_ps"))
    p = torch.tensor(ps, dtype=torch.int64).reshape(1, -1, 1)
    assert ((lazy.long() & 0xFFFFFFFF) >= p).any()
    exact = t_lazy.lazy_probe_plain(x, plan, "exact")
    assert ((exact.long() >= 0) & (exact.long() < p)).all()
    tw = plan.tw.astype(np.int64).reshape(LIMBS, 2, n)
    want = (x.long().numpy() * tw[None, :, 0] % np.array(ps).reshape(1, -1, 1))
    assert np.array_equal(t_anat.anatomy_probe_plain(x, plan, "moves").long().numpy(), want)


def test_wrappers_reject_bad_input():
    n = 1 << 10
    ps, plan, _ = _plans(n)
    x = torch.zeros((ROWS, LIMBS, n), dtype=torch.int32)
    with pytest.raises(TypeError):
        t_lazy.lazy_probe(x.long(), plan, "exact")
    with pytest.raises(ValueError):
        t_lazy.lazy_probe(x[:, :1], plan, "exact")
    with pytest.raises(ValueError, match="unknown form"):
        t_lazy.lazy_probe(x, plan, "harvey")
    with pytest.raises(ValueError, match="unknown variant"):
        t_anat.anatomy_probe(x, plan, "full")
    odd = SplitNTTPlan(1 << 11, ntt_primes(LIMBS, 31, 1 << 12))
    with pytest.raises(ValueError, match="m1 == m2"):
        t_anat.anatomy_probe(torch.zeros((2, LIMBS, 1 << 11), dtype=torch.int32), odd, "stages")
    before = (t_lazy.launches, t_anat.launches)
    t_lazy.lazy_probe(x, plan, "lazy")
    t_anat.anatomy_probe(x, plan, "moves")
    assert (t_lazy.launches, t_anat.launches) == before  # CPU: the plain versions


@pytest.mark.parametrize("module", [t_lazy, t_anat], ids=["lazy", "anatomy"])
def test_main_on_cpu_prints_rates(capsys, module):
    res = module.main(["--device", "cpu", "--n", "1024", "--limbs", "2", "--batch", "3",
                       "--iters", "1"])
    out = capsys.readouterr().out
    assert "limb-transforms/s" in out and "cpu: the plain PyTorch version" in out
    assert all(res[v]["max_abs_err"] == 0 for v in module.VARIANTS)
    assert res["k1_ms"] > 0 and res["k1_max_abs_err"] == 0


@pytest.mark.parametrize("module", [t_lazy, t_anat], ids=["lazy", "anatomy"])
def test_main_cuda_without_gpu_raises(module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda run is the card's (chip_smoke.py)")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        module.main([])
