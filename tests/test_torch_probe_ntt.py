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
from nested_hashing_psi_tpu_torch.benchmarks import bench_vpu_ops as t_vpu
from nested_hashing_psi_tpu_torch.benchmarks import common as t_common
from nested_hashing_psi_tpu_torch.benchmarks import u32
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
        pytest.skip("a GPU is present: the cuda run is the card's "
                    "(test_torch_kernels_gpu.py::test_probe_main_on_the_card)")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        module.main([])


# ---- the class structure the kernels' layout rests on, and the bounds ----

# S, the least pair distance of a half at tile side M: rows (and, in A2,
# columns) that differ modulo S never meet in a butterfly
CLASS_STRIDE = {32: 4, 64: 8, 128: 8}


def _class_mask(which, m, r, c):
    rows, cols = np.arange(m)[:, None], np.arange(m)[None, :]
    S = CLASS_STRIDE[m]
    if which == "moves":  # elementwise
        return (rows == r) & (cols == c)
    if which == "stages":  # its column's rows r mod S
        return (rows % S == r % S) & (cols == c)
    return (rows % S == r % S) & (cols % S == c % S)  # A2: the (M/S) x (M/S) subtile


@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
@pytest.mark.parametrize("which", [*t_lazy.VARIANTS, *t_anat.VARIANTS])
def test_one_input_changes_only_its_class(which, n):
    """Changing one input of the plain version changes no output outside
    its class, the independence that lets a kernel thread hold M / S
    residues instead of a column, and every output of it, but in A2 at
    M = 32: there some outputs of the subtile can stay unchanged (s2_v2
    holds twiddles of +-1, 62 of its 160 entries at n = 2^10, and A2's
    second half meets the pairs at distance 16 and 8 twice), 32 to 64 of
    its 64 for these inputs."""
    ps = ntt_primes(1, 31, 2 * n)
    plan = SplitNTTPlan(n, ps)
    m = plan.m1
    assert u32.class_stride(m) == CLASS_STRIDE[m]
    fn = t_lazy.lazy_probe_plain if which in t_lazy.VARIANTS else t_anat.anatomy_probe_plain
    rng = np.random.default_rng(n + len(which))
    x = rng.integers(0, ps[0], size=(1, 1, n), dtype=np.int64)
    base = fn(torch.from_numpy(x.astype(np.int32)), plan, which).reshape(m, m)
    for r, c in rng.integers(0, m, size=(3, 2)):
        x2 = x.copy()
        x2[0, 0, r * m + c] = (x2[0, 0, r * m + c] + rng.integers(1, ps[0])) % ps[0]
        changed = (fn(torch.from_numpy(x2.astype(np.int32)), plan, which).reshape(m, m)
                   != base).numpy()
        mask = _class_mask(which, m, r, c)
        assert changed[r, c] and not (changed & ~mask).any(), (r, c)
        if not (which in t_lazy.VARIANTS and m == 32):
            assert np.array_equal(changed, mask), (r, c)


@pytest.mark.parametrize("m, per_thread", [(32, 40), (64, 48), (128, 112)])
def test_butterflies_per_thread_follow_the_class(m, per_thread):
    """(log2 m1 + log2 m2) stages of M / (2 S) butterflies each."""
    plan = SplitNTTPlan(m * m, ntt_primes(1, 31, 2 * m * m))
    assert t_lazy.butterflies_per_thread(plan) == per_thread


def test_sass_per_butterfly_divides_the_slab_loop(monkeypatch):
    """A hand-made loop of 112 IMAD.HI, 224 IMAD and 448 IADD3 at M = 128
    (one thread's slab): 1, 2 and 4 per butterfly, 4 FMA-pipe slots."""
    body = ([(16 * i, "IMAD.HI.U32", "") for i in range(112)]
            + [(16 * (112 + i), "IMAD", "") for i in range(224)]
            + [(16 * (336 + i), "IADD3", "") for i in range(448)])
    instrs = [(0x0, "S2R", ""), *[(a + 0x100, op, r) for a, op, r in body]]
    instrs.append((0x100 + 16 * 784, "BRA", " 0x100"))
    monkeypatch.setattr(t_lazy.common, "find_function", lambda fragment: instrs)
    plan = SplitNTTPlan(1 << 14, ntt_primes(1, 31, 1 << 15))
    s = t_lazy.sass_per_butterfly(t_lazy.kernel_name(128, "exact"), plan)
    assert (s["fma"], s["fma_slots"], s["alu"], s["arith"]) == (3, 4, 4, 7)


ROWS_FULL, N_FULL = 512 * 6, 1 << 14
BUTTERFLIES = ROWS_FULL * (N_FULL // 2) * 14
BYTES_MS = ROWS_FULL * N_FULL * 8 / 3.35e12 * 1e3


@pytest.mark.parametrize("sass, ops_per_butterfly, by", [
    ({"fma_slots": 5.22, "alu": 4.01}, 5.22, "bytes"),      # the FMA pipe is the busier
    ({"fma_slots": 3.0, "alu": 6.0}, 6.0, "operations"),     # the ALU is the busier
    ({"fma_slots": 10.21, "alu": 10.03}, 10.21, "operations"),
], ids=["fma_busier_bytes_bound", "alu_busier", "presplit"])
def test_bound_counts_the_busier_pipe(sass, ops_per_butterfly, by):
    """Operations: n/2 log2 n butterflies per row at the busier 64-lane
    pipe's slots (bench_vpu_ops.PIPE_OPS_S); bytes: each row read and
    written once, the tables once."""
    t_ops = BUTTERFLIES * ops_per_butterfly / t_vpu.PIPE_OPS_S * 1e3
    assert t_lazy.pipe_ms(ROWS_FULL, N_FULL, sass) == pytest.approx(t_ops, rel=1e-12)
    ms, got_by = t_lazy.bound_ms(ROWS_FULL, N_FULL, sass, 28672)
    assert got_by == by
    t_bytes = BYTES_MS + 28672 / 3.35e12 * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    parts = t_lazy.bound_by_pipe(ROWS_FULL, N_FULL, sass, 28672)
    assert parts == {"fma_slots_per_butterfly": sass["fma_slots"], "alu_per_butterfly": sass["alu"],
                     "operations_ms": pytest.approx(t_ops), "bytes_ms": pytest.approx(t_bytes)}


def test_bound_without_butterflies_is_bytes():
    """A3's moves: no operations, its bytes and the twiddles'."""
    ms, by = t_lazy.bound_ms(ROWS_FULL, N_FULL, None, 1 << 20)
    assert by == "bytes" and ms == pytest.approx(BYTES_MS + (1 << 20) / 3.35e12 * 1e3)


def test_ptxas_instances_reads_registers_and_spills():
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1a15ntt_lazy_kernelILi128ELi0EEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a15ntt_lazy_kernelILi128ELi0EEEv",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN1a21anatomy_stages_kernelILi128EEEv' for 'sm_90a'",
        "ptxas info    : Used 43 registers, 400 bytes cmem[0]",
    ])
    got = t_common.ptxas_instances(report)
    assert t_common.instance(got, t_lazy.kernel_name(128, "exact")) == {
        "registers": 40, "spill_stores": 8, "spill_loads": 12}
    assert t_common.instance(got, t_anat.kernel_name(128, "stages")) == {
        "registers": 43, "spill_stores": 0, "spill_loads": 0}
    with pytest.raises(RuntimeError, match="0 kernels"):
        t_common.instance(got, t_anat.kernel_name(128, "moves"))
