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
    assert set(res["mixes"]) == {"add", "mont", "fmul"}
    assert out.count("G applications/s") == 3 and "cpu: the plain PyTorch version" in out
    assert all(r["mismatches"] == 0 and r["max_abs_err"] == 0 for r in res["mixes"].values())


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


def test_bound_counts_the_busier_pipe():
    """A1's bound: each mix's busier 64-lane pipe, a wide or high product
    two FMA-pipe slots, an FP32 instruction half; a mix balanced over both
    pipes has half the bound of one on a single pipe."""
    from nested_hashing_psi_tpu_torch.benchmarks import common

    slots = {op: common.fma_pipe_slots(op) for op in
             ("IMAD.WIDE.U32", "IMAD.HI.U32", "IMAD", "IMAD.IADD", "IMUL", "FMUL", "FFMA.FTZ")}
    assert slots == {"IMAD.WIDE.U32": 2, "IMAD.HI.U32": 2, "IMAD": 1, "IMAD.IADD": 1,
                     "IMUL": 1, "FMUL": 0.5, "FFMA.FTZ": 0.5}
    body = [(0, "IMAD.HI.U32", ""), (16, "IMAD", ""), (32, "IADD3", ""), (48, "VIMNMX", ""),
            (64, "VIADD", ""), (80, "LDG.E", ""), (96, "BRA", "")]
    s = common.by_pipe(body, 2)
    assert (s["fma"], s["fma_slots"], s["alu"], s["arith"], s["memory"]) == (1.5, 2, 1, 2.5, 0.5)
    assert t_vpu.ops_per_app(s) == 2
    one_pipe = {"fma_slots": 0.0, "alu": 2.0}
    balanced = {"fma_slots": 1.0, "alu": 1.0}
    elems = 64 * 128 * 128
    t_one, by = t_vpu.bound_ms(elems, 1 << 15, one_pipe)
    assert by == "operations"
    assert t_one == 2 * t_vpu.bound_ms(elems, 1 << 15, balanced)[0]
    assert abs(t_one - elems * (1 << 15) * 2 / (64 * 132 * 1.98e9) * 1e3) < 1e-9
    # at K = 64 on the probe's shape a one-instruction mix is bound by bytes
    assert t_vpu.bound_ms(elems, 64, {"fma_slots": 0.0, "alu": 0.5})[1] == "bytes"


def test_run_on_cpu_returns_the_readings_and_no_device_share():
    """``run``'s keys: the time per call from the graph reading (the host
    clock on the CPU), the wrapper's pace, and the shares and summed bound,
    which need the kernel's SASS and so are None off the card."""
    res = t_vpu.run("cpu", shape=(1, 8, 128), mixes=("add", "fmul"), iters=1)
    for r in res["mixes"].values():
        assert r["ms"] > 0 and r["wrapper_ms"] > 0 and r["plain_ms"] > 0
        assert r["share"] is None and r["k_bound_ms"] is None and "rate_ms" not in r
    sm = res["summed"]
    assert sm["ms"] == sum(r["ms"] for r in res["mixes"].values())
    assert sm["wrapper_ms"] == sum(r["wrapper_ms"] for r in res["mixes"].values())
    assert (sm["bound_ms"], sm["bound_by"], sm["share"]) == (None, None, None)


# SASS per application of the 11 mixes on an H100 (FMA-pipe slots, ALU), as
# chip_smoke.py's [sass] line printed them for the one-wave kernel this
# design replaced (NVIDIA H100 80GB HBM3)
ONE_WAVE_SASS = {"add": (0.0, 0.53), "mul": (1.0, 0.03), "addmul": (1.0, 0.03),
                 "where_ge": (1.0, 1.03), "mulhi": (2.0, 0.03), "shoup": (3.0, 1.03),
                 "shoup_lazy": (3.0, 0.03), "mont": (6.8, 4.2), "addmod": (1.0, 1.03),
                 "fmul": (0.5, 0.03), "mul4_ilp": (3.11, 2.92)}


def test_summed_bound_is_the_sum_of_each_launchs_bound():
    """At (64, 128, 128), K = 64: a launch moves 8 MiB, 0.0025041 ms at
    3.35 TB/s, and one issue slot per application is 2^26 / (64 x 132 x
    1.98e9) s = 0.0040120 ms. add (0.53 ALU: 0.0021264) and fmul (0.5
    slot: 0.0020060) are bound by their bytes, the other nine by their
    busier pipe: 1 + 1 + 1.03 + 2 + 3 + 3 + 6.8 + 1.03 + 3.11 = 21.97
    slots, 0.0881436 ms, plus 2 x 0.0025041 = 0.0931518 ms. The larger of the
    summed terms, as chip_smoke.py took it before, is the summed slots
    (21.97 + 0.53 + 0.5 = 23.00 slots, 0.0922760 ms)."""
    sass = {m: {"fma_slots": f, "alu": a} for m, (f, a) in ONE_WAVE_SASS.items()}
    elems, slot, bytes_ms = 64 * 128 * 128, 0.0040120, 0.0025041
    assert abs(t_vpu.bound_ms(elems, 64, sass["mul"])[0] - slot) < 1e-7
    assert t_vpu.bound_ms(elems, 64, sass["add"]) == pytest.approx((bytes_ms, "bytes"), abs=1e-7)
    assert t_vpu.bound_ms(elems, 64, sass["fmul"])[1] == "bytes"
    total, by = t_vpu.summed_bound_ms(sass, elems, 64)
    assert by == "operations"
    assert total == pytest.approx(21.97 * slot + 2 * bytes_ms, rel=1e-4)
    assert total == pytest.approx(0.0931518, rel=1e-4)
    assert total > 23.00 * slot > 11 * bytes_ms  # above max(summed operations, summed bytes)
    # a set of launches that are all bound by their bytes is named so
    assert t_vpu.summed_bound_ms({"add": sass["add"], "fmul": sass["fmul"]}, elems, 64) == \
        pytest.approx((2 * bytes_ms, "bytes"), abs=1e-7)


def test_chain_loop_is_the_innermost_loop():
    """The redesigned kernel's SASS: a tile loop that holds the chain's pass
    loop and the shorter loop over the rest of K; the pass loop is read."""
    sass = [(0x00, "LDGSTS.E.BYPASS.128", ""), (0x10, "LDS.128", ""),  # tile loop from 0x10
            (0x20, "IMAD", ""), (0x30, "IMAD", ""), (0x40, "IMAD", ""),  # pass loop from 0x20
            (0x50, "IADD3", ""), (0x60, "BRA", "`(.L_x_2) 0x20"),
            (0x70, "IMAD", ""), (0x80, "BRA", "`(.L_x_3) 0x70"),  # rest loop
            (0x90, "STG.E.128", ""), (0xa0, "BRA", "`(.L_x_1) 0x10"),
            (0xb0, "EXIT", ""), (0xc0, "BRA", "`(.L_x_4) 0xc0")]
    assert [a for a, _, _ in t_vpu.chain_loop(sass)] == [0x20, 0x30, 0x40, 0x50]
    # the one-wave kernel's shape: pass and rest loops side by side
    flat = sass[2:5] + [(0x50, "BRA", "0x20"), (0x60, "IMAD", ""), (0x70, "BRA", "0x60")]
    assert [a for a, _, _ in t_vpu.chain_loop(flat)] == [0x20, 0x30, 0x40]


def test_tile_constants_are_the_kernels():
    """UNROLL, ELEMS and THREADS are csrc/probe_vpu_ops.cu's kUnroll, kElems
    and kThreads (the probes' block of probe_ntt.cuh)."""
    import re

    csrc = os.path.join(REPO, "nested_hashing_psi_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "probe_vpu_ops.cu")).read()
    ntt = open(os.path.join(csrc, "probe_ntt.cuh")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src + ntt)}
    assert "kThreads = nhpsi_probe::kThreads;" in src
    assert (const["kUnroll"], const["kElems"], const["kThreads"]) == \
        (t_vpu.UNROLL, t_vpu.ELEMS, t_vpu.THREADS)
    assert t_vpu.TILE == t_vpu.THREADS * t_vpu.ELEMS == 1024


def test_probe_sweep_a1_rows():
    """probe_sweep's A1 rows from two turns of one tree: medians over the
    turns, each launch's bound from the tree's SASS, the summed share per
    turn and of the medians (hand arithmetic as above)."""
    from nested_hashing_psi_tpu_torch.benchmarks import probe_sweep

    def turn(add_ms, mont_ms):
        return {"add": {"ms": add_ms, "rate_ms": 1.1, "sass": {"fma_slots": 0.0, "alu": 0.53}},
                "mont": {"ms": mont_ms, "rate_ms": 15.0, "sass": {"fma_slots": 6.8, "alu": 4.2}}}
    rows = probe_sweep.a1_rows([turn(0.004, 0.030), turn(0.006, 0.032)])
    bound = 0.0025041 + 6.8 * 0.0040120
    assert rows["summed_bound_ms"] == pytest.approx(bound, rel=1e-4)
    assert rows["summed_bound_by"] == "operations"
    assert rows["summed_ms_turns"] == pytest.approx([0.034, 0.038])
    assert rows["summed_share_turns"] == pytest.approx([bound / 0.034, bound / 0.038], rel=1e-4)
    add, mont = rows["mixes"]["add"], rows["mixes"]["mont"]
    assert (add["ms"], mont["ms"]) == pytest.approx((0.005, 0.031))
    assert rows["summed_ms"] == pytest.approx(0.036)
    assert rows["summed_share"] == pytest.approx(bound / 0.036, rel=1e-4)
    assert add["share"] == pytest.approx(0.0025041 / 0.005, rel=1e-4)
    assert mont["rate_share"] == pytest.approx(6.8 * 0.0040120 * 512 / 15.0, rel=1e-4)


def test_probe_sweep_tree_script_compiles():
    """The script each tree runs on the card (A1, A2, A3) is valid Python."""
    from nested_hashing_psi_tpu_torch.benchmarks import probe_sweep

    compile(probe_sweep.RUN, "probe_sweep.RUN", "exec")
    compile(probe_sweep.BUILD, "probe_sweep.BUILD", "exec")
