"""The port's four-step NTT (``ops.ntt4``) and distributed NTTs
(``parallel.dist_ntt``) against the JAX package, at tests/test_ntt4_dist.py's
sizes, bit-equal.

``ntt4``/``intt4`` at (n, m1) = (64, 8), (256, 16), (1024, 32) against the
JAX package's ``ntt4``/``intt4`` and the port's butterfly NTT; the
Ulysses-style ``dist_ntt_fns`` over 4 gloo CPU ranks at n = 256, and the
ring exchange ``dist_ntt_ring_fns`` over 4 ranks (ndim 2) and 8 ranks
(ndim 3), each against the JAX package's function on its virtual CPU
devices and the port's unsharded NTT, forward and inverse. The ring
exchange's bytes per rank and transform are pinned to
log2(D) * (n/D) * L * batch * 4.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from nested_hashing_psi_tpu.ops import ntt4 as j_ntt4
from nested_hashing_psi_tpu.parallel import dist_ntt as j_dist
from nested_hashing_psi_tpu_torch.ops import primes
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.ntt4 import FourStepPlan, intt4, ntt4
from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
from torch_parallel_cases import run_cases, summarize

torch.set_num_threads(1)

RANKS_TIMEOUT = 180.0


def _residues(seed: int, shape, ps) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, min(ps), size=shape,
                                                dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n,m1", [(64, 8), (256, 16), (1024, 32)])
def test_four_step_matches_jax_and_butterfly(n, m1):
    ps = primes.ntt_primes(2, 31, 2 * n)
    plan4 = FourStepPlan(n, ps, m1=m1)
    x = _residues(0, (3, len(ps), n), ps)
    xt = torch.from_numpy(x.view(np.int32))
    got = ntt4(xt, plan4)
    jplan = j_ntt4.FourStepPlan(n, ps, m1=m1)
    want = np.asarray(jax.jit(lambda a: j_ntt4.ntt4(a, jplan))(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(got, ntt(xt, NTTPlan(n, ps)))
    back = intt4(got, plan4)
    want_back = np.asarray(jax.jit(lambda a: j_ntt4.intt4(a, jplan))(jnp.asarray(want)))
    np.testing.assert_array_equal(back.numpy().view(np.uint32), want_back)
    assert torch.equal(back, xt)


@pytest.mark.parametrize("n,m1", [(64, 8), (1024, 32)])
def test_plan_matrices_match_jax(n, m1):
    """One source of the four-step matrices (ops.ntt_mxu._plain_matrices),
    in Montgomery form: M1, T, M2T and iM1 equal the JAX package's; 1/m2
    sits in iT here and in iM2T there."""
    ps = primes.ntt_primes(2, 31, 2 * n)
    t, j = FourStepPlan(n, ps, m1=m1), j_ntt4.FourStepPlan(n, ps, m1=m1)
    for name in ("M1", "T", "M2T", "iM1", "p_arr", "pinv_arr"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    m2_inv = np.array([pow(n // m1, -1, p) for p in ps], np.uint64).reshape(-1, 1, 1)
    pp = np.array(ps, np.uint64).reshape(-1, 1, 1)
    np.testing.assert_array_equal(t.iT, j.iT.astype(np.uint64) * m2_inv % pp)
    np.testing.assert_array_equal(t.iM2T.astype(np.uint64) * m2_inv % pp, j.iM2T)


DIST_CASES = {
    # name: (kind, ranks, n, number of primes, batch shape, m1)
    "four_step_4": ("dist_ntt", 4, 256, 2, (), 16),
    "ring_4_ndim2": ("ring_ntt", 4, 256, 3, (), 0),
    "ring_8_ndim3": ("ring_ntt", 8, 256, 3, (2,), 0),
}


def _dist_case(name):
    kind, D, n, n_primes, bshape, m1 = DIST_CASES[name]
    ps = primes.ntt_primes(n_primes, 31, 2 * n)
    x = _residues(7, bshape + (n_primes, n), ps)
    if kind == "dist_ntt":
        x = x.reshape(bshape + (n_primes, m1, n // m1))
    return dict(name=name, kind=kind, params=(n, tuple(ps), m1), inputs={"x": x}), ps


def _jax_dist(name, x, ps):
    kind, D, n, _, bshape, m1 = DIST_CASES[name]
    mesh = JMesh(np.array(jax.devices()[:D]).reshape(D), ("sp",))
    if kind == "dist_ntt":
        fwd, inv = j_dist.dist_ntt_fns(j_ntt4.FourStepPlan(n, ps, m1=m1), mesh, "sp", ndim=3)
        out = fwd(jnp.asarray(x))
        return np.asarray(out), np.asarray(inv(out))
    from nested_hashing_psi_tpu.ops.ntt import NTTPlan as JNTTPlan

    ndim = x.ndim
    fwd, inv = j_dist.dist_ntt_ring_fns(JNTTPlan(n, ps), mesh, "sp", ndim=ndim)
    spec = P(*(None,) * (ndim - 1), "sp")
    out = fwd(jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec)))
    return np.asarray(out), np.asarray(inv(out))


@pytest.fixture(scope="module")
def dist_runs():
    """Both spawns of gloo CPU ranks (4 and 8) in flight while the JAX side
    computes."""
    built = {name: _dist_case(name) for name in DIST_CASES}
    by_world = {}
    for name, (_, D, *_rest) in DIST_CASES.items():
        by_world.setdefault(D, []).append(built[name][0])
    with ThreadPoolExecutor(len(by_world)) as pool:
        futs = {D: pool.submit(run_ranks, run_cases, D, "gloo", (cases, "cpu"), RANKS_TIMEOUT)
                for D, cases in by_world.items()}
        want = {name: _jax_dist(name, case["inputs"]["x"], ps)
                for name, (case, ps) in built.items()}
        got = {s["name"]: s for f in futs.values() for s in summarize(f.result())}
    return built, want, got


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_distributed_ntt_bit_equal_three_ways(dist_runs, name):
    built, want, got = dist_runs
    case, ps = built[name]
    kind, D, n, n_primes, bshape, m1 = DIST_CASES[name]
    x = case["inputs"]["x"]
    fwd, inv = got[name]["results"]
    flat = torch.from_numpy(x.reshape(bshape + (n_primes, n)).view(np.int32))
    unsharded = ntt(flat, NTTPlan(n, ps)).numpy().view(np.uint32)
    np.testing.assert_array_equal(fwd.reshape(unsharded.shape), unsharded)
    np.testing.assert_array_equal(want[name][0].reshape(unsharded.shape), unsharded)
    np.testing.assert_array_equal(inv, x)
    np.testing.assert_array_equal(want[name][1], x)
    assert torch.equal(intt(torch.from_numpy(unsharded.view(np.int32)), NTTPlan(n, ps)), flat)
    assert got[name]["transport"] == "gloo"


@pytest.mark.parametrize("name", ["ring_4_ndim2", "ring_8_ndim3"])
def test_ring_exchange_sends_the_pinned_bytes(dist_runs, name):
    """log2(D) block swaps of (n/D) * L * batch residues per rank and
    transform, forward and inverse alike."""
    _, D, n, n_primes, bshape, _ = DIST_CASES[name]
    want = (D.bit_length() - 1) * (n // D) * n_primes * int(np.prod(bshape)) * 4
    for stage in (0, 1):
        assert [c[stage]["bytes_sent"] for c in dist_runs[2][name]["counts"]] == [want] * D


def test_four_step_all_to_all_bytes(dist_runs):
    """One all-to-all per transform: a rank keeps 1/D of its block."""
    _, D, n, n_primes, _, _ = DIST_CASES["four_step_4"]
    want = (n // D) * n_primes * 4 * (D - 1) // D
    for stage in (0, 1):
        assert [c[stage]["bytes_sent"] for c in dist_runs[2]["four_step_4"]["counts"]] == \
            [want] * D
