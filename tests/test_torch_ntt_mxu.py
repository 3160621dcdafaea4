"""Port K3 (the int8-digit four-step NTT) against the JAX package, on the CPU.

The plan's tables are pinned equal to the JAX package's ``MxuNTTPlan``; the
plain PyTorch version is held bit-exact against ``ntt_mxu``/``intt_mxu``,
against the Pallas kernel ``ntt_mxu_pallas``/``intt_mxu_pallas`` in
interpret mode, and against the port's canonical NTT (K1's contract).
Inputs come from a seeded numpy generator; comparisons are exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.ops import ntt_mxu as jmxu
from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.ops import ntt_mxu as tmxu
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

torch.set_num_threads(1)
TABLES = ("G1", "G2", "iG1", "iG2", "tw", "itw", "rc", "p_arr", "pinv_arr")


def _data(n, ps, batch, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([[rng.integers(0, p, n) for p in ps] for _ in range(batch)]).astype(np.uint32)


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_plan_tables_equal_jax(n):
    ps = ntt_primes(2, 31, 2 * n)
    jp, tp = jmxu.MxuNTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    assert (tp.m1, tp.m2) == (jp.m1, jp.m2)
    for name in TABLES:
        want, got = getattr(jp, name), getattr(tp, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _undo_device_stream(stream, left, m1, m2):
    """Invert ``_device_stream`` by its byte formula: chunk by chunk (per
    pass, digit matrix, k-step), a rows x 32 slice whose byte (r, kk)
    sits at (r/8)*256 + (kk/16)*128 + (r%8)*16 + kk%16. Checks that every
    byte is placed once and every padding byte is zero."""
    passes, ksteps, rows = tmxu.stage_geometry(left, m1, m2)
    R, C = (m1, 5 * m1) if left else (m2, 5 * m2)  # G rows (left) or G^T rows
    L = stream.shape[0]
    out = np.zeros((L, 5, R, C), np.int8)
    hits = np.zeros(stream.shape[1], np.int64)
    r, kk = np.arange(rows)[:, None], np.arange(32)[None, :]
    tile = (r // 8) * 256 + (kk // 16) * 128 + (r % 8) * 16 + kk % 16
    off = 0
    for ps in range(passes if left else 1):
        for i in range(5):
            for ks in range(ksteps):
                rr, cc = np.broadcast_arrays(ps * rows + r, ks * 32 + kk)
                idx, ok = off + tile, (rr < R) & (cc < C)
                out[:, i, rr[ok], cc[ok]] = stream[:, idx[ok]]
                assert not stream[:, idx[~ok]].any()
                np.add.at(hits, idx.ravel(), 1)
                off += rows * 32
    assert off == stream.shape[1] and (hits == 1).all()
    return out if left else out.swapaxes(-1, -2)


@pytest.mark.parametrize("n", [1 << k for k in range(8, 16)])
def test_device_layout_undoes_to_jax_tables(n):
    """The kernel's device copies of G1/G2/iG1/iG2 (K-major core-matrix
    chunks, G2/iG2 transposed, zero padding) give back the JAX tables."""
    ps = ntt_primes(1, 31, 2 * n)
    jp, tp = jmxu.MxuNTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    for name, left in (("G1", True), ("G2", False), ("iG1", True), ("iG2", False)):
        dev = tmxu._device_stream(getattr(tp, name), left, tp.m1, tp.m2)
        np.testing.assert_array_equal(_undo_device_stream(dev, left, tp.m1, tp.m2),
                                      getattr(jp, name), err_msg=name)


def test_host_helpers_equal_jax():
    n, m1 = 512, 32
    p = ntt_primes(1, 31, 2 * n)[0]
    mats_j, mats_t = jmxu._plain_matrices(n, m1, p), tmxu._plain_matrices(n, m1, p)
    for want, got in zip(mats_j, mats_t):
        np.testing.assert_array_equal(got, want)
    for M in (mats_t[0], mats_t[2]):
        np.testing.assert_array_equal(tmxu._digit_stack_left(M, p), jmxu._digit_stack_left(M, p))
        np.testing.assert_array_equal(tmxu._digit_stack_right(M, p), jmxu._digit_stack_right(M, p))


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_matches_jax_ntt_mxu(n):
    ps = ntt_primes(2, 31, 2 * n)
    jp, tp = jmxu.MxuNTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    x = _data(n, ps, 3)
    got = tmxu.ntt_mxu_plain(from_numpy(x, "cpu"), tp)
    want = np.asarray(jmxu.ntt_mxu(jnp.asarray(x), jp))
    np.testing.assert_array_equal(to_numpy(got), want)
    back = tmxu.intt_mxu_plain(got, tp)
    np.testing.assert_array_equal(to_numpy(back), np.asarray(jmxu.intt_mxu(jnp.asarray(want), jp)))
    np.testing.assert_array_equal(to_numpy(back), x)


def test_plain_matches_pallas_interpret():
    n = 512  # odd log2: m1 = 2 * m2
    ps = ntt_primes(2, 31, 2 * n)
    jp, tp = jmxu.MxuNTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    assert tp.m1 == 2 * tp.m2
    x = _data(n, ps, 3)  # 3 % tile_b != 0 exercises the kernel's padding
    want = np.asarray(jmxu.ntt_mxu_pallas(jnp.asarray(x), jp, tile_b=2, interpret=True))
    got = tmxu.ntt_mxu_plain(from_numpy(x, "cpu"), tp)
    np.testing.assert_array_equal(to_numpy(got), want)
    back = np.asarray(jmxu.intt_mxu_pallas(jnp.asarray(want), jp, tile_b=2, interpret=True))
    np.testing.assert_array_equal(to_numpy(tmxu.intt_mxu_plain(got, tp)), back)


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_plain_equals_port_ntt(n):
    """K3's contract is K1's: the canonical bit-reversed NTT and its inverse."""
    ps = ntt_primes(3, 31, 2 * n)
    plan, tp = NTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    x = from_numpy(_data(n, ps, 2, seed=n), "cpu").reshape(2, 1, 3, n)
    y = ntt(x, plan)
    assert torch.equal(tmxu.ntt_mxu_plain(x, tp), y)
    assert torch.equal(tmxu.intt_mxu_plain(y, tp), intt(y, plan))
    assert torch.equal(tmxu.intt_mxu_plain(y, tp), x)


def test_wrapper_takes_plain_version_on_cpu():
    n = 256
    ps = ntt_primes(2, 31, 2 * n)
    tp = tmxu.MxuNTTPlan(n, ps)
    x = from_numpy(_data(n, ps, 2), "cpu")
    before = dict(tmxu.launches)
    y = tmxu.ntt_mxu(x, tp)
    assert torch.equal(y, tmxu.ntt_mxu_plain(x, tp))
    assert torch.equal(tmxu.intt_mxu(y, tp), x)
    assert tmxu.launches == before
    with pytest.raises(TypeError):
        tmxu.ntt_mxu(x.long(), tp)
    with pytest.raises(ValueError):
        tmxu.ntt_mxu(x[:, :1], tp)


def test_digit_products_exact_in_float64():
    """At the largest ring K3 takes (n = 32768, m1 = 256) and with every
    residue p - 1 (the widest digits), the float64 digit products stay exact
    (Q_i <= 5 * m * 127^2 < 2^25, far inside 2^53): the plain K3 equals the
    port's NTT."""
    n = 32768
    ps = ntt_primes(1, 31, 2 * n)
    plan, tp = NTTPlan(n, ps), tmxu.MxuNTTPlan(n, ps)
    assert tp.m1 == 256
    x = torch.full((1, n), ps[0] - 1, dtype=torch.int32)
    y = ntt(x, plan)
    assert torch.equal(tmxu.ntt_mxu_plain(x, tp), y)
    assert torch.equal(tmxu.intt_mxu_plain(y, tp), x)
