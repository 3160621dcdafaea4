"""Port K2 (position sum) plain version against the JAX package, bit-exact:
``indexed_inner_product_plain`` vs the Pallas kernel in interpret mode and
vs ``indexed_inner_product_jnp``, on seeded random residues."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.ops.pie_kernels import (
    indexed_inner_product as jax_ip,
    indexed_inner_product_jnp,
)
from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.ops import pie_kernels
from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

torch.set_num_threads(1)


def _u32(c):
    """(L, 1) uint32 numpy constants -> the (L,) int32 bit views the wrapper takes."""
    return torch.from_numpy(np.ascontiguousarray(c[:, 0]).view(np.int32))


def _case(H, D, P, L, N, seed):
    ps = ntt_primes(L, 31, 2 * N)
    p = np.array(ps, np.uint32).reshape(L, 1)
    pinv = np.array([mont_constants(q)[0] for q in ps], np.uint32).reshape(L, 1)
    rng = np.random.default_rng(seed)
    pp = p.astype(np.uint64)
    idx = (rng.integers(0, 1 << 62, size=(H, P, 2, L, N), dtype=np.uint64) % pp).astype(np.uint32)
    pt = (rng.integers(0, 1 << 62, size=(H, D, P, L, N), dtype=np.uint64) % pp).astype(np.uint32)
    return idx, pt, p, pinv


@pytest.mark.parametrize(
    "shape", [(2, 3, 5, 2, 256), (1, 4, 3, 3, 128), (2, 2, 4, 1, 512)]
)
def test_plain_matches_pallas_interpret_and_jnp(shape):
    idx, pt, p, pinv = _case(*shape, seed=sum(shape))
    got = pie_kernels.indexed_inner_product_plain(
        from_numpy(idx, "cpu"), from_numpy(pt, "cpu"),
        torch.from_numpy(p.astype(np.int64)), torch.from_numpy(pinv.astype(np.int64)),
    )
    J = jnp.asarray
    want_kernel = np.asarray(jax_ip(J(idx), J(pt), J(p), J(pinv), tile_n=128, interpret=True))
    want_jnp = np.asarray(indexed_inner_product_jnp(J(idx), J(pt), J(p), J(pinv)))
    np.testing.assert_array_equal(want_kernel, want_jnp)
    assert tuple(got.shape) == want_jnp.shape
    np.testing.assert_array_equal(to_numpy(got), want_jnp)


@pytest.mark.parametrize("p0, w", [(0, 2), (2, 3), (3, 3), (5, 1)])
def test_slice_equals_sliced_tensors(p0, w):
    """K2 over positions [p0, p0 + w) of the full table equals K2 (and the
    JAX package's) on the sliced tensors."""
    idx, pt, p, pinv = _case(2, 3, 6, 2, 128, seed=p0 + 10 * w)
    tp, tpi = torch.from_numpy(p.astype(np.int64)), torch.from_numpy(pinv.astype(np.int64))
    ti = from_numpy(idx[:, p0 : p0 + w], "cpu")
    got = pie_kernels.indexed_inner_product(ti, from_numpy(pt, "cpu"), _u32(p), _u32(pinv), p0=p0)
    want = pie_kernels.indexed_inner_product_plain(
        ti, from_numpy(np.ascontiguousarray(pt[:, :, p0 : p0 + w]), "cpu"), tp, tpi
    )
    assert torch.equal(got, want)
    J = jnp.asarray
    want_jax = indexed_inner_product_jnp(J(idx[:, p0 : p0 + w]), J(pt[:, :, p0 : p0 + w]), J(p), J(pinv))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want_jax))


def test_slice_out_of_range_raises():
    idx, pt, p, pinv = _case(2, 3, 4, 2, 64, seed=3)
    with pytest.raises(ValueError):
        pie_kernels.indexed_inner_product(
            from_numpy(idx[:, :3], "cpu"), from_numpy(pt, "cpu"), _u32(p), _u32(pinv), p0=2
        )


def test_wrapper_takes_plain_version_on_cpu():
    idx, pt, p, pinv = _case(2, 2, 3, 2, 64, seed=9)
    ti, tt = from_numpy(idx, "cpu"), from_numpy(pt, "cpu")
    tp, tpi = torch.from_numpy(p.astype(np.int64)), torch.from_numpy(pinv.astype(np.int64))
    before = pie_kernels.launches
    got = pie_kernels.indexed_inner_product(ti, tt, _u32(p), _u32(pinv))
    assert pie_kernels.launches == before
    assert torch.equal(got, pie_kernels.indexed_inner_product_plain(ti, tt, tp, tpi))


def test_wrapper_rejects_mismatched_shapes():
    idx, pt, p, pinv = _case(2, 2, 3, 2, 64, seed=10)
    tp, tpi = torch.from_numpy(p.astype(np.int64)), torch.from_numpy(pinv.astype(np.int64))
    with pytest.raises(ValueError):
        pie_kernels.indexed_inner_product(
            from_numpy(idx, "cpu")[:, :2], from_numpy(pt, "cpu"), _u32(p), _u32(pinv)
        )
    with pytest.raises(TypeError):
        pie_kernels.indexed_inner_product(
            from_numpy(idx, "cpu").long(), from_numpy(pt, "cpu").long(), _u32(p), _u32(pinv)
        )
    with pytest.raises(TypeError):
        pie_kernels.indexed_inner_product(
            from_numpy(idx, "cpu"), from_numpy(pt, "cpu"), tp, tpi
        )
