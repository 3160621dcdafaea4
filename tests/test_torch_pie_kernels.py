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


# ---- the running sum (acc) and the position-major table ------------------

def _t64(c):
    return torch.from_numpy(c.astype(np.int64))


@pytest.mark.parametrize("shape", [(2, 3, 5, 2, 256), (1, 4, 3, 3, 128)])
def test_plain_with_acc_matches_jax_kernel_then_add_mod(shape):
    """indexed_inner_product_plain(acc=) is add_mod(acc, sum): equal to the
    plain sum followed by the port's add_mod, and to the JAX Pallas kernel
    (interpret mode) followed by the JAX add_mod."""
    from nested_hashing_psi_tpu.ops.modmath import add_mod as jax_add_mod
    from nested_hashing_psi_tpu_torch.ops.modmath import add_mod

    idx, pt, p, pinv = _case(*shape, seed=7 * sum(shape))
    H, D, P, L, N = shape
    rng = np.random.default_rng(sum(shape) + 1)
    acc = (rng.integers(0, 1 << 62, size=(H, D, 2, L, N), dtype=np.uint64)
           % p.astype(np.uint64)).astype(np.uint32)
    ti, tt, ta = from_numpy(idx, "cpu"), from_numpy(pt, "cpu"), from_numpy(acc, "cpu")
    got = pie_kernels.indexed_inner_product_plain(ti, tt, _t64(p), _t64(pinv), acc=ta)
    plain = pie_kernels.indexed_inner_product_plain(ti, tt, _t64(p), _t64(pinv))
    assert torch.equal(got, add_mod(ta, plain, _t64(p)))
    J = jnp.asarray
    want = jax_add_mod(jax_ip(J(idx), J(pt), J(p), J(pinv), tile_n=128, interpret=True),
                       J(acc), J(p))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("p0, w", [(0, 6), (0, 2), (2, 3), (5, 1)])
def test_plain_position_major_equals_standard_layout(p0, w):
    """The (P, H, D, L, N) position-major table, passed as its
    (H, D, P, L, N) view, gives the (H, D, P, L, N) table's result over
    positions [p0, p0 + w)."""
    idx, pt, p, pinv = _case(2, 3, 6, 2, 128, seed=20 + p0 + 10 * w)
    ti = from_numpy(idx[:, p0 : p0 + w], "cpu")
    pm = from_numpy(np.ascontiguousarray(pt.transpose(2, 0, 1, 3, 4)), "cpu")
    got = pie_kernels.indexed_inner_product_plain(ti, pm.permute(1, 2, 0, 3, 4), _t64(p),
                                                  _t64(pinv), p0=p0)
    want = pie_kernels.indexed_inner_product_plain(ti, from_numpy(pt, "cpu"), _t64(p),
                                                   _t64(pinv), p0=p0)
    assert torch.equal(got, want)


def test_wrapper_acc_and_position_major_on_cpu():
    """On CPU tensors the wrapper takes the plain version with a running
    sum over the position-major table's (H, D, P, L, N) view, writes the
    sum over acc, and counts no launch."""
    idx, pt, p, pinv = _case(2, 3, 6, 2, 64, seed=31)
    ti = from_numpy(idx[:, 2:5], "cpu")
    pm = from_numpy(np.ascontiguousarray(pt.transpose(2, 0, 1, 3, 4)), "cpu")
    pm = pm.permute(1, 2, 0, 3, 4)
    acc = pie_kernels.indexed_inner_product(
        from_numpy(idx[:, :2], "cpu"), from_numpy(pt, "cpu"), _u32(p), _u32(pinv), p0=0)
    before, first = pie_kernels.launches, acc.clone()
    got = pie_kernels.indexed_inner_product(ti, pm, _u32(p), _u32(pinv), p0=2, acc=acc)
    assert got is acc and pie_kernels.launches == before
    want = pie_kernels.indexed_inner_product_plain(
        ti, from_numpy(pt, "cpu"), _t64(p), _t64(pinv), p0=2, acc=first)
    assert torch.equal(acc, want)
    with pytest.raises(ValueError):
        pie_kernels.indexed_inner_product(ti, pm, _u32(p), _u32(pinv), p0=2, acc=acc[:1])


# ---- a numpy mirror of the kernel's integer steps (csrc/pie_ip.cu) -------

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


def _redc(x, q, qinv):
    """redc(): x * 2^-32 mod q for uint64 x < q 2^32."""
    lo = x & M32
    m = (lo * qinv) & M32
    t = (x >> S32) + ((m * q) >> S32) + (lo != 0).astype(np.uint64)
    return np.where(t >= q, t - q, t)


def _kernel_mirror(idx, pt, p, pinv):
    """The kernel's steps in uint64 lanes: exact products summed four at a
    time in 64 bits (checked: no group wraps), each group added with carries
    into the 96-bit sum (w0, w1, w2), then reduce(): u = redc(w2:w1),
    redc(u * (2^64 mod q) + w0)."""
    H, P, _, L, N = idx.shape
    D = pt.shape[1]
    q = p.astype(np.uint64).reshape(1, 1, 1, L, 1)
    qinv = pinv.astype(np.uint64).reshape(1, 1, 1, L, 1)
    r2 = np.array([pow(2, 64, int(v)) for v in p[:, 0]], np.uint64).reshape(1, 1, 1, L, 1)
    a = idx.astype(np.uint64)[:, None]            # (H, 1, P, 2, L, N)
    b = pt.astype(np.uint64)[:, :, :, None]       # (H, D, P, 1, L, N)
    w0 = np.zeros((H, D, 2, L, N), np.uint64)
    w1, w2 = w0.copy(), w0.copy()
    for g0 in range(0, P, 4):
        g = np.zeros_like(w0)
        for pos in range(g0, min(g0 + 4, P)):
            prod = a[:, :, pos] * b[:, :, pos]    # < 2^62: exact
            nxt = g + prod
            assert (nxt >= g).all(), "a group of four products wrapped 64 bits"
            g = nxt
        s0 = w0 + (g & M32)
        s1 = w1 + (g >> S32) + (s0 >> S32)
        w0, w1, w2 = s0 & M32, s1 & M32, w2 + (s1 >> S32)
    u = _redc((w2 << S32) | w1, q, qinv)
    return _redc(u * r2 + w0, q, qinv).astype(np.uint32)


@pytest.mark.parametrize("L", [6, 9])
@pytest.mark.parametrize("P", [1, 12, 40])
@pytest.mark.parametrize("fill", ["max", "random"])
def test_kernel_reduction_mirror_is_bit_exact(L, P, fill):
    """The deferred reduction is exact: every residue at q - 1 (the largest
    sums, P = 40 past 2^64) and random residues, at the L = 6 and L = 9
    primes, give the plain version's bits."""
    N, H, D = 64, 1, 2
    ps = ntt_primes(L, 31, 2 * 16384)
    p = np.array(ps, np.uint32).reshape(L, 1)
    pinv = np.array([mont_constants(v)[0] for v in ps], np.uint32).reshape(L, 1)
    if fill == "max":
        idx = np.broadcast_to(p - 1, (H, P, 2, L, N)).astype(np.uint32)
        pt = np.broadcast_to(p - 1, (H, D, P, L, N)).astype(np.uint32)
    else:
        rng = np.random.default_rng(P * 100 + L)
        pp = p.astype(np.uint64)
        idx = (rng.integers(0, 1 << 62, size=(H, P, 2, L, N), dtype=np.uint64) % pp).astype(np.uint32)
        pt = (rng.integers(0, 1 << 62, size=(H, D, P, L, N), dtype=np.uint64) % pp).astype(np.uint32)
    got = _kernel_mirror(idx, pt, p, pinv)
    want = pie_kernels.indexed_inner_product_plain(
        from_numpy(idx, "cpu"), from_numpy(pt, "cpu"), _t64(p), _t64(pinv))
    np.testing.assert_array_equal(got, to_numpy(want))
