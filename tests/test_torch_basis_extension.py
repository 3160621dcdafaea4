"""The port's ``BasisExtension`` against the JAX package and an exact CRT oracle.

The four cases of ``tests/test_basis.py`` (exact conversion, batched shapes,
the lazy variant's x + u*q bound, the q -> B -> q round trip), each on two
pairs of bases: ``test_basis.py``'s ``ntt_primes(4/5, 31, 128)`` and the
main path's q -> aux (the L = 6 context's mul_limbs primes at ring 16384 to
``BFVMulConverter``'s aux base, m_r included). The same seeded numpy
residues go through both packages; the JAX side runs under
``jax.enable_x64(True)``, where its overflow estimate is float64 as the
port's is, and the results must be bit-equal (tolerance 0). The oracle
is exact Python-integer CRT: the corrected conversion gives the centered
representative of x (x - q above q/2), the lazy one x + u*q.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu.ops import basis as j_basis
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
from nested_hashing_psi_tpu_torch.ops import basis as t_basis
from nested_hashing_psi_tpu_torch.ops.primes import crt_reconstruct, ntt_primes

torch.set_num_threads(1)

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
N = 64  # coefficients per limb: the conversion is elementwise along N


def _bases(name):
    if name == "ntt_primes_128":
        src = ntt_primes(4, 31, 2 * 64)
        return src, ntt_primes(5, 31, 2 * 64, avoid=src)
    q = ntt_primes(6, 31, 2 * 16384, avoid=(T32,))
    q = q[:bfv_mul_limbs(T32.bit_length(), 6, 1, ring_dim=16384)]
    return q, t_basis.BFVMulConverter(q, T32, 16384).aux_primes


BASES = ["ntt_primes_128", "main_q_to_aux"]


def _values(rng, q, shape):
    """Uniform integers in [0, q) with 0, 1 and q - 1 among them."""
    nbytes = (q.bit_length() + 71) // 8
    vals = np.array([int.from_bytes(rng.bytes(nbytes), "little") % q
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)
    vals.reshape(-1)[:3] = [0, 1, q - 1]
    return vals


def _centered(vals, q):
    return np.where(vals > q // 2, vals - q, vals)


def _residues(vals, primes):
    """(..., N) integers -> (..., L, N) uint32 residues."""
    return np.stack([(vals % p).astype(np.uint32) for p in primes], axis=-2)


def _both(src, dst, x, correction=True):
    with jax.enable_x64(True):
        want = np.asarray(j_basis.BasisExtension(src, dst).convert(jnp.asarray(x), correction))
    got = t_basis.BasisExtension(src, dst).convert(convert.from_numpy(x, "cpu"), correction)
    got = convert.to_numpy(got)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("bases", BASES)
def test_exact_conversion(bases):
    src, dst = _bases(bases)
    q = t_basis.BasisExtension(src, dst).q
    vals = _values(np.random.default_rng(0), q, (N,))
    out = _both(src, dst, _residues(vals, src))
    np.testing.assert_array_equal(out, _residues(_centered(vals, q), dst))


@pytest.mark.parametrize("bases", BASES)
def test_batched_shapes(bases):
    src, dst = _bases(bases)
    q = t_basis.BasisExtension(src, dst).q
    vals = _values(np.random.default_rng(1), q, (2, 3, N))
    out = _both(src, dst, _residues(vals, src))
    assert out.shape == (2, 3, len(dst), N)
    np.testing.assert_array_equal(out, _residues(_centered(vals, q), dst))


@pytest.mark.parametrize("bases", BASES)
def test_lazy_conversion_overflow_bound(bases):
    """correction=False returns x + u*q for 0 <= u < L (HPS lazy variant)."""
    src, dst = _bases(bases)
    q = t_basis.BasisExtension(src, dst).q
    vals = _values(np.random.default_rng(2), q, (N,))
    out = _both(src, dst, _residues(vals, src), correction=False)
    us = set()
    for j, v in enumerate(vals):
        got = crt_reconstruct([int(out[i, j]) for i in range(len(dst))], list(dst))
        u, rem = divmod(got - int(v), q)
        assert rem == 0 and 0 <= u < len(src), (v, got, u, rem)
        us.add(u)
    assert len(us) > 1  # the bound is exercised, not only u = 0


@pytest.mark.parametrize("bases", BASES)
def test_roundtrip_through_aux_basis(bases):
    """q -> B -> q returns the original residues (values < q are exact)."""
    src, dst = _bases(bases)
    q = t_basis.BasisExtension(src, dst).q
    x = _residues(_values(np.random.default_rng(3), q, (N,)), src)
    mid = _both(src, dst, x)
    np.testing.assert_array_equal(_both(dst, src, mid), x)


def test_extend_q_to_aux_is_the_basis_extension():
    """BFVMulConverter's q -> aux extension is BasisExtension over its bases,
    both variants."""
    q, aux = _bases("main_q_to_aux")
    mc = t_basis.BFVMulConverter(q, T32, 16384)
    x = convert.from_numpy(_residues(_values(np.random.default_rng(4), mc.q_to_aux.q, (3, N)),
                                     q), "cpu")
    be = t_basis.BasisExtension(q, aux)
    for correction in (True, False):
        assert torch.equal(mc.extend_q_to_aux(x, correction), be.convert(x, correction))


def test_bases_must_be_disjoint():
    src, dst = _bases("ntt_primes_128")
    with pytest.raises(ValueError):
        t_basis.BasisExtension(src, (dst[0], src[1]))
