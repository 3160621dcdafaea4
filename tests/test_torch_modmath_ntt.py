"""Port modmath and NTT (plain PyTorch) against the JAX package, bit-exact.

Inputs are random residues from a seeded numpy generator, fed to both
packages; every comparison is exact equality (integer residues). The plain
NTT is held against ``ops.ntt.ntt``/``intt`` and against the Pallas kernel
``ntt_pallas``/``intt_pallas`` run in interpret mode on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.ops import modmath as jmm
from nested_hashing_psi_tpu.ops import ntt as jntt
from nested_hashing_psi_tpu.ops.ntt_pallas import SplitNTTPlan, intt_pallas, ntt_pallas
from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.ops import modmath as tmm
from nested_hashing_psi_tpu_torch.ops import ntt as tntt
from nested_hashing_psi_tpu_torch.ops import ntt_cuda
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

torch.set_num_threads(1)

PRIMES = ntt_primes(4, 31, 2 * 64)  # four 31-bit NTT primes
N = 4096


def _res(rng, p, size=N):
    return rng.integers(0, p, size=size, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize(
    "op", ["mont_mul", "shoup_mul", "add_mod", "sub_mod", "neg_mod",
           "cond_sub_mod", "to_mont", "modsum"]
)
def test_modmath_op_matches_jax(op, p):
    rng = np.random.default_rng(p % 1000)
    a, b = _res(rng, p), _res(rng, p)
    a[:3], b[:3] = [0, 1, p - 1], [p - 1, 0, p - 1]  # edges
    pinv, r2 = jmm.mont_constants(p)
    assert (pinv, r2) == tmm.mont_constants(p)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = from_numpy(a, "cpu"), from_numpy(b, "cpu")
    P, PI, R2 = np.uint32(p), np.uint32(pinv), np.uint32(r2)
    if op == "mont_mul":
        want, got = jmm.mont_mul(ja, jb, P, PI), tmm.mont_mul(ta, tb, p, pinv)
    elif op == "shoup_mul":
        # any x < 2**32 (a residue of another prime included), w < p
        x = rng.integers(0, 1 << 31, size=N, dtype=np.uint64).astype(np.uint32)
        w = int(b[7])
        wq = jmm.shoup_host(w, p)
        assert wq == tmm.shoup_host(w, p)
        want = jmm.shoup_mul(jnp.asarray(x), np.uint32(w), np.uint32(wq), P)
        got = tmm.shoup_mul(from_numpy(x, "cpu"), w, wq, p)
    elif op == "add_mod":
        want, got = jmm.add_mod(ja, jb, P), tmm.add_mod(ta, tb, p)
    elif op == "sub_mod":
        want, got = jmm.sub_mod(ja, jb, P), tmm.sub_mod(ta, tb, p)
    elif op == "neg_mod":
        want, got = jmm.neg_mod(ja, P), tmm.neg_mod(ta, p)
    elif op == "cond_sub_mod":
        x = rng.integers(0, 1 << 31, size=N, dtype=np.uint64).astype(np.uint32)
        want = jmm.cond_sub_mod(jnp.asarray(x), P)
        got = tmm.cond_sub_mod(from_numpy(x, "cpu"), p)
    elif op == "to_mont":
        want, got = jmm.to_mont(ja, P, PI, R2), tmm.to_mont(ta, p, pinv, r2)
    else:
        x = np.stack([_res(rng, p) for _ in range(7)])
        want = jmm.modsum(jnp.asarray(x), P, axis=0)
        got = tmm.modsum(from_numpy(x, "cpu"), p, axis=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _plans(n, L=3):
    ps = ntt_primes(L, 31, 2 * n)
    return jntt.NTTPlan(n, ps), tntt.NTTPlan(n, ps)


@pytest.mark.parametrize("n", [64, 256, 512])
def test_ntt_plan_tables_equal_jax(n):
    jp, tp = _plans(n)
    for name in ("psi_rev", "psi_inv_rev", "n_inv", "p_arr", "pinv_arr", "r2_arr"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    np.testing.assert_array_equal(tntt.bit_reverse_indices(n), jntt.bit_reverse_indices(n))


def _data(n, ps, lead, seed):
    rng = np.random.default_rng(seed)
    p = np.array(ps, np.uint64).reshape(len(ps), 1)
    return (rng.integers(0, 1 << 62, size=lead + (len(ps), n), dtype=np.uint64) % p).astype(np.uint32)


@pytest.mark.parametrize("n", [64, 256, 512])
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_plain_ntt_matches_jax(n, lead):
    jp, tp = _plans(n)
    x = _data(n, tp.primes, lead, seed=n + len(lead))
    want = np.asarray(jp.ntt_jit(jnp.asarray(x)))
    got = tntt.ntt(from_numpy(x, "cpu"), tp)
    np.testing.assert_array_equal(to_numpy(got), want)
    back = tntt.intt(got, tp)
    np.testing.assert_array_equal(to_numpy(back), np.asarray(jp.intt_jit(jnp.asarray(want))))
    np.testing.assert_array_equal(to_numpy(back), x)


@pytest.mark.parametrize("n", [64, 256, 512])
def test_plain_ntt_matches_pallas_interpret(n):
    """The TPU kernel K1 itself, in interpret mode, on a batch of rows."""
    _, tp = _plans(n)
    sp = SplitNTTPlan(n, tp.primes)
    x = _data(n, tp.primes, (2,), seed=n)
    got = tntt.ntt(from_numpy(x, "cpu"), tp)
    np.testing.assert_array_equal(
        to_numpy(got), np.asarray(ntt_pallas(jnp.asarray(x), sp, interpret=True))
    )
    np.testing.assert_array_equal(
        x, np.asarray(intt_pallas(jnp.asarray(to_numpy(got)), sp, interpret=True))
    )
    np.testing.assert_array_equal(to_numpy(tntt.intt(got, tp)), x)


def test_ntt_wrapper_takes_plain_version_on_cpu():
    """The K1 wrapper on a CPU tensor is the plain version and launches no
    kernel; it rejects what the kernel would not take."""
    _, tp = _plans(128, L=2)
    x = from_numpy(_data(128, tp.primes, (4,), seed=5), "cpu")
    before = dict(ntt_cuda.launches)
    assert torch.equal(ntt_cuda.ntt(x, tp), tntt.ntt(x, tp))
    assert torch.equal(ntt_cuda.intt(x, tp), tntt.intt(x, tp))
    assert ntt_cuda.launches == before
    with pytest.raises(TypeError):
        ntt_cuda.ntt(x.long(), tp)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x[..., :64], tp)


@pytest.mark.parametrize("n", [16, 512, 16384])
def test_kernel_tables_pinned_to_jax(n):
    """The CUDA kernel's tables, built in Python from the plan: twiddles as
    interleaved [value, quotient] pairs (L, n, 2) of the JAX NTTPlan's
    (L, 2, n) tables, and the inverse scale folded into the last stage,
    [n^-1, quotient, psi_inv_rev[1] n^-1, quotient], which scales as the
    JAX plan's last twiddle followed by its n^-1 does."""
    jp, tp = _plans(n)
    tb = tp.tensors("cpu")

    def u32(t):
        return t.numpy().view(np.uint32)

    np.testing.assert_array_equal(u32(tb["psi_pairs_u32"]), jp.psi_rev.transpose(0, 2, 1))
    np.testing.assert_array_equal(u32(tb["ipsi_pairs_u32"]), jp.psi_inv_rev.transpose(0, 2, 1))
    sc = u32(tb["iscale_u32"]).astype(object)
    rng = np.random.default_rng(n)
    for l, p in enumerate(tp.primes):
        ninv, w1 = int(jp.n_inv[l, 0, 0]), int(jp.psi_inv_rev[l, 0, 1])
        assert (sc[l, 0], sc[l, 1]) == (ninv, int(jp.n_inv[l, 1, 0]))
        assert sc[l, 2] == w1 * ninv % p and sc[l, 3] == (sc[l, 2] << 32) // p
        for d in rng.integers(0, p, size=8).tolist():
            assert d * sc[l, 2] % p == d * w1 % p * ninv % p
