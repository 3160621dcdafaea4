"""The port's last helpers against the JAX package, bit for bit.

``ops/modmath.py``'s ``mulhi_u32``, ``from_mont``, ``mul_mod`` and
``to_mont_host`` (held also against the port's vectorised table lifts in
``ops/ntt_mxu.py`` and ``ops/ntt4.py``); ``ops/refmodel.py`` (the schoolbook
negacyclic product against the port's plain NTT product at n = 64, and
every function against the JAX module); ``fhe/bgv.py``'s
``tensor_product_mont``; ``utils/native.py``'s ``cuckoo_insert_seq``.
Inputs are seeded numpy draws fed to both packages; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu.fhe import bgv as j_bgv
from nested_hashing_psi_tpu.hashing import TabulationHashing
from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu.ops import modmath as jmm
from nested_hashing_psi_tpu.ops import refmodel as j_ref
from nested_hashing_psi_tpu.utils import native as j_native
from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.fhe import bgv as t_bgv
from nested_hashing_psi_tpu_torch.ops import modmath as tmm
from nested_hashing_psi_tpu_torch.ops import ntt as tntt
from nested_hashing_psi_tpu_torch.ops import refmodel as t_ref
from nested_hashing_psi_tpu_torch.ops.ntt4 import FourStepPlan
from nested_hashing_psi_tpu_torch.ops.ntt_mxu import MxuNTTPlan, _plain_matrices
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.utils import native as t_native

torch.set_num_threads(1)

PRIMES = ntt_primes(3, 31, 2 * 64)
N = 2048


def _col(vals):
    return np.array(vals, np.uint32).reshape(len(vals), 1)


def _res(rng, shape, primes=PRIMES):
    p = np.array(primes, np.uint64).reshape(len(primes), 1)
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)


def _consts(primes=PRIMES):
    pinv, r2 = zip(*(tmm.mont_constants(p) for p in primes))
    return _col(primes), _col(pinv), _col(r2)


def test_mulhi_u32_full_range():
    """Any uint32 pair, the top bit set included: int32 tensors carry the
    JAX package's uint32 bits, int64 tensors the values."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    a[:4] = b[:4] = [0, 1, (1 << 31), (1 << 32) - 1]
    want = np.asarray(jmm.mulhi_u32(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a.view(np.int32).copy())
    tb = torch.from_numpy(b.view(np.int32).copy())
    for x, y in ((ta, tb), (ta.long() & tmm.MASK32, tb.long() & tmm.MASK32)):
        got = tmm.mulhi_u32(x, y)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert tmm.mulhi_u32((1 << 32) - 1, (1 << 32) - 1) == (1 << 32) - 2


@pytest.mark.parametrize("op", ["from_mont", "mul_mod"])
def test_mont_helpers_match_jax(op):
    rng = np.random.default_rng(2)
    a, b = _res(rng, (2, 3, N)), _res(rng, (2, 3, N))
    a[..., 0, :4] = [0, 1, PRIMES[0] - 1, 2]
    p, pinv, r2 = _consts()
    if op == "from_mont":
        want = jmm.from_mont(jnp.asarray(a), jnp.asarray(p), jnp.asarray(pinv))
        got = tmm.from_mont(from_numpy(a, "cpu"), torch.from_numpy(p.astype(np.int64)),
                            torch.from_numpy(pinv.astype(np.int64)))
        # a round trip through Montgomery form is the identity
        back = tmm.to_mont(got, *(torch.from_numpy(c.astype(np.int64)) for c in (p, pinv, r2)))
        np.testing.assert_array_equal(to_numpy(back), a)
    else:
        want = jmm.mul_mod(jnp.asarray(a), jnp.asarray(b), *(jnp.asarray(c) for c in (p, pinv, r2)))
        got = tmm.mul_mod(from_numpy(a, "cpu"), from_numpy(b, "cpu"),
                          *(torch.from_numpy(c.astype(np.int64)) for c in (p, pinv, r2)))
        exact = (a.astype(object) * b.astype(object)) % p.astype(object)
        np.testing.assert_array_equal(to_numpy(got), exact.astype(np.uint32))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_to_mont_host_matches_jax_and_the_table_lifts():
    """The scalar helper equals JAX's, and the port's vectorised lifts of the
    K3 and four-step tables (x * (2**32 mod p) mod p) equal it elementwise."""
    rng = np.random.default_rng(3)
    for p in PRIMES:
        for x in [0, 1, p - 1, *map(int, rng.integers(0, p, size=20))]:
            assert tmm.to_mont_host(x, p) == jmm.to_mont_host(x, p)
    n, m1 = 256, 16
    primes = ntt_primes(2, 31, 2 * n)
    mxu, four = MxuNTTPlan(n, primes), FourStepPlan(n, primes)
    lift = np.vectorize(lambda v, p: tmm.to_mont_host(int(v), p), otypes=[np.uint64])
    for l, p in enumerate(primes):
        M1, T, M2T, iM1, iT, iM2T = _plain_matrices(n, m1, p)
        np.testing.assert_array_equal(mxu.tw[l], lift(T, p))
        np.testing.assert_array_equal(mxu.itw[l], lift(iT, p))
        for got, plain in zip((four.M1, four.T, four.M2T, four.iM1, four.iT, four.iM2T),
                              (M1, T, M2T, iM1, iT, iM2T)):
            np.testing.assert_array_equal(got[l], lift(plain, p))


def test_refmodel_negacyclic_product_against_the_plain_ntt():
    """negacyclic_mul_naive == iNTT(NTT(a) * NTT(b)) through the port's plain
    NTT at n = 64, for every prime; and equal to the JAX oracle."""
    n = 64
    plan = tntt.NTTPlan(n, PRIMES)
    rng = np.random.default_rng(4)
    a, b = _res(rng, (len(PRIMES), n)), _res(rng, (len(PRIMES), n))
    fa, fb = tntt.ntt(from_numpy(a, "cpu"), plan), tntt.ntt(from_numpy(b, "cpu"), plan)
    prod = tntt.intt((fa.long() * fb.long() % torch.tensor(PRIMES).reshape(-1, 1)).int(), plan)
    for l, p in enumerate(PRIMES):
        want = t_ref.negacyclic_mul_naive(a[l], b[l], p)
        np.testing.assert_array_equal(want, j_ref.negacyclic_mul_naive(a[l], b[l], p))
        np.testing.assert_array_equal(to_numpy(prod[l]).astype(np.uint64), want)


@pytest.mark.parametrize("n", [16, 64, 1024])
def test_refmodel_ntts_and_psi_match_jax(n):
    p = ntt_primes(1, 31, 2 * n)[0]
    psi = t_ref.default_psi(p, n)
    assert psi == j_ref.default_psi(p, n)
    x = np.random.default_rng(n).integers(0, p, size=(2, n), dtype=np.uint64)
    fwd = t_ref.ntt_numpy(x, p, psi)
    np.testing.assert_array_equal(fwd, j_ref.ntt_numpy(x, p, psi))
    np.testing.assert_array_equal(t_ref.intt_numpy(fwd, p, psi), j_ref.intt_numpy(fwd, p, psi))
    np.testing.assert_array_equal(t_ref.intt_numpy(fwd, p, psi), x)
    # the port's plain NTT uses the canonical psi: it is this transform
    plan = tntt.NTTPlan(n, (p,))
    got = tntt.ntt(from_numpy(x[:, None, :], "cpu"), plan)
    np.testing.assert_array_equal(to_numpy(got)[:, 0].astype(np.uint64), fwd)


def test_tensor_product_mont_matches_jax_and_tensor_product():
    rng = np.random.default_rng(5)
    a, b = _res(rng, (3, 2, len(PRIMES), N)), _res(rng, (3, 2, len(PRIMES), N))
    p, pinv, r2 = _consts()
    jp, jpinv, jr2 = (jnp.asarray(c) for c in (p, pinv, r2))
    tp, tpinv, tr2 = (torch.from_numpy(c.astype(np.int64)) for c in (p, pinv, r2))
    b0m = jmm.to_mont(jnp.asarray(b[:, 0]), jp, jpinv, jr2)
    b1m = jmm.to_mont(jnp.asarray(b[:, 1]), jp, jpinv, jr2)
    want = np.asarray(j_bgv.tensor_product_mont(jnp.asarray(a), b0m, b1m, jp, jpinv))
    got = t_bgv.tensor_product_mont(from_numpy(a, "cpu"), from_numpy(np.asarray(b0m), "cpu"),
                                    from_numpy(np.asarray(b1m), "cpu"), tp, tpinv)
    assert got.shape == (3, 3, len(PRIMES), N)
    np.testing.assert_array_equal(to_numpy(got), want)
    full = t_bgv.tensor_product(from_numpy(a, "cpu"), from_numpy(b, "cpu"), tp, tpinv, tr2)
    assert torch.equal(full, got)


CUCKOO_CASES = {
    # tests/test_native.py's input: load 0.37, every item placed
    "reference": dict(seed=99, values=range(2, 120), n_hf=2, size=160, max_pp=1,
                      multi_table=True, stash_size=0, rng_seed=7),
    # 90 items in 2 x 40 cells: the stash fills and failures are reported
    "overfull": dict(seed=5, values=range(1000, 1090), n_hf=2, size=40, max_pp=1,
                     multi_table=True, stash_size=4, rng_seed=11),
    # one combined table, two items a cell, a stash of 3
    "combined_overfull": dict(seed=6, values=range(3, 200), n_hf=3, size=30, max_pp=2,
                              multi_table=False, stash_size=3, rng_seed=13),
}


@pytest.mark.parametrize("case", sorted(CUCKOO_CASES))
def test_cuckoo_insert_seq_matches_jax(case, monkeypatch):
    """The port's binding and the JAX package's, both on the library the
    port builds from the repository's native/nhpsi_native.cpp (the JAX
    package's own build writes its library in place under native/build/,
    which test workers must not race on): the same table, stash and
    failures. g++ is present here and on the card, so a missing library
    fails."""
    c = CUCKOO_CASES[case]
    lib = t_native.get_lib()
    assert lib is not None, "the native library did not build"
    monkeypatch.setattr(j_native, "get_lib", lambda: lib)
    h = TabulationHashing(seed=c["seed"], n_hash_functions=c["n_hf"])
    items = items_from_ints(list(c["values"]))
    args = (h.table, 0, c["n_hf"], c["size"], c["max_pp"], c["multi_table"], c["stash_size"],
            c["rng_seed"])
    table, stash, failures = t_native.cuckoo_insert_seq(items, *args)
    j_table, j_stash, j_failures = j_native.cuckoo_insert_seq(items, *args)
    np.testing.assert_array_equal(table, j_table)
    np.testing.assert_array_equal(stash, j_stash)
    assert failures == j_failures
    n_tables = c["n_hf"] if c["multi_table"] else 1
    assert table.shape == (n_tables, c["max_pp"], c["size"], 2)
    assert stash.shape == (c["stash_size"], 2)
    stored = table.reshape(-1, 2)
    placed = (stored != 0).any(axis=1).sum() + (stash != 0).any(axis=1).sum()
    assert placed + failures == len(items)
    if case == "reference":
        assert failures == 0
    else:
        assert failures > 0 and (stash != 0).any(axis=1).all()
    # every table entry sits at one of its item's hashed positions
    for t in range(n_tables):
        for d in range(c["max_pp"]):
            for pos in np.flatnonzero((table[t, d] != 0).any(axis=1)):
                hs = [t] if c["multi_table"] else range(c["n_hf"])
                assert pos in {int(h.hash_index(table[t, d, pos][None], k, c["size"])[0])
                               for k in hs}


def test_cuckoo_insert_seq_refuses_out_of_range_arguments():
    """The C loop reads the tabulation table and the items unchecked: the
    binding refuses shapes and hash ids it would read past."""
    table = TabulationHashing(seed=1, n_hash_functions=2).table
    items = items_from_ints([5, 6])
    with pytest.raises(ValueError):
        t_native.cuckoo_insert_seq(items, table, 1, 2, 8, 1, True, 0, 1)  # ids 1, 2 of 2
    with pytest.raises(ValueError):
        t_native.cuckoo_insert_seq(items[:, :1], table, 0, 2, 8, 1, True, 0, 1)
    with pytest.raises(ValueError):
        t_native.cuckoo_insert_seq(items, table, 0, 2, 0, 1, True, 0, 1)
