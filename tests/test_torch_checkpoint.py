"""The port's offline-artifact checkpoint (``utils.checkpoint``) against the
JAX package's (``nested_hashing_psi_tpu.utils.checkpoint``), on the CPU.

Both packages build a PIE from the same nested table, mask_seed and relin
key (carried across by ``convert``); their v3 files are equal key by key in
value, dtype and shape. The port resumes the JAX package's file and the JAX
package resumes the port's, and on the same (JAX-encrypted) query the two
resumed PIEs answer bit for bit alike (the JAX side under
``jax.enable_x64(True)``, as the port's float64 estimates), under BFV
rescaled and flat and under BGV flat and leveled. Every comparison is exact
(tolerance: none). The JAX package's modules are imported in a fixture, so
the one GPU case also runs where jax is not installed
(``python -m pytest --noconftest tests/test_torch_checkpoint.py -m gpu``).
"""

import types

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe import bfv as t_bfv
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu_torch.pie import batched_fhe as t_pie
from nested_hashing_psi_tpu_torch.utils import checkpoint as t_ck

torch.set_num_threads(1)

T16, T32 = 65537, (1 << 32) + (1 << 20) + (1 << 19) + 1
N_SIMPLE_HF, N_CUCKOO_HF, SIMPLE_SIZE, CUCKOO_SIZE, MAX_PP = 2, 2, 16, 8, 3
SCHEMES = {"bfv": dict(ring_dim=64, plaintext_modulus=T32, num_limbs=6, scheme="bfv"),
           "bgv": dict(ring_dim=256, plaintext_modulus=T16, num_limbs=8, scheme="bgv")}
CASES = {"bfv_rescaled": ("bfv", {}), "bfv_flat": ("bfv", {"mul_limbs": 0}),
         "bgv_flat": ("bgv", {}), "bgv_leveled": ("bgv", {"leveled": True})}
MASK_SEED = 99


def _tables():
    hasher = TabulationHashing(122333444455555, N_SIMPLE_HF + N_CUCKOO_HF)
    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=SIMPLE_SIZE, each_cuckoo_table_size=CUCKOO_SIZE,
        n_simple_hash_functions=N_SIMPLE_HF, n_cuckoo_hash_functions=N_CUCKOO_HF,
        max_items_per_position=MAX_PP, seed=7,
    )
    hct.insert_all(items_from_ints(list(range(100, 160))))
    client_table = CuckooHashTable(
        hasher, each_table_size=SIMPLE_SIZE, n_hash_functions=N_SIMPLE_HF,
        starting_hash_id=0, max_items_per_position=1, seed=8,
    )
    client_table.insert_all(items_from_ints([105, 131, 159, 4242, 9999]))
    return hct, client_table


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, not at the top)."""
    import jax

    from nested_hashing_psi_tpu.fhe import bfv as j_bfv
    from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
    from nested_hashing_psi_tpu.pie import batched_fhe as j_pie
    from nested_hashing_psi_tpu.utils import checkpoint as j_ck

    return types.SimpleNamespace(jax=jax, bfv=j_bfv, SchemeParams=JSchemeParams, pie=j_pie,
                                 ck=j_ck)


def _make_world(jx, scheme):
    """One nested table, the JAX package's keys and query under one scheme,
    the same keys in a port context."""
    kw = SCHEMES[scheme]
    hct, client_table = _tables()
    jctx = jx.bfv.make_context(jx.SchemeParams(**kw), seed=4)
    tctx = t_bfv.make_context(SchemeParams(**kw), seed=5, device="cpu")
    jsk, _ = jctx.keygen()
    jrlk = jctx.relin_keygen(jsk)
    trlk = convert.relin_key_from_numpy(np.asarray(jrlk.b_mont), np.asarray(jrlk.a_mont), "cpu")
    jops = jx.pie.BatchedFHEClientOps(jctx, client_table, N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE)
    jidx, jminus = jops.encrypt_query(jsk)
    return dict(hct=hct, jctx=jctx, tctx=tctx, jsk=jsk, jrlk=jrlk, trlk=trlk, jidx=jidx,
                jminus=jminus, idx=convert.from_numpy(np.asarray(jidx.data), "cpu"),
                minus=convert.from_numpy(np.asarray(jminus.data), "cpu"))


@pytest.fixture(scope="module")
def worlds(jx):
    """scheme -> its world, each made once."""
    cache = {}

    def get(scheme):
        if scheme not in cache:
            cache[scheme] = _make_world(jx, scheme)
        return cache[scheme]
    return get


@pytest.fixture(scope="module")
def world(worlds):
    return worlds("bfv")


def _port_pie(world, **kw):
    return t_pie.BatchedFHEPIE(world["tctx"], world["hct"], world["trlk"], mask_seed=MASK_SEED,
                               encode_slab=7, **kw)


def _same_files(a, b, skip=()):
    """Two .npz files hold the same keys, each equal in value, dtype, shape."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k in skip:
                continue
            assert (za[k].dtype, za[k].shape) == (zb[k].dtype, zb[k].shape), k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_equal_and_resume_across_packages(worlds, jx, case, tmp_path):
    scheme, kw = CASES[case]
    world = worlds(scheme)
    jpie = jx.pie.BatchedFHEPIE(world["jctx"], world["hct"], world["jrlk"], mask_seed=MASK_SEED,
                                **kw)
    tpie = _port_pie(world, **kw)
    jfile, tfile = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jx.ck.save_batched_pie(jfile, jpie)
    t_ck.save_batched_pie(tfile, tpie)
    _same_files(jfile, tfile)
    with np.load(tfile) as z:
        assert z["table_pt"].dtype == np.uint32 and int(z["dims"][7]) == 0

    # each package resumes the other's file from the file alone
    t_res = t_ck.load_batched_pie(jfile, device="cpu")
    j_res = jx.ck.load_batched_pie(tfile)
    for res in (t_res, j_res):
        assert (res.mul_limbs, res.ship_limbs, res.leveled) == \
            (tpie.mul_limbs, tpie.ship_limbs, tpie.leveled)
    if case == "bfv_flat":  # the flat product must not resume on the auto pipeline
        assert t_res.mul_limbs is None and j_res.mul_limbs is None
    elif case == "bfv_rescaled":
        assert t_res.mul_limbs is not None
    assert t_res.ctx.params == tpie.ctx.params and t_res.ctx.device.type == "cpu"
    with jx.jax.enable_x64(True):
        want = j_res.run(world["jidx"], world["jminus"])
    got = t_res(world["idx"], world["minus"])
    assert (got.form, got.scale) == (want.form, want.scale)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))
    assert torch.equal(got.data, tpie(world["idx"], world["minus"]).data)


def test_host_resident_artifact(world, jx, tmp_path):
    """A host-resident PIE saves the logical layout (its file equals the
    device PIE's but for dims[7]) from its position-major storage without a
    copy, and resumes host-resident, position-major, bit-equal; the JAX
    package resumes it host-resident too."""
    dev, host = _port_pie(world), _port_pie(world, host_table=True)
    assert host.logical_table().data_ptr() == host._host_positions().data_ptr()
    assert not host.logical_table().is_contiguous()
    dfile, hfile = str(tmp_path / "dev.npz"), str(tmp_path / "host.npz")
    t_ck.save_batched_pie(dfile, dev)
    t_ck.save_batched_pie(hfile, host)
    _same_files(dfile, hfile, skip=("dims",))
    with np.load(dfile) as zd, np.load(hfile) as zh:
        np.testing.assert_array_equal(zd["dims"][:7], zh["dims"][:7])
        assert (int(zd["dims"][7]), int(zh["dims"][7])) == (0, 1)
    res = t_ck.load_batched_pie(hfile, device="cpu")
    assert res.host_table and res.table_pt.device.type == "cpu"
    assert res._host_positions().is_contiguous()
    assert torch.equal(res.logical_table(), dev.table_pt)
    want = dev(world["idx"], world["minus"]).data
    assert torch.equal(res(world["idx"], world["minus"]).data, want)
    j_res = jx.ck.load_batched_pie(hfile, world["jctx"], world["jrlk"])
    assert j_res.host_table and isinstance(j_res.table_pt, np.ndarray)


@pytest.mark.parametrize("threshold", ["lowered", "default"])
def test_early_v3_file_follows_the_size_rule(world, tmp_path, monkeypatch, threshold):
    """A file whose dims stop at [:7] (no residency flag) resumes
    host-resident above HOST_RESIDENT_BYTES (12 GB; lowered here below the
    table's size), device-resident otherwise."""
    pie = _port_pie(world)
    full, early = str(tmp_path / "full.npz"), str(tmp_path / "early.npz")
    t_ck.save_batched_pie(full, pie)
    with np.load(full) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["dims"] = arrays["dims"][:7]
    np.savez(early, **arrays)
    nbytes = arrays["table_pt"].nbytes
    if threshold == "lowered":
        monkeypatch.setattr(t_ck, "HOST_RESIDENT_BYTES", nbytes - 1)
    else:
        assert t_ck.HOST_RESIDENT_BYTES == 12 << 30
    res = t_ck.load_batched_pie(early, device="cpu")
    assert res.host_table is (threshold == "lowered")
    assert (res.mul_limbs, res.ship_limbs) == (pie.mul_limbs, pie.ship_limbs)
    assert torch.equal(res(world["idx"], world["minus"]).data,
                       pie(world["idx"], world["minus"]).data)


@pytest.mark.parametrize("version", [1, 2])
def test_rejects_other_versions(tmp_path, version):
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, version=version)
    with pytest.raises(ValueError, match=f"version {version}"):
        t_ck.load_batched_pie(path, device="cpu")


def test_rejects_int32_residues(world, tmp_path):
    """Residues are uint32 in the file (int32 would load in the JAX package
    as int32 and feed its uint32 kernels other numbers)."""
    path = str(tmp_path / "p.npz")
    t_ck.save_batched_pie(path, _port_pie(world))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["table_pt"] = arrays["table_pt"].view(np.int32)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="uint32"):
        t_ck.load_batched_pie(path, device="cpu")


def test_self_contained_load(world, tmp_path):
    """From the file alone (the scheme and relin key inside), and with the
    caller's context and key: equal parameters, a bit-equal result."""
    pie = _port_pie(world)
    path = str(tmp_path / "p.npz")
    t_ck.save_batched_pie(path, pie)
    want = pie(world["idx"], world["minus"]).data
    solo = t_ck.load_batched_pie(path, device="cpu")
    assert solo.ctx.params == world["tctx"].params
    assert torch.equal(solo.rlk_b, world["trlk"].b_mont)
    assert torch.equal(solo(world["idx"], world["minus"]).data, want)
    given = t_ck.load_batched_pie(path, world["tctx"], world["trlk"], device="cpu")
    assert given.ctx is world["tctx"]
    assert torch.equal(given(world["idx"], world["minus"]).data, want)


def test_default_device_is_the_gpu(world, tmp_path):
    """Without CUDA the default device raises (no CPU fallback); a context
    on another device than the one asked for is refused."""
    path = str(tmp_path / "p.npz")
    t_ck.save_batched_pie(path, _port_pie(world))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device loads")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ck.load_batched_pie(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ck.load_batched_pie(path, world["tctx"], device="cuda")


@pytest.mark.gpu
def test_resume_on_gpu_with_pinned_host_storage(tmp_path):
    """On the card: a host-resident artifact resumes into pinned,
    position-major host storage and answers like the device-resident PIE
    (K2 reads the uploaded slices, K1 transforms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels

    hct, client_table = _tables()
    ctx = t_bfv.make_context(SchemeParams(**SCHEMES["bfv"]), seed=5, device="cuda")
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    dev = t_pie.BatchedFHEPIE(ctx, hct, rlk, mask_seed=MASK_SEED)
    host = t_pie.BatchedFHEPIE(ctx, hct, rlk, mask_seed=MASK_SEED, host_table=True)
    ops = t_pie.BatchedFHEClientOps(ctx, client_table, N_SIMPLE_HF, N_CUCKOO_HF, CUCKOO_SIZE)
    idx, minus = ops.encrypt_query(sk)
    path = str(tmp_path / "host.npz")
    t_ck.save_batched_pie(path, host)
    res = t_ck.load_batched_pie(path)
    assert res.host_table and res.table_pt.is_pinned() and res._host_positions().is_contiguous()
    assert res.table_pt.device.type == "cpu" and res.mask_pt.is_cuda and res.rlk_b.is_cuda
    want = dev.run(idx, minus).data
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    assert torch.equal(res.run(idx, minus).data, want)
    assert min(ntt_cuda.launches.values()) > 0 and pie_kernels.launches > 0
