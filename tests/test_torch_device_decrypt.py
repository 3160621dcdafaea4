"""Port on-device decrypt against the JAX package, bit-exact on the CPU.

``ops.mod64`` (two-plane arithmetic mod a 33-49-bit t) is held against the
JAX package's ``ops.mod64`` primitive by primitive, and
``fhe.device_decrypt.DeviceDecryptor`` against the JAX package's
``DeviceDecryptor`` and against the host decrypt, for every tabled plaintext
modulus and on the rescaled ship basis the batched PIE ships. Inputs come
from seeded numpy generators; every comparison is exact equality.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nested_hashing_psi_tpu.fhe.bfv import make_context as j_make_context
from nested_hashing_psi_tpu.fhe.device_decrypt import DeviceDecryptor as JDeviceDecryptor
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.ops import mod64 as jm
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
from nested_hashing_psi_tpu_torch.fhe.params import PLAINTEXT_MODULI, SchemeParams
from nested_hashing_psi_tpu_torch.ops import mod64 as tm

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 512


def _u64(lo, hi):
    return tm.u64_from_planes_np(np.asarray(lo), np.asarray(hi))


def _t_planes(x):
    """uint64 array -> (JAX uint32 planes, port int64 plane tensors)."""
    lo, hi = tm.planes_from_u64_np(x)
    return (jnp.asarray(lo), jnp.asarray(hi)), tm.planes(x, "cpu")


def _port_u64(planes):
    return _u64(planes[0].numpy().astype(np.uint32), planes[1].numpy().astype(np.uint32))


@pytest.mark.parametrize("bits", [32, 40, 48])
@pytest.mark.parametrize(
    "op", ["mul64_lo", "mul64_hi", "ge64", "sub64", "add64", "csub64",
           "add2_mod", "sub2_mod", "shoup_mul2"]
)
def test_mod64_primitive_matches_jax(op, bits):
    t = PLAINTEXT_MODULI[bits]
    rng = np.random.default_rng(bits)
    x = rng.integers(0, 1 << 63, size=SIZE, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    y = rng.integers(0, 1 << 63, size=SIZE, dtype=np.uint64)
    a = rng.integers(0, t, size=SIZE, dtype=np.uint64)
    b = rng.integers(0, t, size=SIZE, dtype=np.uint64)
    a[:3], b[:3] = [0, t - 1, t - 1], [t - 1, 0, t - 1]  # edges
    t2j = tuple(np.uint32(v) for v in jm.split_u64(t))
    t2t = tm.split_u64(t)
    assert t2t == jm.split_u64(t)
    if op in ("mul64_lo", "mul64_hi", "ge64", "sub64", "add64"):
        (jx, tx), (jy, ty) = _t_planes(x), _t_planes(y)
        want = getattr(jm, op)(jx[0], jx[1], jy[0], jy[1])
        got = getattr(tm, op)(tx[0], tx[1], ty[0], ty[1])
        if op == "ge64":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            return
    elif op == "csub64":
        s = (a + np.where(rng.random(SIZE) < 0.5, np.uint64(t), np.uint64(0))).astype(np.uint64)
        js, ts = _t_planes(s)
        want = jm.csub64(js[0], js[1], *t2j)
        got = tm.csub64(ts[0], ts[1], *t2t)
    elif op in ("add2_mod", "sub2_mod"):
        (ja, ta), (jb, tb) = _t_planes(a), _t_planes(b)
        want = getattr(jm, op)(ja, jb, t2j)
        got = getattr(tm, op)(ta, tb, t2t)
        ref = (a.astype(object) + b) % t if op == "add2_mod" else (a.astype(object) - b) % t
        np.testing.assert_array_equal(_port_u64(got).astype(object), ref)
    else:  # shoup_mul2, x below 2^64 and a constant w < t
        w = int(b[5])
        (jx, tx) = _t_planes(x)
        w2, wq2 = tm.split_u64(w), tm.shoup64_host(w, t)
        assert wq2 == jm.shoup64_host(w, t)
        want = jm.shoup_mul2(jx, tuple(map(np.uint32, w2)), tuple(map(np.uint32, wq2)), t2j)
        got = tm.shoup_mul2(tx, w2, wq2, t2t)
        np.testing.assert_array_equal(_port_u64(got).astype(object), (x.astype(object) * w) % t)
    np.testing.assert_array_equal(_port_u64(got), _u64(*want))


@pytest.mark.parametrize("bits", [32, 40, 48])
def test_ntt2_mod_t_matches_jax(bits):
    """The decode NTT mod t on a (3, 256) batch, same twiddle planes."""
    t = PLAINTEXT_MODULI[bits]
    ctx = make_context(SchemeParams(ring_dim=256, plaintext_modulus=t, num_limbs=3,
                                    scheme="bfv"), seed=1, device="cpu")
    dec = DeviceDecryptor(ctx)
    x = np.random.default_rng(bits).integers(0, t, size=(3, 256), dtype=np.uint64)
    jx, tx = _t_planes(x)
    jw = tuple(jnp.asarray(p.numpy().astype(np.uint32)) for p in dec._psi_w)
    jwq = tuple(jnp.asarray(p.numpy().astype(np.uint32)) for p in dec._psi_wq)
    t2 = tm.split_u64(t)
    want = jm.ntt2_mod_t(jx, jw, jwq, tuple(np.uint32(v) for v in t2))
    got = tm.ntt2_mod_t(tx, dec._psi_w, dec._psi_wq, t2)
    np.testing.assert_array_equal(_port_u64(got), _u64(*want))


def test_planes_host_helpers_match_jax():
    x = np.random.default_rng(3).integers(0, 1 << 62, size=(4, 5), dtype=np.uint64)
    for arr in (x, x.astype(object)):
        lo, hi = tm.planes_from_u64_np(arr)
        jlo, jhi = jm.planes_from_u64_np(arr)
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)
        np.testing.assert_array_equal(tm.u64_from_planes_np(lo, hi), x)


def _contexts(bits, limbs=5, ring=256):
    t = PLAINTEXT_MODULI[bits]
    kw = dict(ring_dim=ring, plaintext_modulus=t, num_limbs=limbs, scheme="bfv")
    jctx = j_make_context(JSchemeParams(**kw), seed=11)
    tctx = make_context(SchemeParams(**kw), seed=12, device="cpu")
    return t, jctx, tctx


@pytest.mark.parametrize("bits", [16, 32, 40, 48])
def test_device_slots_match_jax_and_host_decrypt(bits):
    t, jctx, tctx = _contexts(bits)
    jsk, _ = jctx.keygen()
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, min(t, 1 << 60), size=(3, 256)).astype(object) % t
    vals[0, :7] = 0  # exercise the zero mask
    ct = jctx.encrypt_sk(jctx.make_plaintext_rns(vals), jsk)
    data = convert.from_numpy(np.asarray(ct.data), "cpu")

    dec = DeviceDecryptor(tctx)
    got = dec.slots(data, tsk.s_mont)
    lo, hi = JDeviceDecryptor(jctx).slots(ct.data, jsk.s_mont)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), _u64(lo, hi))
    host, _ = tctx.decrypt(convert.ciphertext_from_numpy(np.asarray(ct.data), "cpu"), tsk)
    np.testing.assert_array_equal(got.numpy().astype(object), np.asarray(host, dtype=object))
    np.testing.assert_array_equal(got.numpy().astype(object) % t, vals)

    mask = dec.zero_mask(data, tsk.s_mont, length=200)
    assert mask.dtype == torch.bool and tuple(mask.shape) == (3, 200)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(host, dtype=object)[:, :200] == 0)


def test_device_decrypt_batched_leading_shape():
    """(Q, D, 2, L, N) results decrypt like each (2, L, N) one."""
    t, jctx, tctx = _contexts(32)
    jsk, _ = jctx.keygen()
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    vals = np.random.default_rng(5).integers(0, 50, size=(6, 256)).astype(object)
    ct = np.asarray(jctx.encrypt_sk(jctx.make_plaintext_rns(vals), jsk).data)  # (6, 2, L, N)
    data = convert.from_numpy(ct.reshape(2, 3, *ct.shape[1:]), "cpu")
    dec = DeviceDecryptor(tctx)
    batch = dec.zero_mask(data, tsk.s_mont)
    assert tuple(batch.shape) == (2, 3, 256)
    for q in range(2):
        for d in range(3):
            one = dec.zero_mask(data[q, d], tsk.s_mont)
            assert torch.equal(batch[q, d], one)
    np.testing.assert_array_equal(batch.reshape(6, 256).numpy(), vals == 0)


def test_device_decrypt_on_rescaled_pie_output():
    """The flagship path: the batched PIE's result on the ship basis,
    decrypted in the matching child context with the shrunk key, gives the
    host decrypt's zero mask and the intersection."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import _build_small_pie

    t = PLAINTEXT_MODULI[32]
    jctx, jsk, _, jpie, jops, idx_ct, minus_ct = _build_small_pie(
        ring=512, limbs=7, H=2, P=8, D=4, simple=64, t=t, scheme="bfv"
    )
    out = jpie.run(idx_ct, minus_ct)
    L_ship = out.data.shape[-2]
    assert L_ship < jctx.L
    host_slots, _ = jctx.decrypt(out, jsk, length=jpie.batch_slots)

    tctx = make_context(SchemeParams(ring_dim=512, plaintext_modulus=t, num_limbs=7,
                                     scheme="bfv"), seed=2, device="cpu")
    tsk = convert.secret_key_from_numpy(np.asarray(jsk.s_mont), np.asarray(jsk.s_ntt), "cpu")
    sctx, ssk = tctx.context_for_limbs(L_ship), tctx.shrink_key_to(tsk, L_ship)
    data = convert.from_numpy(np.asarray(out.data), "cpu")
    mask = DeviceDecryptor(sctx).zero_mask(data, ssk.s_mont, length=jpie.batch_slots)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(host_slots, dtype=object) == 0)
    jmask = JDeviceDecryptor(jctx.context_for_limbs(L_ship)).zero_mask(
        out.data, jctx.shrink_key_to(jsk, L_ship).s_mont, length=jpie.batch_slots
    )
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    inter = jops.extract_intersection_mask(mask.numpy())
    assert sorted(int(v) for v, _ in inter) == [105, 131]
