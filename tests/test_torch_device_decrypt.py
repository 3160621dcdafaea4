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
from nested_hashing_psi_tpu_torch.ops import decrypt_cuda
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


# ---- BGV-form results, the decrypt kernel's tables, result_zero_mask -------

T32 = PLAINTEXT_MODULI[32]


def _bgv_ct(t, limbs, ring=256, shape=(3,), seed=0):
    """A port BGV context, its key, a BGV-form encryption of seeded slot
    values of the given leading shape (every seventh slot 0) and the values."""
    ctx = make_context(SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=limbs,
                                    scheme="bgv"), seed=seed + 1, device="cpu")
    sk, _ = ctx.keygen()
    vals = np.random.default_rng(seed).integers(0, min(t, 1 << 60), size=(*shape, ring))
    vals = vals.astype(object) % t
    vals[..., ::7] = 0
    pt = ctx.make_plaintext_rns(vals.reshape(-1, ring))
    ct = ctx.encrypt_sk(pt.reshape(*shape, *pt.shape[-2:]), sk)
    return ctx, sk, ct, vals


def _host_slots(ctx, ct, sk):
    slots, _ = ctx.decrypt(ct, sk)
    return np.asarray(slots, dtype=object)


@pytest.mark.parametrize("bits,limbs", [(32, 5), (40, 5), (48, 6)])
def test_bgv_form_decrypt_matches_host_decrypt(bits, limbs):
    """Flat BGV (the cells' 33-bit t, a 40- and a 48-bit t): the plain
    version's slots and zero mask against BGVContext.decrypt's slots."""
    ctx, sk, ct, vals = _bgv_ct(PLAINTEXT_MODULI[bits], limbs, seed=bits)
    assert ctx.default_form == "bgv" and ct.form == "bgv"
    dec = DeviceDecryptor(ctx)
    assert dec.form == "bgv"
    host = _host_slots(ctx, ct, sk)
    np.testing.assert_array_equal(host, vals)
    got = dec.slots(ct.data, sk.s_mont).numpy().astype(object)
    np.testing.assert_array_equal(got, host)
    mask = dec.zero_mask(ct.data, sk.s_mont, length=200)
    assert mask.dtype == torch.bool and tuple(mask.shape) == (3, 200)
    np.testing.assert_array_equal(mask.numpy(), host[:, :200] == 0)


@pytest.mark.parametrize("switches", [1, 2])
def test_bgv_form_decrypt_leveled_mod_switched(switches):
    """Leveled BGV at t = 65537: a result mod-switched down the chain lives
    on fewer limbs with a scale other than 1, which never moves a zero: the
    zero mask equals the host decrypt's, and the slots are the host's
    times the scale."""
    ctx, sk, ct, vals = _bgv_ct(65537, 5, seed=switches)
    for _ in range(switches):
        ct = ctx.context_for_limbs(ct.data.shape[-2]).mod_switch(ct)
    L = ct.data.shape[-2]
    assert L == 5 - switches and ct.scale != 1
    sctx, ssk = ctx.context_for_limbs(L), ctx.shrink_key_to(sk, L)
    host = _host_slots(sctx, ct, ssk)
    np.testing.assert_array_equal(host, vals)
    dec = DeviceDecryptor(sctx, ct.form)
    got = dec.slots(ct.data, ssk.s_mont).numpy().astype(object)
    np.testing.assert_array_equal(got, host * ct.scale % 65537)
    np.testing.assert_array_equal(dec.zero_mask(ct.data, ssk.s_mont).numpy(), host == 0)


@pytest.mark.parametrize("t", [T32, 65537], ids=["flat", "t65537"])
def test_bgv_form_decrypt_batched_leading_shape(t):
    """(Q, D, 2, L, N) BGV results decrypt like each (2, L, N) one."""
    ctx, sk, ct, vals = _bgv_ct(t, 4, shape=(2, 3), seed=4)
    dec = DeviceDecryptor(ctx)
    batch = dec.zero_mask(ct.data, sk.s_mont, length=100)
    assert tuple(batch.shape) == (2, 3, 100)
    for q in range(2):
        for d in range(3):
            assert torch.equal(batch[q, d], dec.zero_mask(ct.data[q, d], sk.s_mont, 100))
    np.testing.assert_array_equal(batch.numpy(), vals[..., :100] == 0)


def test_decryptor_refuses_unknown_form_and_bad_length():
    ctx, sk, ct, _ = _bgv_ct(T32, 3)
    with pytest.raises(ValueError):
        DeviceDecryptor(ctx, "ckks")
    with pytest.raises(ValueError):
        DeviceDecryptor(ctx).zero_mask(ct.data, sk.s_mont, length=ctx.n + 1)


def _shoup32(x, w, wq, q):
    r = (x * w - ((x * wq) >> 32) * q) & 0xFFFFFFFF
    return r - q if r >= q else r


def _shoup64(x, w, wq, t):
    r = (x * w - ((x * wq) >> 64) * t) & (2**64 - 1)
    assert r < 2 * t
    return r - t if r >= t else r


def _kernel_mirror(phase, tables, bgv, length, cluster):
    """csrc/decrypt.cu's arithmetic and indexing in Python integers, read
    from the kernel's own tables: the CRT front per coefficient in its
    128-bit words, then the transform with a row split over ``cluster``
    blocks (the first log2 cluster stages read the partner's block, the rest
    stay within a block), then the gather through s2n. -> (rows, length)."""
    consts, psi, s2n = (tb.numpy() for tb in tables)
    c = [int(v) for v in consts.view(np.uint64)]
    w = [int(v) for v in psi.view(np.uint64)]
    rows, L, n = phase.shape
    t, E, H, W = c[0], n // cluster, decrypt_cuda.HEAD, decrypt_cuda.LIMB_WORDS
    logn, log_c = n.bit_length() - 1, cluster.bit_length() - 1
    out = np.zeros((rows, length), bool)
    for r in range(rows):
        m = []
        for j in range(n):
            lo, hi, acc = 1 << 71, 0, 0
            for i in range(L):
                q, inv, invq, tlo, thi, h, hq = c[H + W * i : H + W * i + 7]
                y = _shoup32(int(phase[r, i, j]), inv, invq, q)
                lo, hi = lo + y * tlo, hi + y * thi
                acc = (acc + _shoup64(y, h, hq, t)) % t
            assert lo >> 128 == 0 and hi >> 128 == 0
            k = ((lo >> 64) + hi) >> 8
            assert k >> 64 == 0
            m.append((acc - _shoup64(k, c[1], c[2], t)) % t if bgv else k % t)
        for s in range(logn):
            tt, g0 = n >> (s + 1), 1 << s
            if s < log_c:  # each block's own outputs, the partner read across
                new = list(m)
                for g in range(n):
                    up = g & tt != 0
                    u, v = (m[g ^ tt], m[g]) if up else (m[g], m[g ^ tt])
                    i = g0 + g // (2 * tt)
                    vw = _shoup64(v, w[i], w[n + i], t)
                    new[g] = (u - vw) % t if up else (u + vw) % t
                m = new
                continue
            for base in range(0, n, E):
                for b in range(E // 2):
                    gl, pos = b // tt, (b // tt) * 2 * tt + b % tt + base
                    i = g0 + base // (2 * tt) + gl
                    u, vw = m[pos], _shoup64(m[pos + tt], w[i], w[n + i], t)
                    m[pos], m[pos + tt] = (u + vw) % t, (u - vw) % t
        out[r] = [m[int(p)] == 0 for p in s2n[:length]]
    return out


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("form,t", [("bfv", T32), ("bgv", T32), ("bgv", 65537),
                                    ("bfv", PLAINTEXT_MODULI[48])],
                         ids=["bfv", "bgv", "bgv_t65537", "bfv_48bit"])
def test_kernel_tables_and_algorithm_mirror_plain(form, t, cluster):
    """The decrypt kernel's tables and its algorithm, mirrored in Python
    integers (the kernel itself runs only on the card), give the plain
    version's zero mask with a row split over each cluster the kernel
    picks: 1, 2, 4 and 8 blocks (n up to 2048, 4096, 8192, 16384 on up)."""
    ctx = make_context(SchemeParams(ring_dim=256, plaintext_modulus=t, num_limbs=4,
                                    scheme=form), seed=5, device="cpu")
    sk, _ = ctx.keygen()
    vals = np.random.default_rng(cluster).integers(0, 1000, size=(2, 256)).astype(object)
    vals[:, ::5] = 0
    ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
    dec = DeviceDecryptor(ctx)
    phase = dec._phase(ct.data, sk.s_mont)
    want = dec.zero_mask(ct.data, sk.s_mont, length=200).numpy()
    np.testing.assert_array_equal(want, vals[:, :200] == 0)
    assert dec.kernel_tables is None  # a CPU context launches no kernel
    tables = decrypt_cuda.constants(*dec._kernel_inputs, "cpu")
    got = _kernel_mirror(phase, tables, form == "bgv", 200, cluster)
    np.testing.assert_array_equal(got, want)


def test_kernel_tables_layout():
    """The constants' layout the kernel reads (kHead, kLimbWords); the
    wrapper refuses a CPU tensor."""
    ctx, _, _, _ = _bgv_ct(T32, 3)
    dec = DeviceDecryptor(ctx)
    consts, psi, s2n = decrypt_cuda.constants(*dec._kernel_inputs, "cpu")
    assert consts.dtype == torch.int64 and tuple(consts.shape) == (4 + 8 * 3,)
    assert tuple(psi.shape) == (2 * 256,) and s2n.dtype == torch.int32
    c = [int(v) for v in consts.numpy().view(np.uint64)]
    q = int(np.prod([int(p) for p in ctx.q_primes], dtype=object))
    assert c[:3] == [T32, q % T32, (q % T32 << 64) // T32]
    assert [c[4 + 8 * i] for i in range(3)] == [int(p) for p in ctx.q_primes]
    assert [c[7 + 8 * i] + (c[8 + 8 * i] << 64) for i in range(3)] == \
        [(1 << 72) // int(p) for p in ctx.q_primes]
    with pytest.raises(ValueError):
        decrypt_cuda.zero_mask(torch.zeros((1, 3, 256), dtype=torch.int32), consts, psi, s2n,
                               True, 256)


@pytest.mark.parametrize("form,ship", [("bfv", 5), ("bfv", 3), ("bgv", 5), ("bgv", 4)])
def test_result_zero_mask_on_cpu_is_the_host_decrypt(form, ship):
    """On the CPU ``result_zero_mask`` (name, signature and return unchanged:
    the benchmark harness swaps the module attribute) decrypts on the host
    in the context of the result's limb count, with a noise estimate, and
    keeps no device decryptor."""
    import inspect

    from nested_hashing_psi_tpu_torch.protocol import batched_fhe

    assert list(inspect.signature(batched_fhe.result_zero_mask).parameters) == \
        ["ctx", "result", "sk", "length", "decryptors"]
    t = T32 if form == "bfv" else 65537
    ctx = make_context(SchemeParams(ring_dim=256, plaintext_modulus=t, num_limbs=5,
                                    scheme=form), seed=6, device="cpu")
    sk, _ = ctx.keygen()
    vals = np.random.default_rng(ship).integers(0, 1000, size=(3, 256)).astype(object)
    vals[:, ::3] = 0
    if form == "bgv":
        ct = ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk)
        while ct.data.shape[-2] > ship:
            ct = ctx.context_for_limbs(ct.data.shape[-2]).mod_switch(ct)
    else:
        sctx, ssk = ctx.context_for_limbs(ship), ctx.shrink_key_to(sk, ship)
        ct = sctx.encrypt_sk(sctx.make_plaintext_rns(vals), ssk)
    decryptors = {}
    mask, noise = batched_fhe.result_zero_mask(ctx, ct, sk, 100, decryptors)
    assert isinstance(mask, np.ndarray) and mask.dtype == bool and mask.shape == (3, 100)
    np.testing.assert_array_equal(mask, vals[:, :100] == 0)
    host, want_noise = ctx.decrypt(ct, sk, length=100)
    np.testing.assert_array_equal(mask, np.asarray(host, dtype=object) == 0)
    assert noise == want_noise and noise is not None and not decryptors
