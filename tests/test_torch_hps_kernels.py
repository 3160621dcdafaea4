"""The HPS kernels' wrapper (ops/hps_cuda.py) on the CPU.

csrc/hps.cu runs only on a card (tests/test_torch_hps_gpu.py holds it bit
for bit against the plain functions there). Here: its table layouts equal
the wrapper's, the tables hold the converters' numpy constants, a NumPy
mirror of each kernel's arithmetic, reading only those tables in the
kernel's order, equals the plain PyTorch functions (``ops/basis.py``,
``fhe/bgv.py`` ``tensor_product``) on random residues and on the rounding
boundaries, the wrapper refuses what the kernels cannot take, and the CPU
path launches nothing.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch.fhe.bgv import tensor_product
from nested_hashing_psi_tpu_torch.ops import hps_cuda as hc
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter, RNSRescale
from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
HPS_CU = os.path.join(hc.cuda_lib.CSRC, "hps.cu")
M32 = np.uint64(0xFFFFFFFF)

# (ring, L, mul limbs): the cells' 6 -> 5 (aux 8), the full basis' 6 (aux 9),
# a two-limb drop and the largest basis the kernels take
CASES = [(64, 6, 5), (64, 6, 6), (32, 8, 6), (16, 16, 14)]


def _q(n, L):
    return list(ntt_primes(L, 31, 2 * n, avoid=(T32,)))


def _res(shape, primes, seed):
    """Random residues (..., len(primes), N) below each prime, int32."""
    rng = np.random.default_rng(seed)
    p = np.array(primes, np.int64).reshape(len(primes), 1)
    return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))


def _crt_rows(xs, primes, n=32):
    """The residues of the integers xs over primes, the integers along N in
    rows of n (padded with zeros): (rows, len(primes), n). torch.sum adds
    the limbs of a row of 16 or more coefficients in order, limb 0 first,
    as the kernels do; below 16 it vectorises the limb axis."""
    xs = list(xs) + [0] * (-len(xs) % n)
    res = torch.tensor([[x % p for x in xs] for p in primes], dtype=torch.int64).int()
    return res.reshape(len(primes), -1, n).transpose(0, 1).contiguous()


def _boundary(primes, n=8):
    """Integers below prod(primes) whose fraction x / q sits at one half and
    at 0.5 +- 2^-40 (the overflow count's rounding), and near each prime's
    half (the centred rescale of a dropped limb)."""
    q = math.prod(primes)
    xs = [q // 2, q // 2 + 1, (q - 1) // 2]
    for k in (-1, 1):
        xs += [q // 2 + k * (q >> 40) + d for d in (-1, 0, 1)]
    xs += [primes[-1] // 2 + d for d in range(-n // 2, n // 2)]
    return xs


# ---- the layouts ---------------------------------------------------------

def test_layouts_match_the_kernel_source():
    src = open(HPS_CU).read()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    want = {
        "kMaxQ": hc.MAX_Q, "kMaxAux": hc.MAX_AUX,
        "kRKeepP": hc.R_KEEP_P, "kRDropP": hc.R_DROP_P, "kRQdhatInv": hc.R_QDHAT_INV,
        "kRQdhatModK": hc.R_QDHAT_MOD_K, "kRQdModK": hc.R_QD_MOD_K,
        "kRQdinvModK": hc.R_QDINV_MOD_K, "kRInvDrop": hc.R_INV_DROP, "kRWords": hc.R_WORDS,
        "kESrcP": hc.E_SRC_P, "kEDstP": hc.E_DST_P, "kEQhatInv": hc.E_QHAT_INV,
        "kEQhatModB": hc.E_QHAT_MOD_B, "kEQModB": hc.E_Q_MOD_B, "kEInvSrc": hc.E_INV_SRC,
        "kEWords": hc.E_WORDS,
        "kMTQ": hc.M_T_Q, "kMTAux": hc.M_T_AUX, "kMQinvAux": hc.M_QINV_AUX,
        "kMCModAux": hc.M_C_MOD_AUX, "kMCModQ": hc.M_C_MOD_Q, "kMBhatInv": hc.M_BHAT_INV,
        "kMBhatModQ": hc.M_BHAT_MOD_Q, "kMBhatModMr": hc.M_BHAT_MOD_MR,
        "kMBModQ": hc.M_B_MOD_Q, "kMBinvMr": hc.M_BINV_MR, "kMWords": hc.M_WORDS,
    }
    assert {k: consts.get(k) for k in want} == want
    assert re.search(r"constexpr int kRescale = 1, kExtend = 2, kCorrect = 4;", src)
    assert re.search(r"constexpr int kScale = 1, kExact = 2;", src)
    assert hc.T_WORDS == 3 * (hc.MAX_Q + hc.MAX_AUX)


# ---- the tables hold the converters' constants ---------------------------

def _pair(tab, off, i):
    return int(tab[off + 2 * i]), int(tab[off + 2 * i + 1])


def _np_pair(pair, idx):
    return int(np.asarray(pair[0])[idx].item()), int(np.asarray(pair[1])[idx].item())


@pytest.mark.parametrize("n,L,mul", CASES)
def test_tables_hold_the_numpy_constants(n, L, mul):
    q = _q(n, L)
    if mul < L:
        rs = RNSRescale(q, L - mul)
        tab = hc.rescale_table(rs)
        assert tab.dtype == np.uint32 and tab.size == hc.R_WORDS
        Lk, Ld = mul, L - mul
        assert list(tab[hc.R_KEEP_P:hc.R_KEEP_P + Lk]) == q[:mul]
        assert list(tab[hc.R_DROP_P:hc.R_DROP_P + Ld]) == q[mul:]
        for i in range(Ld):
            assert _pair(tab, hc.R_QDHAT_INV, i) == _np_pair(rs.qdhat_inv, (i, 0))
            for j in range(Lk):
                assert _pair(tab, hc.R_QDHAT_MOD_K, i * hc.MAX_Q + j) == \
                    _np_pair(rs.qdhat_mod_k, (i, j, 0))
        for j in range(Lk):
            assert _pair(tab, hc.R_QD_MOD_K, j) == _np_pair(rs.qd_mod_k, (j, 0))
            assert _pair(tab, hc.R_QDINV_MOD_K, j) == _np_pair(rs.qdinv_mod_k, (j, 0))
        inv = tab[hc.R_INV_DROP:hc.R_INV_DROP + 2 * Ld].view(np.float64)
        np.testing.assert_array_equal(inv, rs._inv_drop_np.ravel())
    mc = BFVMulConverter(q[:mul], T32, n)
    ext, K = mc.q_to_aux, mc.K
    etab, mtab = hc.extension_table(ext), hc.mul_table(mc)
    assert list(etab[hc.E_SRC_P:hc.E_SRC_P + mul]) == q[:mul]
    assert list(etab[hc.E_DST_P:hc.E_DST_P + K + 1]) == list(mc.aux_primes)
    for i in range(mul):
        assert _pair(etab, hc.E_QHAT_INV, i) == _np_pair(ext.qhat_inv, (i, 0))
        for j in range(K + 1):
            assert _pair(etab, hc.E_QHAT_MOD_B, i * hc.MAX_AUX + j) == \
                _np_pair(ext.qhat_mod_b, (i, j, 0))
        assert _pair(mtab, hc.M_T_Q, i) == _np_pair(mc.t_q, (i, 0))
        assert int(mtab[hc.M_C_MOD_Q + i]) == int(mc.c_mod_q[i, 0])
        assert _pair(mtab, hc.M_B_MOD_Q, i) == _np_pair(mc.B_mod_q, (i, 0))
    np.testing.assert_array_equal(etab[hc.E_INV_SRC:hc.E_INV_SRC + 2 * mul].view(np.float64),
                                  ext._inv_src_np.ravel())
    for j in range(K + 1):
        assert _pair(etab, hc.E_Q_MOD_B, j) == _np_pair(ext.q_mod_b, (j, 0))
        assert _pair(mtab, hc.M_T_AUX, j) == _np_pair(mc.t_aux, (j, 0))
        assert _pair(mtab, hc.M_QINV_AUX, j) == _np_pair(mc.qinv_aux, (j, 0))
        assert int(mtab[hc.M_C_MOD_AUX + j]) == int(mc.c_mod_aux[j, 0])
    for k in range(K):
        assert _pair(mtab, hc.M_BHAT_INV, k) == _np_pair(mc.bhat_inv, (k, 0))
        assert _pair(mtab, hc.M_BHAT_MOD_MR, k) == _np_pair(mc.bhat_mod_mr, (k,))
        for i in range(mul):
            assert _pair(mtab, hc.M_BHAT_MOD_Q, k * hc.MAX_Q + i) == \
                _np_pair(mc.bhat_mod_q, (k, i, 0))
    assert _pair(mtab, hc.M_BINV_MR, 0) == (int(mc.Binv_mr[0]), int(mc.Binv_mr[1]))
    ttab = hc.tensor_table(mc)
    primes = q[:mul] + list(mc.aux_primes)
    for l, p in enumerate(primes):
        assert tuple(int(v) for v in ttab[3 * l:3 * l + 3]) == (p, *mont_constants(p))
    # the context's Montgomery constants are the tensor table's
    from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
    for plan, ps, off in ((NTTPlan(n, q[:mul]), q[:mul], 0),
                          (mc.plan_aux, mc.aux_primes, mul)):
        for l in range(len(ps)):
            assert int(plan.pinv_arr[l, 0]) == int(ttab[3 * (off + l) + 1])
            assert int(plan.r2_arr[l, 0]) == int(ttab[3 * (off + l) + 2])


# ---- a NumPy mirror of the kernels, from the tables alone -----------------

def _u64(x):
    return np.asarray(x).astype(np.int64).astype(np.uint64)


def _shoup(x, tab, off, i, p):
    w, wq = (np.uint64(v) for v in _pair(tab, off, i))
    q = (x * wq) >> np.uint64(32)
    r = (x * w - q * np.uint64(p)) & M32
    return np.where(r >= p, r - np.uint64(p), r)


def _add(a, b, p):
    s = a + b
    return np.where(s >= p, s - np.uint64(p), s)


def _sub(a, b, p):
    return np.where(a >= b, a - b, a + np.uint64(p) - b)


def _mont(a, b, p, pinv):
    x = a * b
    lo = x & M32
    m = (lo * np.uint64(pinv)) & M32
    t = (x >> np.uint64(32)) + ((m * np.uint64(p)) >> np.uint64(32)) + (lo != 0)
    return np.where(t >= p, t - np.uint64(p), t)


def mirror_rescale_extend(x, rtab, etab, L, Lk, KA, flags):
    """rescale_extend_kernel on x (rows, L, N) uint64: (keep, aux)."""
    keep = aux = None
    if flags & hc.RESCALE:
        Ld = L - Lk
        yd, s = [], np.zeros(x.shape[0::2])
        for i in range(Ld):
            yd.append(_shoup(x[:, Lk + i], rtab, hc.R_QDHAT_INV, i, rtab[hc.R_DROP_P + i]))
            inv = rtab[hc.R_INV_DROP:hc.R_INV_DROP + 2 * Ld].view(np.float64)[i]
            s = s + yd[i].astype(np.float64) * inv
        fl = np.floor(s)
        corr = fl.astype(np.uint64) + ((s - fl) > 0.5)
        v = []
        for j in range(Lk):
            p = rtab[hc.R_KEEP_P + j]
            acc = np.zeros_like(x[:, 0])
            for i in range(Ld):
                acc = _add(acc, _shoup(yd[i], rtab, hc.R_QDHAT_MOD_K, i * hc.MAX_Q + j, p), p)
            rc = _sub(acc, _shoup(corr, rtab, hc.R_QD_MOD_K, j, p), p)
            v.append(_shoup(_sub(x[:, j], rc, p), rtab, hc.R_QDINV_MOD_K, j, p))
        keep = np.stack(v, axis=1)
        src = Lk
    else:
        v, src = [x[:, i] for i in range(L)], L
    if flags & hc.EXTEND:
        y, s = [], np.zeros(x.shape[0::2])
        inv = etab[hc.E_INV_SRC:hc.E_INV_SRC + 2 * src].view(np.float64)
        for i in range(src):
            y.append(_shoup(v[i], etab, hc.E_QHAT_INV, i, etab[hc.E_SRC_P + i]))
            s = s + y[i].astype(np.float64) * inv[i]
        over = np.rint(s).astype(np.uint64)
        outs = []
        for j in range(KA):
            b = etab[hc.E_DST_P + j]
            acc = np.zeros_like(x[:, 0])
            for i in range(src):
                acc = _add(acc, _shoup(y[i], etab, hc.E_QHAT_MOD_B, i * hc.MAX_AUX + j, b), b)
            if flags & hc.CORRECT:
                acc = _sub(acc, _shoup(over, etab, hc.E_Q_MOD_B, j, b), b)
            outs.append(acc)
        aux = np.stack(outs, axis=1)
    return keep, aux


def mirror_scale_exact(dq, din, etab, mtab, Lq, KA, flags):
    """scale_exact_kernel on dq (rows, Lq, N), din (rows, KA, N)."""
    if flags & hc.SCALE:
        y = []
        for i in range(Lq):
            q = etab[hc.E_SRC_P + i]
            r = _shoup(dq[:, i], mtab, hc.M_T_Q, i, q)
            y.append(_shoup(r, etab, hc.E_QHAT_INV, i, q))
        yv = []
        for j in range(KA):
            b = etab[hc.E_DST_P + j]
            r_aux = np.zeros_like(din[:, 0])
            for i in range(Lq):
                r_aux = _add(r_aux, _shoup(y[i], etab, hc.E_QHAT_MOD_B, i * hc.MAX_AUX + j, b), b)
            td = _shoup(din[:, j], mtab, hc.M_T_AUX, j, b)
            yv.append(_shoup(_sub(td, r_aux, b), mtab, hc.M_QINV_AUX, j, b))
    else:
        yv = [din[:, j] for j in range(KA)]
    if not flags & hc.EXACT:
        return np.stack(yv, axis=1)
    K = KA - 1
    mr = etab[hc.E_DST_P + K]
    z = []
    for k in range(K + 1):
        b = etab[hc.E_DST_P + k]
        yp = _add(yv[k], np.uint64(mtab[hc.M_C_MOD_AUX + k]), b)
        if k < K:
            z.append(_shoup(yp, mtab, hc.M_BHAT_INV, k, b))
        else:
            y_mr = yp
    s_mr = np.zeros_like(din[:, 0])
    for k in range(K):
        s_mr = _add(s_mr, _shoup(z[k], mtab, hc.M_BHAT_MOD_MR, k, mr), mr)
    u = _shoup(_sub(s_mr, y_mr, mr), mtab, hc.M_BINV_MR, 0, mr)
    out = []
    for i in range(Lq):
        q = etab[hc.E_SRC_P + i]
        acc = np.zeros_like(din[:, 0])
        for k in range(K):
            acc = _add(acc, _shoup(z[k], mtab, hc.M_BHAT_MOD_Q, k * hc.MAX_Q + i, q), q)
        acc = _sub(acc, _shoup(u, mtab, hc.M_B_MOD_Q, i, q), q)
        out.append(_sub(acc, np.uint64(mtab[hc.M_C_MOD_Q + i]), q))
    return np.stack(out, axis=1)


def mirror_tensor(a, b, ttab, off):
    """tensor_kernel's one side: a, b (rows, 2, Ls, N) -> (rows, 3, Ls, N)."""
    out = np.zeros((a.shape[0], 3) + a.shape[2:], np.uint64)
    for l in range(a.shape[2]):
        p, pinv, r2 = (int(v) for v in ttab[3 * (off + l):3 * (off + l) + 3])
        a0, a1 = a[:, 0, l], a[:, 1, l]
        b0m, b1m = _mont(b[:, 0, l], r2, p, pinv), _mont(b[:, 1, l], r2, p, pinv)
        d0, d2 = _mont(a0, b0m, p, pinv), _mont(a1, b1m, p, pinv)
        mid = _mont(_add(a0, a1, p), _add(b0m, b1m, p), p, pinv)
        out[:, 0, l], out[:, 1, l], out[:, 2, l] = d0, _sub(_sub(mid, d0, p), d2, p), d2
    return out


def _eq(mirror, plain):
    np.testing.assert_array_equal(mirror.astype(np.int64), plain.numpy().astype(np.int64))


@pytest.mark.parametrize("n,L,mul", CASES)
@pytest.mark.parametrize("inputs", ["random", "boundary"])
def test_rescale_extend_mirror_equals_plain(n, L, mul, inputs):
    q = _q(n, L)
    if inputs == "random":
        x = _res((7, L, n), q, seed=L * n + mul)
    else:
        x = torch.cat([_crt_rows(_boundary(q[mul:] if mul < L else q), q),
                       _crt_rows(_boundary(q[:mul]), q)], dim=0)
    mc = BFVMulConverter(q[:mul], T32, n)
    etab, KA = hc.extension_table(mc.q_to_aux), mc.K + 1
    if mul < L:
        rs = RNSRescale(q, L - mul)
        rtab = hc.rescale_table(rs)
        keep, aux = mirror_rescale_extend(_u64(x), rtab, etab, L, mul, KA,
                                          hc.RESCALE | hc.EXTEND | hc.CORRECT)
        want_keep, want_aux = rs.rescale_extend(x, mc.q_to_aux)
        _eq(keep, want_keep)
        _eq(aux, want_aux)
        _eq(mirror_rescale_extend(_u64(x), rtab, None, L, mul, 0, hc.RESCALE)[0],
            rs.rescale(x))
    x = want_keep if inputs == "random" and mul < L else x[:, :mul].contiguous()
    for corr in (True, False):
        flags = hc.EXTEND | (hc.CORRECT if corr else 0)
        _eq(mirror_rescale_extend(_u64(x), None, etab, mul, 0, KA, flags)[1],
            mc.extend_q_to_aux(x, correction=corr))


@pytest.mark.parametrize("n,L,mul", CASES)
def test_scale_exact_and_tensor_mirrors_equal_plain(n, L, mul):
    q = _q(n, L)[:mul]
    mc = BFVMulConverter(q, T32, n)
    aux, KA = list(mc.aux_primes), mc.K + 1
    etab, mtab, ttab = (hc.extension_table(mc.q_to_aux), hc.mul_table(mc),
                        hc.tensor_table(mc))
    d_q, d_aux = _res((2, 3, mul, n), q, seed=n + 1), _res((2, 3, KA, n), aux, seed=n + 2)
    rows = lambda t: _u64(t.reshape(-1, *t.shape[-2:]))  # noqa: E731
    y = mc.scale_round(d_q, d_aux)
    _eq(mirror_scale_exact(rows(d_q), rows(d_aux), etab, mtab, mul, KA, hc.SCALE),
        y.reshape(-1, KA, n))
    _eq(mirror_scale_exact(None, rows(y), etab, mtab, mul, KA, hc.EXACT),
        mc.exact_to_q(y).reshape(-1, mul, n))
    _eq(mirror_scale_exact(rows(d_q), rows(d_aux), etab, mtab, mul, KA, hc.SCALE | hc.EXACT),
        mc.scale_round_to_q(d_q, d_aux).reshape(-1, mul, n))
    # the tensor products: NTT-domain residues of two ciphertexts a side
    a, b = _res((4, 2, mul, n), q, seed=n + 3), _res((4, 2, mul, n), q, seed=n + 4)
    ea, eb = _res((4, 2, KA, n), aux, seed=n + 5), _res((4, 2, KA, n), aux, seed=n + 6)
    for (u, v, ps, off) in ((a, b, q, 0), (ea, eb, aux, mul)):
        p = torch.tensor(ps, dtype=torch.int64).reshape(-1, 1)
        pinv = torch.tensor([mont_constants(x)[0] for x in ps]).reshape(-1, 1)
        r2 = torch.tensor([mont_constants(x)[1] for x in ps]).reshape(-1, 1)
        _eq(mirror_tensor(_u64(u), _u64(v), ttab, off), tensor_product(u, v, p, pinv, r2))


# ---- refusals and the CPU path ------------------------------------------

def _conv(n=64, L=6, mul=5):
    q = _q(n, L)
    return q, RNSRescale(q, L - mul), BFVMulConverter(q[:mul], T32, n)


def test_wrapper_refuses_what_the_kernels_cannot_take():
    q, rs, mc = _conv()
    x = _res((2, 6, 64), q, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        hc.rescale_extend(x, rs, mc.q_to_aux)
    with pytest.raises(TypeError, match="int32"):
        hc.rescale_extend(x.long(), rs)
    with pytest.raises(ValueError, match="contiguous"):
        hc.rescale_extend(x.transpose(0, 2).contiguous().transpose(0, 2), rs)
    with pytest.raises(ValueError, match="1 to 16"):
        hc.rescale_extend(torch.zeros((1, 17, 64), dtype=torch.int32), extension=mc.q_to_aux)
    with pytest.raises(ValueError, match="needs"):
        hc.rescale_extend(x)
    d_q = _res((3, 5, 64), q[:5], seed=2)
    d_aux = _res((3, mc.K + 1, 64), mc.aux_primes, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        hc.scale_exact(d_q, d_aux, mc)
    with pytest.raises(TypeError, match="int32"):
        hc.scale_exact(d_q, d_aux.long(), mc)
    KA = mc.K + 1
    with pytest.raises(ValueError, match=rf"not \(\.\.\., {KA}, N\)"):
        hc.scale_exact(None, d_aux[:, :KA - 1].contiguous(), mc, scale=False)
    with pytest.raises(ValueError, match="CUDA"):
        hc.tensor_products(d_q[:2, None].expand(2, 2, 5, 64).contiguous(),
                           d_q[:2, None].expand(2, 2, 5, 64).contiguous(),
                           d_aux[:2, None].expand(2, 2, KA, 64).contiguous(),
                           d_aux[:2, None].expand(2, 2, KA, 64).contiguous(), mc)


def test_cpu_path_launches_nothing():
    q, rs, mc = _conv()
    x = _res((2, 6, 64), q, seed=4)
    before = hc.launches
    keep, aux = rs.rescale_extend(x, mc.q_to_aux)
    mc.scale_round_to_q(keep[:, :5], aux)
    rs.rescale(x)
    assert hc.launches == before
