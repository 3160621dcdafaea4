"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
run them on a GPU machine with README's recipe (``python -m pytest
--noconftest -m gpu ...``).

K1 (ops/ntt_cuda.py), K2 (ops/pie_kernels.py) and K3 (ops/ntt_mxu.py) must
equal their plain versions bit for bit (integer residues: exact equality),
and K3 must equal K1. The on-device decrypt must give the host decrypt's
zero mask, and the decrypt kernel (BFV and BGV results) its plain
version's; ``mod_switch`` and ``automorphism`` on the card must equal the
port on the CPU, the streamed protocol, the host-resident table,
``--bgv`` and SimpleFHE must verify on the card, and so must the
reference's three golden tests at ring 16384 (``torch_golden_cases``).
The protocols also run at ring 16384 through the user entry points (the
cells' 2^20 x 2048 row among them), and the server's artifact resumes in a
fresh process that cannot import jax, the JAX package or cryptography.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, ntt_mxu, pie_kernels
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _residues(shape, ps, seed):
    """Random residues (..., L, N) below each limb's prime, int32."""
    rng = np.random.default_rng(seed)
    p = np.array(ps, np.int64).reshape(len(ps), 1)
    return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))


def _bases(n):
    """The main path's two NTT bases at ring n: the L = 6 q base and the
    HPS aux base of the mul_limbs context."""
    q = ntt_primes(6, 31, 2 * n, avoid=(T32,))
    mul = bfv_mul_limbs(T32.bit_length(), 6, 1, ring_dim=n)
    return {"q": q, "aux": BFVMulConverter(q[:mul], T32, n).aux_primes}


@pytest.mark.parametrize("n", [1024, 16384, 32768])
@pytest.mark.parametrize("base", ["q", "aux"])
def test_ntt_kernel_matches_plain(cuda, n, base):
    ps = _bases(n)[base]
    plan = NTTPlan(n, ps)
    x = _residues((3, len(ps), n), ps, seed=n)
    want = ntt(x, plan)
    got = ntt_cuda.ntt(x.to(cuda), plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    back = ntt_cuda.intt(got, plan)
    torch.cuda.synchronize()
    assert torch.equal(back.cpu(), intt(want, plan))
    assert torch.equal(back.cpu(), x)


# The nine K1 launches of one server query at ring 16384 (L = 6, mul_limbs
# 5, ship_limbs 4, 8 aux limbs, D = 12): (inverse, leading shape, basis).
MAIN_PATH_K1 = [
    (True, (2, 12, 2), "q6"), (False, (2, 12, 2), "q5"), (False, (2, 12, 2), "aux"),
    (True, (12, 3), "q5"), (True, (12, 3), "aux"), (False, (12, 2), "q5"),
    (False, (12, 5), "q5"), (True, (12, 2), "q5"), (False, (12, 2), "q4"),
]
# the form chosen from n, and each form forced
MODES = {"auto": None, "whole_row": ntt_cuda.WHOLE_ROW, "split": ntt_cuda.SPLIT}


def _basis(name, n):
    q = _bases(n)
    return {"q6": q["q"], "q5": q["q"][:5], "q4": q["q"][:4], "aux": q["aux"]}[name]


def _check_kernel(x, plan, mode, cuda):
    """Forward and inverse through the kernel in the given form: equal to
    the plain version, and the inverse undoes the forward."""
    xc = x.to(cuda)
    fwd = ntt_cuda._launch(xc, plan, inverse=False, form=mode)
    inv = ntt_cuda._launch(xc, plan, inverse=True, form=mode)
    back = ntt_cuda._launch(fwd, plan, inverse=True, form=mode)
    torch.cuda.synchronize()
    assert torch.equal(fwd.cpu(), ntt(x, plan))
    assert torch.equal(inv.cpu(), intt(x, plan))
    assert torch.equal(back.cpu(), x)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("launch_no", range(1, 10))
def test_ntt_kernel_main_path_shapes(cuda, launch_no, mode):
    _, lead, basis = MAIN_PATH_K1[launch_no - 1]
    ps = _basis(basis, 16384)
    plan = NTTPlan(16384, ps)
    _check_kernel(_residues((*lead, len(ps), 16384), ps, seed=launch_no), plan, MODES[mode], cuda)


@pytest.mark.parametrize("logn", range(4, 16))
def test_ntt_kernel_every_ring_size(cuda, logn):
    n = 1 << logn
    ps = ntt_primes(3, 31, 2 * n)
    plan = NTTPlan(n, ps)
    x = _residues((5, 3, n), ps, seed=logn)
    for mode in ("whole_row", "split") if n >= 1024 else ("whole_row",):
        _check_kernel(x, plan, MODES[mode], cuda)
    if n < 1024:
        with pytest.raises(RuntimeError):
            ntt_cuda._launch(x.to(cuda), plan, inverse=False, form=ntt_cuda.SPLIT)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rows,L", [(1, 1), (7, 1), (133, 7), (397, 1),
                                    (108, 9), (972, 9), (64, 8), (1024, 8)])
def test_ntt_kernel_ragged_row_counts(cuda, rows, L, mode):
    """Row counts that divide neither the card's SMs nor the split form's
    eight chunks per block; and the other paths' transforms at ring 16384:
    flat --bgv's relinearisation (12 rows of 9 limbs, then its 12 x 9 digits)
    and the scaling report's across processes (D = 8 rows of 8 limbs, then
    16 x 8 digits)."""
    ps = ntt_primes(L, 31, 2 * 16384, avoid=(T32,))
    plan = NTTPlan(16384, ps)
    _check_kernel(_residues((rows // L, L, 16384), ps, seed=rows), plan, MODES[mode], cuda)


def test_ntt_kernel_unaligned_input(cuda):
    """A view that starts 4 bytes into its storage goes through a copy."""
    ps = ntt_primes(2, 31, 2 * 1024)
    plan = NTTPlan(1024, ps)
    x = _residues((3, 2, 1024), ps, seed=3)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), x.reshape(-1)]).to(cuda)
    view = flat[1:].view(3, 2, 1024)
    assert view.data_ptr() % 16 != 0
    got = ntt_cuda.ntt(view, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ntt(x, plan))


def test_ntt_kernel_small_ring_and_launch_count(cuda):
    ps = ntt_primes(2, 31, 2 * 16)
    plan = NTTPlan(16, ps)
    x = _residues((2, 16), ps, seed=1)
    before = dict(ntt_cuda.launches)
    got = ntt_cuda.ntt(x.to(cuda), plan)
    assert ntt_cuda.launches == {"ntt": before["ntt"] + 1, "intt": before["intt"]}
    assert torch.equal(got.cpu(), ntt(x, plan))


def test_ntt_kernel_split_form_counts_two_launches(cuda):
    """From n = 1024 up the kernel runs in the split form: two kernel
    launches, each counted."""
    rows = 3
    ps = ntt_primes(1, 31, 2 * 1024)
    plan = NTTPlan(1024, ps)
    x = _residues((rows, 1, 1024), ps, seed=5)
    before = dict(ntt_cuda.launches)
    got = ntt_cuda.intt(x.to(cuda), plan)
    assert ntt_cuda.launches == {"ntt": before["ntt"], "intt": before["intt"] + 2}
    assert torch.equal(got.cpu(), intt(x, plan))


@pytest.mark.parametrize("D,P", [(12, 12), (48, 48)], ids=["2p20_row", "north_star"])
def test_pie_kernel_matches_plain_main_geometry(cuda, D, P):
    """The BFV cells' tables, (2, 12, 12, 6, 16384) and the north star's
    (2, 48, 48, 6, 16384); the plain version runs in slices of 4 depths
    (its int64 products over the whole north-star table would take tens
    of GB)."""
    H, L, N = 2, 6, 16384
    ps = ntt_primes(L, 31, 2 * N, avoid=(T32,))
    plan = NTTPlan(N, ps)
    tb = plan.tensors(cuda)
    gen = torch.Generator(device=cuda).manual_seed(D)
    idx = torch.randint(0, min(ps), (H, P, 2, L, N), generator=gen, device=cuda,
                        dtype=torch.int32)
    pt = torch.randint(0, min(ps), (H, D, P, L, N), generator=gen, device=cuda,
                       dtype=torch.int32)
    before = pie_kernels.launches
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
    torch.cuda.synchronize()
    assert pie_kernels.launches == before + 1
    for d0 in range(0, D, 4):
        want = pie_kernels.indexed_inner_product_plain(idx, pt[:, d0:d0 + 4], tb["p"], tb["pinv"])
        assert torch.equal(got[:, d0:d0 + 4], want), d0


def _mxu_launches_per_call(n):
    """K3 runs both stages in one launch up to n = 16384, one per stage above."""
    return 1 if n <= ntt_mxu.FUSED_MAX_N else 2


@pytest.mark.parametrize("n", [1 << k for k in range(8, 16)])
@pytest.mark.parametrize("base", ["q", "aux"])
def test_ntt_mxu_kernel_matches_plain_and_k1(cuda, n, base):
    ps = _bases(n)[base]
    plan, mp = NTTPlan(n, ps), ntt_mxu.MxuNTTPlan(n, ps)
    x = _residues((3, len(ps), n), ps, seed=n + 1).to(cuda)
    before = dict(ntt_mxu.launches)
    got = ntt_mxu.ntt_mxu(x, mp)
    torch.cuda.synchronize()
    assert ntt_mxu.launches["ntt"] == before["ntt"] + _mxu_launches_per_call(n)
    assert torch.equal(got, ntt_mxu.ntt_mxu_plain(x, mp))
    k1 = ntt_cuda.ntt(x, plan)
    assert torch.equal(got, k1)
    back = ntt_mxu.intt_mxu(k1, mp)
    torch.cuda.synchronize()
    assert ntt_mxu.launches["intt"] == before["intt"] + _mxu_launches_per_call(n)
    assert torch.equal(back, ntt_mxu.intt_mxu_plain(k1, mp))
    assert torch.equal(back, ntt_cuda.intt(k1, plan)) and torch.equal(back, x)


@pytest.mark.parametrize("L", [6, 8])
@pytest.mark.parametrize("per_prime", [1, 7, 133, 397])
def test_ntt_mxu_kernel_ragged_row_counts(cuda, per_prime, L):
    """Rows per prime that are no multiple of the 4-row cluster: the CTAs
    without a row join the cluster's barriers and write nothing."""
    n = 16384
    ps = ntt_primes(L, 31, 2 * n, avoid=(T32,))
    plan, mp = NTTPlan(n, ps), ntt_mxu.MxuNTTPlan(n, ps)
    x = _residues((per_prime, L, n), ps, seed=per_prime + L).to(cuda)
    got = ntt_mxu.ntt_mxu(x, mp)
    want = ntt_cuda.ntt(x, plan)
    back = ntt_mxu.intt_mxu(want, mp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(back, x)


@pytest.mark.parametrize("n", [16384, 32768])
def test_ntt_mxu_kernel_unaligned_input(cuda, n):
    """A view that starts 4 bytes into its storage goes through a copy."""
    ps = ntt_primes(2, 31, 2 * n)
    mp = ntt_mxu.MxuNTTPlan(n, ps)
    x = _residues((3, 2, n), ps, seed=7)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), x.reshape(-1)]).to(cuda)
    view = flat[1:].view(3, 2, n)
    assert view.data_ptr() % 16 != 0
    got = ntt_mxu.ntt_mxu(view, mp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ntt_mxu.ntt_mxu_plain(x, mp))


@pytest.mark.parametrize("n", [16384, 32768])
def test_ntt_mxu_launch_count(cuda, n):
    """The fused form (both stages in one launch) counts one launch, the
    two-launch form above n = 16384 two; a CPU call counts none."""
    ps = ntt_primes(1, 31, 2 * n)
    mp = ntt_mxu.MxuNTTPlan(n, ps)
    x = _residues((2, 1, n), ps, seed=11)
    ntt_mxu.reset_launches()
    ntt_mxu.ntt_mxu(x, mp)
    assert ntt_mxu.launches == {"ntt": 0, "intt": 0}
    y = ntt_mxu.ntt_mxu(x.to(cuda), mp)
    ntt_mxu.intt_mxu(y, mp)
    torch.cuda.synchronize()
    k = 1 if n == 16384 else 2
    assert ntt_mxu.launches == {"ntt": k, "intt": k}


def test_ntt_mxu_kernel_rejects_small_tiles(cuda):
    """n = 128 splits as 16 x 8: m2 is not a multiple of 16."""
    ps = ntt_primes(2, 31, 2 * 128)
    mp = ntt_mxu.MxuNTTPlan(128, ps)
    with pytest.raises(ValueError, match="multiples"):
        ntt_mxu.ntt_mxu(torch.zeros((2, 128), dtype=torch.int32, device=cuda), mp)


def test_pie_kernel_slice_matches_plain(cuda):
    H, D, P, L, N = 2, 12, 12, 6, 16384
    ps = ntt_primes(L, 31, 2 * N, avoid=(T32,))
    tb = NTTPlan(N, ps).tensors(cuda)
    idx = _residues((H, 3, 2, L, N), ps, seed=4).to(cuda)
    pt = _residues((H, D, P, L, N), ps, seed=5).to(cuda)
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"], p0=3)
    torch.cuda.synchronize()
    want = pie_kernels.indexed_inner_product_plain(idx, pt[:, :, 3:6].contiguous(), tb["p"], tb["pinv"])
    assert torch.equal(got, want)


def test_device_decrypt_matches_host_decrypt(cuda):
    """Ring 16384 on the L' = 4 child basis: the device zero mask and slots
    against the host decrypt of the same ciphertexts."""
    from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
    from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams

    ctx = make_context(SchemeParams(ring_dim=16384, plaintext_modulus=T32, num_limbs=6,
                                    scheme="bfv"), seed=3, device=cuda)
    sk, _ = ctx.keygen()
    sctx, ssk = ctx.context_for_limbs(4), ctx.shrink_key_to(sk, 4)
    vals = np.random.default_rng(7).integers(0, 1 << 32, size=(3, 16384)).astype(object)
    vals[:, ::5] = 0
    ct = sctx.encrypt_sk(sctx.make_plaintext_rns(vals), ssk)
    dec = DeviceDecryptor(sctx)
    mask = dec.zero_mask(ct.data, ssk.s_mont, length=4096)
    host, _ = sctx.decrypt(ct, ssk, length=4096)
    np.testing.assert_array_equal(mask.cpu().numpy(), np.asarray(host, dtype=object) == 0)
    slots = dec.slots(ct.data, ssk.s_mont).cpu().numpy().astype(object)
    np.testing.assert_array_equal(slots, vals)


# ---- the client's decrypt kernel (csrc/decrypt.cu, ops/decrypt_cuda.py) ----

def _decrypt_case(cuda, form, t, n, L, rows, seed, ship=None):
    """A context on the card (on ``ship`` limbs of an L-limb one), its key,
    an encryption of seeded slot values (every fifth slot 0) and the
    values."""
    from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams

    ctx = make_context(SchemeParams(ring_dim=n, plaintext_modulus=t, num_limbs=L,
                                    scheme=form), seed=seed, device=cuda)
    sk, _ = ctx.keygen()
    if ship is not None:
        ctx, sk = ctx.context_for_limbs(ship), ctx.shrink_key_to(sk, ship)
    vals = np.random.default_rng(seed).integers(0, min(t, 1 << 60), size=(rows, n))
    vals = vals.astype(object) % t
    vals[:, ::5] = 0
    return ctx, sk, ctx.encrypt_sk(ctx.make_plaintext_rns(vals), sk), vals


def _check_decrypt_kernel(ctx, sk, ct, vals, length):
    """One launch; the kernel's mask equals the plain version's (the same
    decryptor's two-plane arithmetic, on the card) and the host decrypt's,
    bit for bit. -> the decryptor and its phase."""
    from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    dec = DeviceDecryptor(ctx)
    before = decrypt_cuda.launches
    mask = dec.zero_mask(ct.data, sk.s_mont, length)
    assert decrypt_cuda.launches == before + 1
    lo, hi = dec._slot_planes(ct.data, sk.s_mont)
    torch.cuda.synchronize()
    assert mask.dtype == torch.bool and torch.equal(mask, ((lo == 0) & (hi == 0))[..., :length])
    host, _ = ctx.decrypt(ct, sk, length=length)
    np.testing.assert_array_equal(mask.cpu().numpy(), np.asarray(host, dtype=object) == 0)
    np.testing.assert_array_equal(mask.cpu().numpy().reshape(-1, length), vals[:, :length] == 0)
    return dec, dec._phase(ct.data, sk.s_mont)


@pytest.mark.parametrize("form,L,ship,t,lead", [
    ("bfv", 6, 4, T32, (12,)), ("bgv", 9, None, T32, (12,)), ("bgv", 6, 5, 65537, (12,)),
    ("bfv", 6, 4, T32, (4, 12)), ("bfv", 6, 4, T32, (48,)),
], ids=["bfv_12x4x16384", "bgv_12x9x16384", "leveled_bgv_12x5x16384",
        "bfv_queries4_4x12x4x16384", "north_star_48x4x16384"])
def test_decrypt_kernel_at_the_cells_shapes(cuda, form, L, ship, t, lead):
    """The cells' results: 12 rows of 16384 on BFV's 4 shipped limbs and on
    flat BGV's 9, t = 2^32+2^20+2^19+1, each row split over a cluster of 8
    blocks; the leveled --bgv result (t = 65537, 5 of 6 limbs shipped), a
    --queries 4 result (Q, D) and the north star's 48 rows; a second launch
    gives the same mask."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    rows = int(np.prod(lead))
    ctx, sk, ct, vals = _decrypt_case(cuda, form, t, 16384, L, rows, seed=L, ship=ship)
    assert tuple(ct.data.shape) == (rows, 2, ship or L, 16384) and ct.form == form
    ct.data = ct.data.reshape(*lead, *ct.data.shape[1:])
    dec, phase = _check_decrypt_kernel(ctx, sk, ct, vals, 4096)
    phase = phase.reshape(rows, *phase.shape[-2:])
    want = decrypt_cuda.zero_mask(phase, *dec.kernel_tables, form == "bgv", 4096)
    assert torch.equal(decrypt_cuda.zero_mask(phase, *dec.kernel_tables, form == "bgv", 4096),
                       want)


@pytest.mark.parametrize("n", [64, 256, 1024, 4096, 8192])
@pytest.mark.parametrize("bits", [16, 32, 40, 48], ids=["t17", "t33", "t41", "t49"])
@pytest.mark.parametrize("form", ["bfv", "bgv"])
def test_decrypt_kernel_rings_and_moduli(cuda, form, bits, n):
    """Rings 64-8192 (one block a row up to 2048, then clusters of 2 and 4)
    and the plaintext moduli of 16-48-bit items (t of 17 to 49 bits), both
    CRT fronts."""
    from nested_hashing_psi_tpu_torch.fhe.params import PLAINTEXT_MODULI

    t = PLAINTEXT_MODULI[bits]
    ctx, sk, ct, vals = _decrypt_case(cuda, form, t, n, 4, 3, seed=bits + n)
    _check_decrypt_kernel(ctx, sk, ct, vals, n // 2)


@pytest.mark.parametrize("rows", [1, 5, 13])
def test_decrypt_kernel_ragged_rows_and_unaligned_input(cuda, rows):
    """Any row count; a phase that starts one int32 past a 16-byte boundary
    is read in place (the kernel reads int32 words) and masks alike."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    ctx, sk, ct, vals = _decrypt_case(cuda, "bgv", T32, 1024, 3, rows, seed=rows)
    dec, phase = _check_decrypt_kernel(ctx, sk, ct, vals, 1000)
    buf = torch.empty(phase.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(phase.shape)
    shifted.copy_(phase)
    assert shifted.data_ptr() % 16 != 0
    want = decrypt_cuda.zero_mask(phase, *dec.kernel_tables, True, 1000)
    assert torch.equal(decrypt_cuda.zero_mask(shifted, *dec.kernel_tables, True, 1000), want)


def test_decrypt_kernel_refusals_raise(cuda):
    """What the wrapper does not take raises before any launch."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    ctx, sk, ct, vals = _decrypt_case(cuda, "bfv", T32, 256, 3, 2, seed=1)
    dec, phase = _check_decrypt_kernel(ctx, sk, ct, vals, 256)
    tb, before = dec.kernel_tables, decrypt_cuda.launches
    with pytest.raises(ValueError):
        decrypt_cuda.zero_mask(phase.cpu(), *tb, False, 256)
    with pytest.raises(TypeError):
        decrypt_cuda.zero_mask(phase.long(), *tb, False, 256)
    with pytest.raises(ValueError):  # L does not fit the tables
        decrypt_cuda.zero_mask(phase[:, :2].contiguous(), *tb, False, 256)
    with pytest.raises(ValueError):  # n not a power of two
        decrypt_cuda.zero_mask(phase[..., :96].contiguous(), tb[0], tb[1][:192], tb[2][:96],
                               False, 96)
    with pytest.raises(ValueError):
        decrypt_cuda.zero_mask(phase, *tb, False, 257)
    assert decrypt_cuda.launches == before


def test_decrypt_kernel_no_rows_or_slots_launch_nothing(cuda):
    """No rows or no slots: an empty mask, and ``launches`` stays."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    ctx, sk, ct, vals = _decrypt_case(cuda, "bgv", T32, 256, 3, 2, seed=2)
    dec, phase = _check_decrypt_kernel(ctx, sk, ct, vals, 256)
    before = decrypt_cuda.launches
    got = decrypt_cuda.zero_mask(phase, *dec.kernel_tables, True, 0)
    assert got.shape == (2, 0) and got.is_cuda
    got = decrypt_cuda.zero_mask(phase[:0], *dec.kernel_tables, True, 256)
    assert got.shape == (0, 256)
    assert dec.zero_mask(ct.data, sk.s_mont, 0).shape == (2, 0)
    assert decrypt_cuda.launches == before


def test_bgv_client_exchange_decrypts_through_the_kernel(cuda):
    """A --bgv client on the card: its exchange opens ``decrypt.device`` and
    none of the host decrypt's spans, launches the decrypt kernel once per
    result, keeps its decryptor by (form, limbs) and finds the intersection."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process
    from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

    psi, ht = _small_protocol(bgv=True, num_limbs=None)
    decrypt_cuda.reset_launches()
    TRACER.clear()
    TRACER.enable()
    try:
        client, server, ok = run_in_process(psi, ht, device="cuda")
    finally:
        TRACER.disable()
    names = [s.name for s in TRACER.between(0, 2**63)]
    TRACER.clear()
    assert ok and len(client.intersection_calculated) == 5
    assert names.count("decrypt.device") == decrypt_cuda.launches >= 1
    assert not {"decrypt.crt", "decrypt.download", "decrypt.phase"} & set(names)
    assert client.noise_bits is None and list(client._decryptors)[0][0] == "bgv"


def _small_protocol(**over):
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams

    kw = dict(server_set_size=300, client_set_size=12, intersection_set_size=5,
              bit_size=32, fhe=True, batched=True, ring_dim=128, num_limbs=10)
    kw.update(over)
    ht = HashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=4)
    return PSIParams(**kw), ht


def test_streamed_protocol_on_cuda(cuda):
    """--streamChunks 4 on the card: one K2 launch per chunk, the client
    decrypts on the device, and the run verifies."""
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi, ht = _small_protocol(stream_chunks=4)
    pie_kernels.reset_launches()
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == 5
    assert pie_kernels.launches == 4
    assert client.noise_bits is None and client._decryptors


# The cells' frames at ring 16384: index ciphertexts (H, P, 2, L, N), the
# minus ciphertext (2, L, N) and the result (D, 2, shipped limbs, N) of BFV
# 2^20 (L = 6, 4 shipped), flat BGV 2^20 (L = 9) and the north star (D = P = 48).
CELL_FRAMES = {
    "bfv_index": (2, 12, 2, 6, 16384), "bgv_index": (2, 12, 2, 9, 16384),
    "north_star_index": (2, 48, 2, 6, 16384), "bfv_minus": (2, 6, 16384),
    "bgv_minus": (2, 9, 16384), "bfv_result": (12, 2, 4, 16384),
    "bgv_result": (12, 2, 9, 16384), "north_star_result": (48, 2, 4, 16384),
}


@pytest.mark.parametrize("name", list(CELL_FRAMES))
def test_cuda_frames_cross_without_host_copies(cuda, name):
    """A CUDA tensor's frame at the cells' shapes over the loopback: written
    in place in page-locked memory, carried as it is, uploaded from it. The
    round trips are bit-equal, each frame's bytes are ``tensor_to_bytes`` of
    the downloaded array, every span counts no host copy. Two frames written
    before either is read arrive intact; a ``non_blocking`` upload (the
    streamed chunks') held behind device work is bit-equal after a
    synchronise, though a frame of its size is downloaded on another stream
    meanwhile: a frame in flight is never reused. A streamed chunk (a
    strided slice) crosses too."""
    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel, tensor_to_bytes
    from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

    shape = CELL_FRAMES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    xs = [torch.randint(0, 2**31 - 1, shape, dtype=torch.int32, device=cuda, generator=gen)
          for _ in range(3)]
    xs.append(xs[0][:, : shape[1] // 2])
    order = [0, 1, 2, 0, 3]  # the tensors in the order they are sent
    w, r = LoopbackChannel.pair()
    frames, write = [], w.write_msg

    def recorded_write(msg):  # keeps no reference to the frame
        frames.append((type(msg), msg.base.is_pinned(), msg.ctypes.data, bytes(msg)))
        write(msg)

    w.write_msg = recorded_write
    side, held = torch.cuda.Stream(), torch.cuda.Event()
    torch.cuda._sleep(1)  # loaded before it is timed
    torch.cuda.synchronize()
    TRACER.clear()
    TRACER.enable()
    try:
        convert.send(w, xs[0])
        convert.send(w, xs[1])  # both written before either is read
        got = [convert.receive(r, cuda), convert.receive(r, cuda)]
        convert.send(w, xs[2])
        torch.cuda._sleep(1_000_000_000)  # holds the stream: the upload waits
        streamed = convert.receive(r, cuda, non_blocking=True)
        held.record()
        with torch.cuda.stream(side):
            convert.send(w, xs[0])  # a frame of the same size, meanwhile
        in_flight = not held.query()
        got += [streamed, convert.receive(r, cuda)]
        convert.send(w, xs[3])
        got.append(convert.receive(r, cuda))
        torch.cuda.synchronize()
        spans = [s for s in TRACER.spans if s.name in ("wire.pack", "wire.unpack")]
    finally:
        TRACER.disable()
        TRACER.clear()
    for g, k in zip(got, order):
        assert g.is_cuda and torch.equal(g, xs[k]), k
    for (kind, pinned, _, frame), k in zip(frames, order):
        assert kind is np.ndarray and pinned
        assert frame == tensor_to_bytes(xs[k].cpu().numpy().view(np.uint32))
    assert in_flight and frames[3][2] != frames[2][2]  # not the buffer of the upload in flight
    assert len(spans) == 10 and all(s.counts == {"host_copies": 0} for s in spans)


def test_cuda_frame_to_a_channel_that_takes_bytes(cuda):
    """A channel not derived from the port's ``Channel`` (as the JAX
    package's) takes no buffer frame: it gets bytes, one host copy, and a
    receive from it copies the payload once into page-locked memory."""
    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.protocol.channel import (
        tensor_from_bytes,
        tensor_to_bytes,
    )
    from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

    class BytesOnly:
        def __init__(self):
            self.msgs = []

        def write_tensor(self, arr):
            self.msgs.append(tensor_to_bytes(arr))

        def read_tensor(self):
            return tensor_from_bytes(self.msgs.pop(0))

    x = torch.randint(0, 2**31 - 1, CELL_FRAMES["bfv_minus"], dtype=torch.int32, device=cuda)
    ch = BytesOnly()
    TRACER.clear()
    TRACER.enable()
    try:
        convert.send(ch, x)
        assert type(ch.msgs[0]) is bytes
        assert ch.msgs[0] == tensor_to_bytes(x.cpu().numpy().view(np.uint32))
        assert torch.equal(convert.receive(ch, cuda), x)
        counts = [s.counts for s in TRACER.spans if s.name in ("wire.pack", "wire.unpack")]
    finally:
        TRACER.disable()
        TRACER.clear()
    assert counts == [{"host_copies": 1}] * 2


def test_host_table_on_cuda_matches_device_table(cuda):
    """The pinned host table with two-buffer uploads on a copy stream
    answers exactly like the device-resident table."""
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi, ht = _small_protocol()
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok
    dev = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=5)
    host = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=5,
                         host_table=True)
    assert host.table_pt.is_pinned() and torch.equal(host.table_pt.to(cuda), dev.table_pt)
    i, m = client.idx_ct, client.minus_ct
    want = dev.run(i, m).data
    for pos_chunk in (None, 1, 3, 5):
        got = host._run_host_table(i, m, pos_chunk).data
        torch.cuda.synchronize()
        assert torch.equal(got, want), pos_chunk


def test_kernel_wrappers_reject_bad_input(cuda):
    ps = ntt_primes(2, 31, 2 * 64)
    plan = NTTPlan(64, ps)
    with pytest.raises(TypeError):
        ntt_cuda.ntt(torch.zeros((2, 64), dtype=torch.int64, device=cuda), plan)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(torch.zeros((3, 64), dtype=torch.int32, device=cuda), plan)


def test_protocol_on_cuda_small_ring(cuda):
    """The whole BatchedFHE slice on the card at a small ring: it verifies,
    and it went through both kernels."""
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi = PSIParams(server_set_size=300, client_set_size=12, intersection_set_size=5,
                    bit_size=32, fhe=True, batched=True, ring_dim=128, num_limbs=10)
    ht = HashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=4)
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    client, _, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == 5
    assert min(ntt_cuda.launches.values()) > 0 and pie_kernels.launches == 1


@pytest.mark.parametrize("D,P,L,t", [
    (12, 12, 9, T32), (12, 12, 6, 65537), (12, 12, 7, T32), (12, 12, 8, T32), (12, 12, 10, T32),
    (8, 8, 8, 65537), (16, 8, 8, 65537),
], ids=["flat_bgv_L9", "leveled_L6", "L7", "L8", "L10", "multihost_D8", "multihost_D16"])
def test_pie_kernel_matches_plain_bgv_geometry(cuda, D, P, L, t):
    """K2 at the --bgv paths' limb counts: flat BGV at 32-bit items (L = 9)
    and the leveled path at 16-bit items (L = 6), the primes avoiding t;
    the limb counts between, and the scaling report's table across
    processes (L = 8, P = 8: D = 8 for each process's half, 16 whole)."""
    H, N = 2, 16384
    ps = ntt_primes(L, 31, 2 * N, avoid=(t,))
    tb = NTTPlan(N, ps).tensors(cuda)
    idx = _residues((H, P, 2, L, N), ps, seed=L).to(cuda)
    pt = _residues((H, D, P, L, N), ps, seed=L + 1).to(cuda)
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
    torch.cuda.synchronize()
    assert torch.equal(got, pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"]))


def _k2_case(H, D, P, L, N, seed, fill="random"):
    ps = ntt_primes(L, 31, 2 * 16384)
    if fill == "max":
        p = torch.tensor(ps, dtype=torch.int64).reshape(L, 1)
        return ps, (p - 1).expand(H, P, 2, L, N).int().contiguous(), \
            (p - 1).expand(H, D, P, L, N).int().contiguous()
    return ps, _residues((H, P, 2, L, N), ps, seed), _residues((H, D, P, L, N), ps, seed + 1)


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("L", [6, 9])
@pytest.mark.parametrize("P", [1, 40])
def test_pie_kernel_deferred_reduction_extremes(cuda, P, L, fill):
    """One reduction per output: P = 1 and P = 40 (sums past 2^64 when every
    residue is q - 1), H = D = 1, bit-exact with the plain version."""
    ps, idx, pt = _k2_case(1, 1, P, L, 1024, seed=P + L)
    tb = NTTPlan(1024, ps).tensors(cuda)
    idx, pt = idx.to(cuda), pt.to(cuda)
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
    torch.cuda.synchronize()
    assert torch.equal(got, pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"]))


@pytest.mark.parametrize("N", [4, 1000, 16384 + 260])
def test_pie_kernel_ragged_tile(cuda, N):
    """n not a multiple of the kernel's 256-column tile."""
    ps, idx, pt = _k2_case(2, 3, 5, 3, N, seed=N)
    tb = NTTPlan(1024, ps).tensors(cuda)
    idx, pt = idx.to(cuda), pt.to(cuda)
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
    torch.cuda.synchronize()
    assert torch.equal(got, pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"]))


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("with_acc", [False, True], ids=["sum", "acc"])
@pytest.mark.parametrize("layout", ["standard", "position_major"])
@pytest.mark.parametrize("p0,w", [(0, 12), (3, 3), (7, 5)])
def test_pie_kernel_layouts_slices_and_acc(cuda, p0, w, layout, with_acc, fill):
    """Positions [p0, p0 + w) of the (H, D, P, L, N) table or of the
    position-major (P, H, D, L, N) buffer's (H, D, P, L, N) view, read in
    place, with and without
    a running sum acc, which the kernel updates in place; the index may be a
    position slice of a wider one."""
    H, D, P, L, N = 2, 4, 12, 6, 2048
    ps, idx_full, pt = _k2_case(H, D, P, L, N, seed=p0 * 31 + w, fill=fill)
    tb = NTTPlan(2048, ps).tensors(cuda)
    idx = idx_full.to(cuda)[:, p0 : p0 + w]  # a view: not contiguous unless w = P
    table = pt.to(cuda)
    if layout == "position_major":
        table = table.permute(2, 0, 1, 3, 4).contiguous().permute(1, 2, 0, 3, 4)
    acc = None
    if with_acc:
        acc = _residues((H, D, 2, L, N), ps, seed=99).to(cuda)
        if fill == "max":
            acc = torch.full_like(acc, 0) + (tb["p"].reshape(L, 1) - 1).int()
    want = pie_kernels.indexed_inner_product_plain(
        idx, table, tb["p"], tb["pinv"], p0, None if acc is None else acc.clone())
    before = pie_kernels.launches
    got = pie_kernels.indexed_inner_product(idx, table, tb["p_u32"], tb["pinv_u32"], p0, acc)
    torch.cuda.synchronize()
    assert pie_kernels.launches == before + 1
    assert torch.equal(got, want)
    if with_acc:
        assert got.data_ptr() == acc.data_ptr()


def test_pie_kernel_refusals_raise(cuda):
    """What the kernel does not take raises: n not a multiple of 4, a table
    view that is not 16-byte aligned, and a launch the card refuses (the
    index staging for P = 200 needs more shared memory than a block has)."""
    ps = ntt_primes(1, 31, 2 * 64)
    tb = NTTPlan(64, ps).tensors(cuda)
    with pytest.raises(ValueError):
        z = torch.zeros((1, 2, 2, 1, 6), dtype=torch.int32, device=cuda)
        pie_kernels.indexed_inner_product(z, torch.zeros((1, 1, 2, 1, 6), dtype=torch.int32,
                                                         device=cuda), tb["p_u32"], tb["pinv_u32"])
    flat = torch.zeros(1 + 2 * 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pie_kernels.indexed_inner_product(
            torch.zeros((1, 2, 2, 1, 8), dtype=torch.int32, device=cuda),
            flat[1:].view(1, 1, 2, 1, 8), tb["p_u32"], tb["pinv_u32"])
    before = pie_kernels.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        pie_kernels.indexed_inner_product(
            torch.zeros((1, 200, 2, 1, 8), dtype=torch.int32, device=cuda),
            torch.zeros((1, 1, 200, 1, 8), dtype=torch.int32, device=cuda),
            tb["p_u32"], tb["pinv_u32"])
    assert pie_kernels.launches == before


@pytest.mark.parametrize("Ps", [(30, 40, 12), (40, 30, 12)], ids=["rising", "falling"])
def test_pie_kernel_shared_memory_sizes_and_persistent_grid(cuda, Ps):
    """Launches at several shared-memory sizes (60 KB, 80 KB and 24 KB of
    staged index), in either order: each size's grid is found on its first
    launch and kept, and the kernel's limit above 48 KB only rises. Each
    shape has more (h, l, tile) items than resident blocks, so every launch
    walks equal runs of (item, depth) units over the persistent grid."""
    for P in Ps:
        ps, idx, pt = _k2_case(2, 2, P, 6, 32768, seed=P)
        tb = NTTPlan(1024, ps).tensors(cuda)
        idx, pt = idx.to(cuda), pt.to(cuda)
        for _ in range(2):
            got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
            torch.cuda.synchronize()
            assert torch.equal(got, pie_kernels.indexed_inner_product_plain(
                idx, pt, tb["p"], tb["pinv"])), P
        del idx, pt, got
        torch.cuda.empty_cache()


def test_streamed_and_host_table_fold_their_adds_into_k2(cuda):
    """--streamChunks and the host-resident table: each chunk's or slice's
    K2 adds to the running sum itself, so the PIE launches one K2 per chunk
    or slice and no separate add or table transpose; the results equal the
    device table's."""
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi, ht = _small_protocol()
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok
    dev = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=5)
    host = BatchedFHEPIE(server.ctx, server.server_table, server.rlk, mask_seed=5,
                         host_table=True)
    i, m = client.idx_ct, client.minus_ct
    want = dev.run(i, m).data
    chunks = [(p0, i.data[:, p0 : p0 + 3]) for p0 in range(0, dev.P, 3)]
    for pie in (dev, host):
        pie_kernels.reset_launches()
        got = pie.run_streamed(iter(chunks), m).data
        torch.cuda.synchronize()
        assert torch.equal(got, want) and pie_kernels.launches == len(chunks)
    pie_kernels.reset_launches()
    got = host._run_host_table(i, m, 4).data
    torch.cuda.synchronize()
    assert torch.equal(got, want) and pie_kernels.launches == dev.P // 4


def _bgv_pair(cuda, n, L):
    from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams

    sp = SchemeParams(ring_dim=n, plaintext_modulus=65537, num_limbs=L, scheme="bgv")
    return BGVContext(sp, seed=1, device=cuda), BGVContext(sp, seed=1, device="cpu")


@pytest.mark.parametrize("n,L", [(1024, 3), (16384, 6)])
def test_mod_switch_on_cuda_matches_cpu(cuda, n, L):
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext

    gpu, cpu = _bgv_pair(cuda, n, L)
    data = _residues((3, 2, L, n), cpu.q_primes, seed=n + L)
    got = gpu.mod_switch(Ciphertext(data.to(cuda), "bgv", 1))
    want = cpu.mod_switch(Ciphertext(data, "bgv", 1))
    torch.cuda.synchronize()
    assert got.scale == want.scale and torch.equal(got.data.cpu(), want.data)


def test_automorphism_on_cuda_matches_cpu(cuda):
    """Every element of the EvalSum ladder at n = 1024, on the same key."""
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, RelinKey

    n, L = 1024, 3
    gpu, cpu = _bgv_pair(cuda, n, L)
    data = _residues((4, 2, L, n), cpu.q_primes, seed=9)
    for i, k in enumerate(cpu.sum_ladder_elements()):
        kb = _residues((L, L, n), cpu.q_primes, seed=100 + i)
        ka = _residues((L, L, n), cpu.q_primes, seed=200 + i)
        got = gpu.automorphism(Ciphertext(data.to(cuda)), k, RelinKey(kb.to(cuda), ka.to(cuda)))
        want = cpu.automorphism(Ciphertext(data), k, RelinKey(kb, ka))
        torch.cuda.synchronize()
        assert torch.equal(got.data.cpu(), want.data), k


@pytest.mark.parametrize("bits", [16, 32], ids=["leveled", "flat"])
def test_bgv_protocol_on_cuda_small_ring(cuda, bits):
    """--bgv on the card: leveled at 16-bit items, flat at 32-bit; K1 and K2
    launched, the client decrypts on the device, and the run verifies."""
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi, ht = _small_protocol(bgv=True, bit_size=bits, num_limbs=None)
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == 5
    assert server.pie.leveled == (bits == 16)
    assert min(ntt_cuda.launches.values()) > 0 and pie_kernels.launches == 1
    assert client.noise_bits is None and client._decryptors


@pytest.mark.parametrize("bgv", [False, True], ids=["bfv", "bgv"])
def test_simple_fhe_protocol_on_cuda_small_ring(cuda, bgv):
    """SimpleFHE on the card: K1 launched (the Galois key switches); the
    client decrypts on the device through the decrypt kernel, BFV and BGV
    results alike (``result_zero_mask``)."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi = PSIParams(server_set_size=200, client_set_size=8, intersection_set_size=4,
                    bit_size=32, fhe=True, batched=False, bgv=bgv, ring_dim=64)
    ht = HashTableParams(each_simple_table_size=16, each_cuckoo_table_size=10,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=6)
    ntt_cuda.reset_launches()
    decrypt_cuda.reset_launches()
    client, _, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == 4
    assert min(ntt_cuda.launches.values()) > 0
    assert decrypt_cuda.launches > 0 and client.noise_bits is None
    assert list(client._decryptors) == [("bgv" if bgv else "bfv", client.ctx.L)]


# ---- the protocols at ring 16384 through the user entry points -------------

# BatchedFHE at the BFV cells' 2^20 x 2048 row (one query, --queries 4,
# --streamChunks 4), flat --bgv on the same row (the BGV cell), --bgv -B 16
# leveled on its table with a 4096-item server (16-bit items repeat rarely
# at that size), and SimpleFHE at full width and reduced scale (32 inner
# tables): run -> (flags, L, limbs the result ships on)
ROW_2P20 = ["-F", "--batched", "-B", "32", "-S", "1048576", "-C", "2048", "-I", "1024",
            "-e", "8022", "-E", "12", "-b", "12", "-k", "2", "-K", "2", "--device", "cuda"]
ENTRY_RUNS = {
    "bfv_queries1": (ROW_2P20, 6, 4),
    "bfv_queries4": (ROW_2P20 + ["--queries", "4"], 6, 4),
    "bfv_streamChunks4": (ROW_2P20 + ["--streamChunks", "4"], 6, 4),
    "bgv_flat": (ROW_2P20 + ["--bgv"], 9, 9),
    "bgv_leveled": (["-F", "--batched", "--bgv", "-B", "16", "-S", "4096", "-C", "256", "-I",
                     "128", "-e", "8022", "-E", "12", "-b", "12", "-k", "2", "-K", "2",
                     "--device", "cuda"], 6, 5),
    "simple_fhe": (["-F", "-B", "32", "-S", "1024", "-C", "16", "-I", "8", "-e", "16", "-E",
                    "12", "-b", "12", "-k", "2", "-K", "2", "--device", "cuda"], 7, 7),
}


@pytest.mark.parametrize("run", list(ENTRY_RUNS))
def test_protocols_at_ring_16384_through_the_entry_points(cuda, run):
    """``cli.parse_args`` and ``run_in_process`` on the card: each run
    verifies with the whole intersection; it launches K1 and the decrypt
    kernel, the batched PIE K2, and BFV the HPS kernels; the client
    decrypts on the device (no noise estimate) in the shipped limbs'
    context."""
    from nested_hashing_psi_tpu_torch import cli
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda, hps_cuda
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    flags, L, shipped = ENTRY_RUNS[run]
    psi, ht, device = cli.parse_args(flags)
    for counter in (ntt_cuda, pie_kernels, decrypt_cuda, hps_cuda):
        counter.reset_launches()
    client, server, ok = run_in_process(psi, ht, device=device)
    assert ok and len(client.intersection_calculated) == psi.intersection_set_size
    assert server.ctx.L == L and list(client._decryptors) == [(server.ctx.default_form, shipped)]
    assert client.noise_bits is None
    assert min(ntt_cuda.launches.values()) > 0 and decrypt_cuda.launches > 0
    assert (pie_kernels.launches > 0) == psi.batched
    assert (hps_cuda.launches > 0) == run.startswith("bfv")
    if psi.batched:
        assert server.pie.leveled == (run == "bgv_leveled")


# bench_e2e_psi's geometry flags -> the intersection the resume must find:
# a small row, and the BFV cells' 2^20 x 2048 row (ROW_2P20's table)
RESUME_ROWS = {
    "s2p16_c256": (["--server-log2", "16", "--client-log2", "8"], 128),
    "s2p20_c2048": (["--server-log2", "20", "--client-log2", "11", "--simpleSize", "8022",
                     "--inner", "12"], 1024),
}


@pytest.mark.parametrize("row", list(RESUME_ROWS))
def test_artifact_resumes_in_a_fresh_process_on_the_card(cuda, tmp_path, row):
    """``bench_e2e_psi --buildOnly`` on the card, then ``--resume`` in a
    fresh process that cannot import jax, the JAX package or cryptography
    (stubs that raise shadow them): it verifies, launches K1 and K2, and
    writes the result this process's resume of the same files computes,
    bit for bit. The same table saved host-resident resumes host-resident,
    pinned and position-major, launches K1 and K2 and answers bit-equal."""
    from nested_hashing_psi_tpu_torch.benchmarks import bench_e2e_psi as bench
    from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
    from nested_hashing_psi_tpu_torch.utils.checkpoint import load_batched_pie, save_batched_pie

    flags, found = RESUME_ROWS[row]
    art = str(tmp_path / "row.npz")
    assert bench.main(flags + ["--device", "cuda", "--checkpoint", art, "--buildOnly"]) == 0
    stub = tmp_path / "stub"
    for mod in ("jax", "nested_hashing_psi_tpu", "cryptography"):
        (stub / mod).mkdir(parents=True)
        (stub / mod / "__init__.py").write_text(f"raise ImportError('no {mod} in a resume')\n")
    result = str(tmp_path / "result.npy")
    res = subprocess.run(
        [sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi",
         "--resume", art, "--device", "cuda", "--resultOut", result],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub), REPO])),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "RESUME RESULT: Set matches!" in res.stdout and f"|intersection| {found})" in res.stdout
    launched = json.loads(res.stdout.split("kernel launches ", 1)[1].splitlines()[0])
    assert min(launched.values()) > 0, launched
    pie = load_batched_pie(art, device=cuda)
    with np.load(bench.sidecar_path(art)) as z:
        idx, minus = (Ciphertext(from_numpy(z[k], cuda), pie.ctx.default_form)
                      for k in ("idx", "minus"))
    got = np.load(result)
    want = pie.run(idx, minus).data
    assert got.dtype == to_numpy(want).dtype and np.array_equal(got, to_numpy(want))

    host_art = str(tmp_path / "row_host.npz")
    save_batched_pie(host_art, BatchedFHEPIE.from_artifact(
        pie.ctx, pie.rlk, pie.table_pt, pie.mask_pt, pie.H, pie.D, pie.P, pie.batch_slots,
        leveled=pie.leveled, mul_limbs=pie.mul_limbs or 0, ship_limbs=pie.ship_limbs,
        host_table=True))
    rh = load_batched_pie(host_art, device=cuda)
    assert rh.host_table and rh.table_pt.is_pinned() and rh._host_positions().is_contiguous()
    assert rh.table_pt.device.type == "cpu"
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    assert torch.equal(rh.run(idx, minus).data, want)
    assert min(ntt_cuda.launches.values()) > 0 and pie_kernels.launches > 0


# ---- the probes under benchmarks/ (A1-A3) ---------------------------------

from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_anatomy  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_lazy_probe  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks import bench_vpu_ops  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks import common as bench_common  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks import timing  # noqa: E402
from nested_hashing_psi_tpu_torch.ops import cuda_lib  # noqa: E402
from nested_hashing_psi_tpu_torch.ops.split_plan import SplitNTTPlan  # noqa: E402


def _u32_patterns(shape, seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


# A tile is bench_vpu_ops.TILE elements (256 threads, one 16-byte vector
# each); 10007 tiles, a prime, split unevenly over any persistent grid.
VPU_SHAPES = {"tile": (8, 8, 128), "odd": (3, 5, 7), "one": (1,),
              "tile-1": (bench_vpu_ops.TILE - 1,), "tile+1": (bench_vpu_ops.TILE + 1,),
              "uneven": (10007 * bench_vpu_ops.TILE - 3,), "jax": bench_vpu_ops.SHAPE}


@pytest.mark.parametrize("shape", list(VPU_SHAPES.values()), ids=list(VPU_SHAPES))
@pytest.mark.parametrize("mix", bench_vpu_ops.MIXES)
def test_vpu_ops_kernel_matches_plain(cuda, mix, shape):
    """K = 64, the JAX probe's function; bit-exact (fmul: NaNs as one class),
    at ragged sizes: one element, a tile less or more one, tiles that the
    persistent blocks share unevenly with a ragged last vector, and the
    JAX probe's shape."""
    x = _u32_patterns(shape, seed=11).to(cuda)
    got = bench_vpu_ops.vpu_ops(x, mix)
    torch.cuda.synchronize()
    assert bench_vpu_ops.same(got, bench_vpu_ops.vpu_ops_plain(x, mix), mix) == 0


@pytest.mark.parametrize("mix", ["add", "addmod", "shoup", "mont", "fmul", "mul4_ilp"])
def test_vpu_ops_kernel_large_k(cuda, mix):
    """A long chain (not a multiple of the kernel's unroll) on a small
    tensor, and K = 0 (the input unchanged)."""
    x = _u32_patterns((2, 8, 128), seed=12).to(cuda)
    got = bench_vpu_ops.vpu_ops(x, mix, 2051)
    torch.cuda.synchronize()
    assert bench_vpu_ops.same(got, bench_vpu_ops.vpu_ops_plain(x, mix, 2051), mix) == 0
    assert torch.equal(bench_vpu_ops.vpu_ops(x, mix, 0), x)


@pytest.mark.parametrize("k", [0, 1, 15, 16, 17, 64, 2051])
@pytest.mark.parametrize("mix", bench_vpu_ops.MIXES)
def test_vpu_ops_kernel_chain_lengths(cuda, mix, k):
    """K below, at and past the kernel's unroll of 16 (the pass loop and
    the rest of K), on three tiles with a ragged last vector; K = 0 gives x."""
    x = _u32_patterns((3 * bench_vpu_ops.TILE - 2,), seed=100 + k).to(cuda)
    got = bench_vpu_ops.vpu_ops(x, mix, k)
    torch.cuda.synchronize()
    assert bench_vpu_ops.same(got, bench_vpu_ops.vpu_ops_plain(x, mix, k), mix) == 0
    if k == 0:
        assert torch.equal(got, x)


def test_vpu_ops_kernel_unaligned_input(cuda):
    """A view 4 bytes past a 16-byte boundary: the wrapper copies it."""
    x = _u32_patterns((2 * bench_vpu_ops.TILE + 1,), seed=16).to(cuda)[1:]
    assert x.data_ptr() % 16
    for mix in ("add", "mont"):
        got = bench_vpu_ops.vpu_ops(x, mix)
        torch.cuda.synchronize()
        assert bench_vpu_ops.same(got, bench_vpu_ops.vpu_ops_plain(x, mix), mix) == 0


@pytest.mark.parametrize("mix", ["mul", "shoup", "fmul"])
def test_vpu_ops_graph_reading_chains_and_counts_calls(cuda, mix):
    """The device reading: a graph of chained calls. Its capture adds each
    captured call once to ``launches`` (two warm-ups outside it), its
    replays none; every replay reads the warm-ups' last output, so the
    chain's state after it holds 2 + 7 calls applied to x."""
    x = _u32_patterns((2, 8, 128), seed=17).to(cuda)
    step = timing.chain(lambda v: bench_vpu_ops.vpu_ops(v, mix, 5), x)
    bench_vpu_ops.reset_launches()
    ms = timing.graph_ms(step, cuda, iters=7, reps=3)
    assert ms > 0 and bench_vpu_ops.launches == 2 + 7
    got = step()  # one more eager call on the graph's last output
    torch.cuda.synchronize()
    want = x
    for _ in range(2 + 7 + 1):
        want = bench_vpu_ops.vpu_ops_plain(want, mix, 5)
    assert bench_vpu_ops.launches == 2 + 7 + 1
    assert bench_vpu_ops.same(got, want, mix) == 0


def _probe_plan_and_input(n, rows, seed, cuda, L=2):
    ps = ntt_primes(L, 31, 2 * n)
    plan = SplitNTTPlan(n, ps)
    x = np.random.default_rng(seed).integers(0, min(ps), size=(rows, L, n), dtype=np.int64)
    return plan, torch.from_numpy(x.astype(np.int32)).to(cuda)


@pytest.mark.parametrize("rows", [5, 9])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
@pytest.mark.parametrize("which", bench_ntt_lazy_probe.VARIANTS)
def test_lazy_probe_kernel_matches_plain(cuda, which, n, rows):
    """Slab counts that leave a block's slab groups unevenly loaded."""
    plan, x = _probe_plan_and_input(n, rows, seed=n + rows, cuda=cuda)
    got = bench_ntt_lazy_probe.lazy_probe(x, plan, which)
    torch.cuda.synchronize()
    assert torch.equal(got, bench_ntt_lazy_probe.lazy_probe_plain(x, plan, which))


@pytest.mark.parametrize("rows", [5, 9])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14])
@pytest.mark.parametrize("which", bench_ntt_anatomy.VARIANTS)
def test_anatomy_probe_kernel_matches_plain(cuda, which, n, rows):
    plan, x = _probe_plan_and_input(n, rows, seed=n + rows + 1, cuda=cuda, L=3)
    got = bench_ntt_anatomy.anatomy_probe(x, plan, which)
    torch.cuda.synchronize()
    assert torch.equal(got, bench_ntt_anatomy.anatomy_probe_plain(x, plan, which))


def test_probe_launch_counts_and_refusals(cuda):
    x = _u32_patterns((2, 8, 128), seed=13).to(cuda)
    bench_vpu_ops.reset_launches()
    for mix in bench_vpu_ops.MIXES:
        bench_vpu_ops.vpu_ops(x, mix)
    assert bench_vpu_ops.launches == len(bench_vpu_ops.MIXES)
    plan, y = _probe_plan_and_input(1 << 10, 3, seed=14, cuda=cuda)
    bench_ntt_lazy_probe.reset_launches()
    bench_ntt_anatomy.reset_launches()
    for which in bench_ntt_lazy_probe.VARIANTS:
        bench_ntt_lazy_probe.lazy_probe(y, plan, which)
    bench_ntt_anatomy.anatomy_probe(y, plan, "moves")
    torch.cuda.synchronize()
    assert (bench_ntt_lazy_probe.launches, bench_ntt_anatomy.launches) == (3, 1)
    odd, z = _probe_plan_and_input(1 << 11, 2, seed=15, cuda=cuda)
    with pytest.raises(ValueError, match="2\\^10, 2\\^12 or 2\\^14"):
        bench_ntt_lazy_probe.lazy_probe(z, odd, "exact")
    assert bench_ntt_lazy_probe.launches == 3


@pytest.mark.parametrize("mix", bench_vpu_ops.MIXES)
def test_vpu_ops_chain_not_folded(cuda, mix):
    """The kernel's loop body holds, per application, at least the fewest
    instructions one application can take (the compiler folded nothing)."""
    bench_vpu_ops.vpu_ops(torch.zeros(8, dtype=torch.int32, device=cuda), mix)  # builds
    assert bench_vpu_ops.sass_per_application(mix)["arith"] >= bench_vpu_ops.MIN_ARITH[mix]


@pytest.fixture(scope="module")
def probe_ptxas():
    """Registers and spills of every probe kernel instance (a compile of
    the three sources with ``-Xptxas -v``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return bench_common.ptxas_instances(
        cuda_lib.ptxas_report(["probe_ntt_lazy.cu", "probe_ntt_anatomy.cu", "probe_vpu_ops.cu"]))


@pytest.mark.parametrize("m", bench_ntt_lazy_probe.KERNEL_M)
@pytest.mark.parametrize("which", [*bench_ntt_lazy_probe.VARIANTS, "stages"])
def test_redesigned_probe_instances_do_not_spill(probe_ptxas, which, m):
    mod = bench_ntt_anatomy if which == "stages" else bench_ntt_lazy_probe
    regs = bench_common.instance(probe_ptxas, mod.kernel_name(m, which))
    assert regs["spill_stores"] == 0 and regs["spill_loads"] == 0, regs
    assert 0 < regs["registers"] <= 255


@pytest.mark.parametrize("mix", bench_vpu_ops.MIXES)
def test_vpu_ops_instances_do_not_spill(probe_ptxas, mix):
    regs = bench_common.instance(probe_ptxas,
                                 f"vpu_ops_kernelILi{bench_vpu_ops.MIXES.index(mix)}E")
    assert regs["spill_stores"] == 0 and regs["spill_loads"] == 0, regs
    assert 0 < regs["registers"] <= 255


@pytest.mark.parametrize("which", [*bench_ntt_lazy_probe.VARIANTS, "stages"])
def test_probe_butterflies_not_folded(cuda, which):
    """The slab loop holds, per butterfly, at least the fewest instructions
    a butterfly of the form can take."""
    mod = bench_ntt_anatomy if which == "stages" else bench_ntt_lazy_probe
    cuda_lib.get_lib()  # builds
    plan = SplitNTTPlan(1 << 14, ntt_primes(1, 31, 1 << 15))
    s = bench_ntt_lazy_probe.sass_per_butterfly(mod.kernel_name(128, which), plan)
    assert s["arith"] >= mod.MIN_ARITH[which]


def test_probe_k1_line_holds_k1_against_plain(cuda):
    ps, _, x = bench_ntt_lazy_probe.inputs(1 << 12, 2, 5, cuda)
    err, ms = bench_ntt_lazy_probe.k1_line(x, ps, cuda, 2)
    assert err == 0 and ms > 0


@pytest.mark.parametrize("probe,argv", [
    (bench_vpu_ops, ["--shape", "2", "8", "128", "--mixes", "add", "mont", "fmul"]),
    (bench_ntt_lazy_probe, ["--n", "4096", "--limbs", "2", "--batch", "5"]),
    (bench_ntt_anatomy, ["--n", "4096", "--limbs", "2", "--batch", "5"]),
], ids=["vpu_ops", "lazy", "anatomy"])
def test_probe_main_on_the_card(cuda, probe, argv):
    """Each probe's ``main`` on the card (the CPU tests run it with
    ``--device cpu``): it holds every variant, and A2's and A3's K1 line,
    against the plain version on the card, raising on a mismatch, and
    launches its kernel."""
    probe.reset_launches()
    res = probe.main([*argv, "--iters", "1"])
    assert probe.launches > 0
    if probe is bench_vpu_ops:
        assert all(r["max_abs_err"] == 0 for r in res["mixes"].values())
    else:
        assert all(res[v]["max_abs_err"] == 0 for v in probe.VARIANTS)
        assert res["k1_max_abs_err"] == 0


def test_ntt_mxu_kernels_use_wgmma_and_bulk_copies(cuda):
    """K3's SASS (``cuobjdump`` of the built library) holds warpgroup MMAs
    (IGMMA) and bulk or TMA copies (UBLKCP, UTMALDG): the Hopper design it
    was written for, not a form the compiler fell back to."""
    cuda_lib.get_lib()  # builds
    ops = [op.split(".")[0] for name, body in bench_common.sass_functions().items()
           if "ntt_mxu_kernel" in name for _, op, _ in body]
    assert ops and "IGMMA" in ops
    assert ops.count("UBLKCP") + ops.count("UTMALDG") > 0


def test_anatomy_moves_go_through_shared_memory(cuda):
    """A3's moves kernel stages its rows through shared memory: its row
    loop holds LDS and STS."""
    cuda_lib.get_lib()  # builds
    ops = bench_ntt_anatomy.moves_sass(SplitNTTPlan(1 << 14, ntt_primes(6, 31, 1 << 15)))
    assert ops["opcodes"].get("LDS", 0) > 0 and ops["opcodes"].get("STS", 0) > 0


@pytest.mark.parametrize("precomp,curve", [(False, "P-192"), (True, "P-192"), (False, "K-163")],
                         ids=["SimpleElGamal", "PrecompElGamal", "SimpleElGamal_K163"])
def test_elgamal_runner_on_cuda_verifies(cuda, capsys, precomp, curve):
    """device="cuda" resolves the card; the ElGamal parties compute on the
    host, on the native EC libraries (prime and binary curves), and launch
    no kernel."""
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    psi = PSIParams(server_set_size=60, client_set_size=4, intersection_set_size=2,
                    bit_size=16, curve_name=curve, precomp=precomp)
    ht = HashTableParams(each_simple_table_size=8, each_cuckoo_table_size=6,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=3)
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 2
    assert client.device.type == server.device.type == "cuda"
    assert server.enc.group._native is not None and client.enc.group._native is not None
    assert ntt_cuda.launches["ntt"] + ntt_cuda.launches["intt"] + pie_kernels.launches == 0


def _entry_step(run):
    """The batched step of an entry-point run (``ENTRY_RUNS``) on the card:
    -> (server context, the step's inputs as numpy, its unsharded result
    on the full basis as numpy, the client)."""
    from nested_hashing_psi_tpu_torch import cli, convert
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi, ht, device = cli.parse_args(ENTRY_RUNS[run][0])
    client, server, ok = run_in_process(psi, ht, device=device)
    assert ok
    data = dict(idx=client.idx_ct.data, minus=client.minus_ct.data, table=server.pie.table_pt,
                mask=server.pie.mask_pt, rlk_b=server.rlk.b_mont, rlk_a=server.rlk.a_mont)
    want = batched_pie_forward(server.ctx, server.rlk,
                               *(data[k] for k in ("idx", "minus", "table", "mask"))).data
    return (server.ctx, {k: convert.to_numpy(v) for k, v in data.items()},
            convert.to_numpy(want), client)


def _ntt_cases(ctx):
    """The four-step and ring-exchange NTT cases on the context's q base at
    its ring -> (cases, K1's forward of their input)."""
    from nested_hashing_psi_tpu_torch import convert

    n, ps = ctx.n, ctx.q_primes
    x = convert.to_numpy(_residues((len(ps), n), ps, seed=10))
    forward = convert.to_numpy(ntt_cuda.ntt(convert.from_numpy(x, ctx.device), ctx.plan))
    m1 = 1 << ((n.bit_length() - 1 + 1) // 2)
    return [dict(name="dist_ntt", kind="dist_ntt", params=(n, ps, m1),
                 inputs={"x": x.reshape(len(ps), m1, n // m1)}),
            dict(name="ring_ntt", kind="ring_ntt", params=(n, ps, 0), inputs={"x": x})], forward


def test_sharded_steps_nccl_world_one(cuda):
    """parallel/ on NCCL at world size 1 on the card, the path a multi-GPU
    user runs, on the BFV cells' 2^20 x 2048 row through the entry points
    (D = P = 12, L = 6, ring 16384): the dp x tp, pipelined and
    ring-sharded steps bit-equal to the unsharded step on the full basis,
    K1 and K2 launched where the steps run them; the four-step and
    ring-exchange NTTs at (6, 16384) bit-equal to K1 and back; two ranks on
    one card are refused."""
    import torch.distributed as dist

    from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
    from nested_hashing_psi_tpu_torch.parallel.multihost import init_distributed
    from torch_parallel_cases import run_cases, summarize

    ctx, inputs, want, _ = _entry_step("bfv_queries1")
    cases = [dict(name="dp_tp", kind="dp_tp", params=ctx.params, inputs=inputs, mesh=(1, 1)),
             dict(name="pp", kind="pp", params=ctx.params, inputs=inputs),
             dict(name="sp", kind="sp", params=ctx.params, inputs=inputs)]
    ntts, forward = _ntt_cases(ctx)
    init_distributed(None, 1, 0, "nccl")
    try:
        out = summarize([run_cases(0, 1, cases + ntts, "cuda")])
    finally:
        dist.destroy_process_group()
    for case, s in zip(ntts, out[len(cases):]):
        assert s["transport"] == "nccl"
        np.testing.assert_array_equal(s["results"][0].reshape(forward.shape), forward)
        np.testing.assert_array_equal(s["results"][1], case["inputs"]["x"])
    for s in out[:len(cases)]:
        assert s["transport"] == "nccl"
        np.testing.assert_array_equal(s["results"][0], want)
        c = s["counts"][0][0]
        assert c["pie_ip"] > 0 and (s["name"] == "sp" or c["ntt_fwd"] * c["ntt_inv"] > 0)
    if torch.cuda.device_count() == 1:  # both ranks take card 0: the store check refuses
        with pytest.raises(RuntimeError, match=r"nccl needs one GPU per rank: rank [01] shares"):
            run_ranks(run_cases, 2, "nccl", ([], "cuda"), timeout=120)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("form", ["auto", "whole", "split"])
def test_bench_ntt_kernel_chain_matches_plain(cuda, form, inverse):
    """bench_ntt_kernel's chained K1, in each form, equals the plain chain
    at (5, 2, 4096)."""
    from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_kernel

    ps = ntt_primes(2, 31, 2 * 4096)
    plan = NTTPlan(4096, ps)
    x = _residues((5, 2, 4096), ps, seed=41)
    got = bench_ntt_kernel.run_chain(x.to(cuda), plan, inverse, form, 3)
    want = bench_ntt_kernel.run_chain(x, plan, inverse, form, 3)  # the plain version
    assert torch.equal(got.cpu(), want)


def test_bench_query0_mask_on_the_card(cuda):
    """The bench's Q-query pipeline on the card at ring 4096: query 0's
    packed device mask equals the host decrypt of a single run (the bench
    raises otherwise), and the readings are positive."""
    from nested_hashing_psi_tpu_torch.benchmarks import bench, small_pie

    built = small_pie.bench_row(device=cuda, ring=4096, simple=1024, D=4, P=8)
    res = bench.pie_online(built, cuda, queries=4, iters=2, steady_iters=3)
    assert res["query0_mask_equals_host_decrypt"] and res["pipeline_Q"] == 4
    assert min(res[k] for k in ("ms_per_query", "ms_per_query_single", "ms_per_query_steady",
                                "ms_per_query_device")) > 0


@pytest.mark.parametrize("config", ["2^20", "2^24"])
def test_bench_pie_online_holds_k2_at_the_sweep_rows(cuda, config):
    """bench_pie_online at the JAX tool's 2^20 and 2^24 rows on the card: K2
    at each table's shape (P = 14, and P = 58 at 3.3 GB) equals its plain
    version (``run`` raises otherwise)."""
    from nested_hashing_psi_tpu_torch.benchmarks import bench_pie_online

    res = bench_pie_online.run(config, cuda)
    assert res["k2_max_abs_err"] == 0 and res["k2_launches"] > 0 and res["k2_share"] > 0


def test_profile_online_kernel_rows_on_the_card(cuda):
    """profile_online on the card: the step's parts and the HPS multiply's,
    each with the kernels a trace of it recorded, at a small bench row; then
    its kernel readings at two small cells: each kernel of a set timed
    alone, from a graph and through its wrapper, beside its bound; BGV runs
    no HPS kernel."""
    from nested_hashing_psi_tpu_torch.benchmarks import profile_online, small_pie

    built = small_pie.bench_row(device=cuda, ring=4096, simple=1024, D=4, P=8)
    for rows in (profile_online.main_rows(built, cuda, iters=2),
                 profile_online.hps_rows(built, cuda, iters=2)):
        assert all(r["kernels"] > 0 and r["ms"] > 0 for r in rows.values())  # traced kernels
    res = profile_online.kernel_rows(cuda, {"bfv": (4, 6, "bfv"), "bgv": (4, 9, "bgv")},
                                     iters=2)
    assert sorted(res) == sorted(
        [f"bfv {k}" for k in ("K2", "HPS rescale + extension", "HPS tensor products",
                              "HPS scale + exact return", "HPS ship rescale", "decrypt")]
        + ["bgv K2", "bgv decrypt"])
    assert all(r["graph_ms"] > 0 and r["wrapper_ms"] > 0 and r["share"] > 0
               for r in res.values())
    assert res["bfv decrypt"]["shape"] == [4, 4, 16384]


@pytest.mark.parametrize("golden", ["golden_fhe_pie", "golden_batched_fhe_pie",
                                    "golden_inner_product"])
def test_reference_golden_at_ring_16384(cuda, golden):
    """The reference's golden tests through the port at their own scale
    (ring 16384; tests/torch_golden_cases.py raises on any failed pass
    criterion): K1 launched in each, K2 in the batched PIE."""
    import torch_golden_cases

    out = getattr(torch_golden_cases, golden)(cuda)
    assert out["noise"] < out["noise_bound"]
    launched = out["launches"]
    assert launched["ntt_fwd"] > 0 and launched["ntt_inv"] > 0
    assert (launched["pie_ip"] > 0) == (golden == "golden_batched_fhe_pie")


# ---- the JAX package's ring-16384 tests (marked slow there), on the card ---


def _psi_ht(simple: bool, **over):
    """tests/test_protocol_e2e.py's (BatchedFHE) or tests/test_simple_fhe.py's
    (SimpleFHE) parameters, with ``over`` applied to the PSI parameters."""
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams

    if simple:
        psi = dict(server_set_size=200, client_set_size=8, intersection_set_size=4,
                   bit_size=16, fhe=True, batched=False, ring_dim=64, num_limbs=8)
        ht = dict(each_simple_table_size=8, each_cuckoo_table_size=10,
                  n_simple_hash_functions=2, n_cuckoo_hash_functions=2, max_items_per_position=6)
    else:
        psi = dict(server_set_size=300, client_set_size=12, intersection_set_size=5,
                   hash_seed=987654321, item_seed=123456789, bit_size=16, fhe=True, batched=True,
                   ring_dim=128, num_limbs=8)
        ht = dict(each_simple_table_size=32, each_cuckoo_table_size=12,
                  n_simple_hash_functions=2, n_cuckoo_hash_functions=2, max_items_per_position=4)
    return PSIParams(**{**psi, **over}), HashTableParams(**ht)


@pytest.mark.parametrize("simple,bit_size,bgv", [
    (False, 40, False), (False, 48, False), (True, 16, True), (True, 40, False),
], ids=["batched_40bit", "batched_48bit", "simple_bgv_default_limbs", "simple_40bit"])
def test_protocol_at_ring_16384_default_limbs(cuda, monkeypatch, simple, bit_size, bgv):
    """tests/test_protocol_e2e.py::test_batched_fhe_e2e_big_t_ring16384 and
    tests/test_simple_fhe.py's two ring-16384 tests on the card: the default
    limb budget at the production ring (the 40/48-bit moduli through the
    native __int128 decode; BGV with the EvalSum ladder's 14 key switches)
    verifies with 20 bits of noise to spare. The client decrypts on the
    device, BFV and BGV results alike, which reads no noise: what it
    decrypts is decrypted again on the host for the noise."""
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
    from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    seen = []
    zero_mask = DeviceDecryptor.zero_mask

    def spy(self, data, *args, **kwargs):
        seen.append(data)
        return zero_mask(self, data, *args, **kwargs)

    monkeypatch.setattr(DeviceDecryptor, "zero_mask", spy)
    psi, ht = _psi_ht(simple, bit_size=bit_size, bgv=bgv, ring_dim=16384, num_limbs=0)
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == psi.intersection_set_size
    assert client.noise_bits is None and seen
    form = client.ctx.default_form
    noise = max(client.ctx.decrypt(Ciphertext(d, form), client.sk)[1] for d in seen)
    assert noise < server.ctx.params.num_limbs * 31 - 20


def test_sharded_steps_at_ring_16384(cuda):
    """parallel/ on the card, four gloo ranks sharing it, on the inputs of
    the BFV and flat BGV cells' 2^20 x 2048 rows through the entry points
    (D = P = 12; BFV L = 6, flat BGV L = 9; ring 16384): the dp x tp step
    at 2 x 2 (BFV, the relin all-gather over tp) and 4 x 1 (flat BGV), the
    ring-sharded step (4 ranks, 4096-column blocks) and the pipelined step
    (k = 4) under both, each bit-equal to the unsharded step on the full
    basis, each rank launching K2 and, where its step transforms on one
    device, K1; the 2 x 2 BFV result decrypts to the whole intersection;
    the four-step and ring-exchange NTTs at (6, 16384) bit-equal to K1 and
    back; the SimpleFHE step over 4 ranks at the entry-point run's
    geometry, bit-equal to the unsharded PIE, each rank holding less than
    the whole table."""
    from nested_hashing_psi_tpu_torch import cli, convert
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
    from nested_hashing_psi_tpu_torch.ops import cuda_lib
    from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
    from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE
    from nested_hashing_psi_tpu_torch.protocol import batched_fhe
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process
    from torch_parallel_cases import run_cases, summarize

    rows = {"bfv": _entry_step("bfv_queries1"), "bgv": _entry_step("bgv_flat")}
    cases, want = [], {}
    for scheme, kind, mesh in (("bfv", "dp_tp", (2, 2)), ("bgv", "dp_tp", (4, 1)),
                               ("bfv", "sp", None), ("bgv", "sp", None),
                               ("bfv", "pp", None), ("bgv", "pp", None)):
        ctx, inputs, want[f"{kind}_{scheme}"], _ = rows[scheme]
        cases.append(dict(name=f"{kind}_{scheme}", kind=kind, params=ctx.params,
                          inputs=inputs, mesh=mesh))
    ntts, want["ntt"] = _ntt_cases(rows["bfv"][0])
    cases += ntts
    psi, ht, device = cli.parse_args(ENTRY_RUNS["simple_fhe"][0])
    client, server, ok = run_in_process(psi, ht, device=device)
    assert ok
    ref = SimpleFHEPIE(server.ctx, server.server_table, server.gks, mask_seed=7)
    want["simple"] = convert.to_numpy(ref.run(client.idx_ct).data)
    table_bytes = ref.table_pt.numel() * ref.table_pt.element_size()
    del ref
    cases.append(dict(name="simple", kind="simple", params=server.ctx.params, mesh=(4, 1),
                      inputs={"idx": convert.to_numpy(client.idx_ct.data)},
                      hct=server.server_table,
                      galois_keys=convert.galois_keys_to_numpy(server.gks), mask_seed=7))
    del client, server
    cuda_lib.get_lib()  # the ranks load the library this process built
    out = summarize(run_ranks(run_cases, 4, "gloo", (cases, "cuda"), timeout=900))
    for case, s in zip(cases, out):
        got, name = s["results"], case["name"]
        if case["kind"] in ("dist_ntt", "ring_ntt"):
            np.testing.assert_array_equal(got[0].reshape(want["ntt"].shape), want["ntt"], name)
            np.testing.assert_array_equal(got[1], case["inputs"]["x"], name)
            continue
        np.testing.assert_array_equal(got[0], want[name], err_msg=name)
        counts = [c[0] for c in s["counts"]]
        if case["kind"] == "simple":
            assert max(s["held"]) < table_bytes, (s["held"], table_bytes)
            assert all(c["ntt_fwd"] > 0 and c["ntt_inv"] > 0 for c in counts), counts
        else:
            assert all(c["pie_ip"] > 0 for c in counts), (name, counts)
            if case["kind"] != "sp":  # the ring-sharded transforms are the distributed butterfly
                assert all(c["ntt_fwd"] > 0 and c["ntt_inv"] > 0 for c in counts), (name, counts)
    client = rows["bfv"][3]  # the 2 x 2 BFV result on the full basis, decrypted by the client
    result = Ciphertext(convert.from_numpy(out[0]["results"][0], cuda), "bfv")
    mask, _ = batched_fhe.result_zero_mask(client.ctx, result, client.sk, client.ht.batch_slots,
                                           {})
    found = client.client_ops.extract_intersection_mask(mask)
    assert len(found) == client.params.intersection_set_size


def test_sharded_step_production_geometry_memory_bounded(cuda):
    """tests/test_parallel.py::test_sharded_pie_production_geometry_memory_bounded
    on the card: the 2^24 geometry (D = P = 48, L = 9, ring 16384) through the
    dp x tp step (NCCL, world 1, L = 9 unsplit over tp) with pos_chunk = 4,
    bit-equal to the unsharded step (K2's sums mod p are exact, so the
    chunks change no bit), and the device's peak
    below the naive (H, D, P, 2, L, N) int64 product the position sum never
    materialises."""
    import torch.distributed as dist

    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
    from nested_hashing_psi_tpu_torch.parallel.multihost import init_distributed
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
    from torch_parallel_cases import run_cases, summarize

    H, D, P, L, N = 2, 48, 48, 9, 16384
    params = SchemeParams(ring_dim=N, plaintext_modulus=65537, num_limbs=L)
    ctx = BGVContext(params, seed=7, device=cuda)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    ps = ctx.q_primes
    gen = torch.Generator(device=cuda).manual_seed(1)

    def r(shape):
        return torch.randint(0, int(min(ps)), shape, generator=gen, device=cuda,
                             dtype=torch.int32)

    data = dict(idx=r((H, P, 2, L, N)), minus=r((2, L, N)), table=r((H, D, P, L, N)),
                mask=r((D, L, N)))
    want = convert.to_numpy(batched_pie_forward(ctx, rlk, *data.values()).data)
    inputs = {k: convert.to_numpy(v) for k, v in data.items()}
    inputs.update(rlk_b=convert.to_numpy(rlk.b_mont), rlk_a=convert.to_numpy(rlk.a_mont))
    del data
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    case = dict(name="dp_tp", kind="dp_tp", params=params, inputs=inputs, mesh=(1, 1),
                pos_chunk=4)
    init_distributed(None, 1, 0, "nccl")
    try:
        (s,) = summarize([run_cases(0, 1, [case], "cuda")])
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(s["results"][0], want)
    naive = H * D * P * 2 * L * N * 8
    assert torch.cuda.max_memory_allocated(cuda) < naive, (torch.cuda.max_memory_allocated(cuda),
                                                           naive)
