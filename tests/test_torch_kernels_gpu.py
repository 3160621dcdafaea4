"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_gpu.py -q

K1 (ops/ntt_cuda.py), K2 (ops/pie_kernels.py) and K3 (ops/ntt_mxu.py) must
equal their plain versions bit for bit (integer residues: exact equality),
and K3 must equal K1. The on-device decrypt must give the host decrypt's
zero mask, and the decrypt kernel (BFV and BGV results) its plain
version's; ``mod_switch`` and ``automorphism`` on the card must equal the
port on the CPU, the streamed protocol, the host-resident table,
``--bgv`` and SimpleFHE must verify on the card, and so must the
reference's three golden tests at ring 16384 (``torch_golden_cases``).
"""

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, ntt_mxu, pie_kernels
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

pytestmark = pytest.mark.gpu

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
@pytest.mark.parametrize("rows,L", [(1, 1), (7, 1), (133, 7), (397, 1)])
def test_ntt_kernel_ragged_row_counts(cuda, rows, L, mode):
    """Row counts that divide neither the card's SMs nor the split form's
    eight chunks per block."""
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


def test_pie_kernel_matches_plain_main_geometry(cuda):
    H, D, P, L, N = 2, 12, 12, 6, 16384
    ps = ntt_primes(L, 31, 2 * N, avoid=(T32,))
    plan = NTTPlan(N, ps)
    tb = plan.tensors(cuda)
    idx = _residues((H, P, 2, L, N), ps, seed=2).to(cuda)
    pt = _residues((H, D, P, L, N), ps, seed=3).to(cuda)
    before = pie_kernels.launches
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p_u32"], tb["pinv_u32"])
    torch.cuda.synchronize()
    assert pie_kernels.launches == before + 1
    want = pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"])
    assert torch.equal(got, want)


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
    np.testing.assert_array_equal(mask.cpu().numpy(), vals[:, :length] == 0)
    return dec, dec._phase(ct.data, sk.s_mont)


@pytest.mark.parametrize("form,L,ship", [("bfv", 6, 4), ("bgv", 9, None)],
                         ids=["bfv_12x4x16384", "bgv_12x9x16384"])
def test_decrypt_kernel_at_the_cells_shapes(cuda, form, L, ship):
    """The cells' results: 12 rows of 16384 on BFV's 4 shipped limbs and on
    flat BGV's 9, t = 2^32+2^20+2^19+1, each row split over a cluster of 8
    blocks; a second launch gives the same mask."""
    from nested_hashing_psi_tpu_torch.ops import decrypt_cuda

    ctx, sk, ct, vals = _decrypt_case(cuda, form, T32, 16384, L, 12, seed=L, ship=ship)
    assert tuple(ct.data.shape) == (12, 2, ship or L, 16384) and ct.form == form
    dec, phase = _check_decrypt_kernel(ctx, sk, ct, vals, 4096)
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


@pytest.mark.parametrize("L,t", [(9, T32), (6, 65537)], ids=["flat_bgv_L9", "leveled_L6"])
def test_pie_kernel_matches_plain_bgv_geometry(cuda, L, t):
    """K2 at the --bgv paths' limb counts: flat BGV at 32-bit items (L = 9)
    and the leveled path at 16-bit items (L = 6), the primes avoiding t."""
    H, D, P, N = 2, 12, 12, 16384
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
    """SimpleFHE on the card: K1 launched (the Galois key switches); a BFV
    client decrypts on the device, a BGV client on the host."""
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    psi = PSIParams(server_set_size=200, client_set_size=8, intersection_set_size=4,
                    bit_size=32, fhe=True, batched=False, bgv=bgv, ring_dim=64)
    ht = HashTableParams(each_simple_table_size=16, each_cuckoo_table_size=10,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=6)
    ntt_cuda.reset_launches()
    client, _, ok = run_in_process(psi, ht, device="cuda")
    assert ok and len(client.intersection_calculated) == 4
    assert min(ntt_cuda.launches.values()) > 0
    assert (client.decryptor is None) == bgv


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


@pytest.mark.parametrize("precomp", [False, True], ids=["SimpleElGamal", "PrecompElGamal"])
def test_elgamal_runner_on_cuda_verifies(cuda, capsys, precomp):
    """device="cuda" resolves the card; the ElGamal parties compute on the
    host and launch no kernel."""
    from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
    from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    psi = PSIParams(server_set_size=60, client_set_size=4, intersection_set_size=2,
                    bit_size=16, curve_name="P-192", precomp=precomp)
    ht = HashTableParams(each_simple_table_size=8, each_cuckoo_table_size=6,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=3)
    client, server, ok = run_in_process(psi, ht, device="cuda")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 2
    assert client.device.type == server.device.type == "cuda"
    assert ntt_cuda.launches["ntt"] + ntt_cuda.launches["intt"] + pie_kernels.launches == 0


def test_sharded_steps_nccl_world_one(cuda):
    """parallel/ on NCCL at world size 1 on the card, the path a multi-GPU
    user runs: the dp x tp, pipelined and ring-sharded steps (BFV, full
    basis) bit-equal to the unsharded step on the same device, K1 and K2
    launched where the steps run them; two ranks on one card are refused."""
    import torch.distributed as dist

    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
    from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
    from nested_hashing_psi_tpu_torch.parallel.multihost import init_distributed
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
    from torch_parallel_cases import run_cases, summarize

    n, L, H, D, P = 1024, 6, 2, 4, 4
    params = SchemeParams(ring_dim=n, plaintext_modulus=T32, num_limbs=L, scheme="bfv")
    ctx = make_context(params, seed=3, device=cuda)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    ps = ctx.q_primes
    data = dict(idx=_residues((H, P, 2, L, n), ps, 1), minus=_residues((2, L, n), ps, 2),
                table=_residues((H, D, P, L, n), ps, 3), mask=_residues((D, L, n), ps, 4))
    want = batched_pie_forward(ctx, rlk, *(data[k].to(cuda) for k in data)).data
    inputs = {k: convert.to_numpy(v) for k, v in data.items()}
    inputs.update(rlk_b=convert.to_numpy(rlk.b_mont), rlk_a=convert.to_numpy(rlk.a_mont))
    cases = [dict(name="dp_tp", kind="dp_tp", params=params, inputs=inputs, mesh=(1, 1)),
             dict(name="pp", kind="pp", params=params, inputs=inputs),
             dict(name="sp", kind="sp", params=params, inputs=inputs)]
    init_distributed(None, 1, 0, "nccl")
    try:
        out = summarize([run_cases(0, 1, cases, "cuda")])
    finally:
        dist.destroy_process_group()
    for s in out:
        assert s["transport"] == "nccl"
        np.testing.assert_array_equal(s["results"][0], convert.to_numpy(want))
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
    verifies with 20 bits of noise to spare. A BFV client decrypts on the
    device, which reads no noise: what it decrypts is decrypted again on the
    host for the noise."""
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
    noise = client.noise_bits
    if noise is None:
        assert seen and not bgv
        noise = max(client.ctx.decrypt(Ciphertext(d, "bfv"), client.sk)[1] for d in seen)
    assert noise < server.ctx.params.num_limbs * 31 - 20


def test_sharded_steps_at_ring_16384(cuda):
    """tests/test_parallel.py::test_sharded_pie_ring16384_shapes on the card:
    the dp x tp step's relin all-gather over tp (2 x 2) and the ring-sharded
    step's ring exchange (4 ranks, 4096-column blocks) at ring 16384, four
    gloo ranks sharing the card, bit-equal to the unsharded step."""
    from nested_hashing_psi_tpu_torch import convert
    from nested_hashing_psi_tpu_torch.benchmarks.small_pie import build_small_pie
    from nested_hashing_psi_tpu_torch.ops import cuda_lib
    from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
    from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward
    from torch_parallel_cases import run_cases, summarize

    built = build_small_pie(ring=16384, limbs=8, H=2, P=6, D=8, simple=64, device=cuda)
    ctx, pie, rlk = built.ctx, built.pie, built.pie.rlk
    data = dict(idx=built.idx_ct.data, minus=built.minus_ct.data, table=pie.table_pt,
                mask=pie.mask_pt, rlk_b=rlk.b_mont, rlk_a=rlk.a_mont)
    step_inputs = (data[k] for k in ("idx", "minus", "table", "mask"))
    want = convert.to_numpy(batched_pie_forward(ctx, rlk, *step_inputs).data)
    inputs = {k: convert.to_numpy(v) for k, v in data.items()}
    cases = [dict(name="dp_tp", kind="dp_tp", params=ctx.params, inputs=inputs, mesh=(2, 2)),
             dict(name="sp", kind="sp", params=ctx.params, inputs=inputs)]
    cuda_lib.get_lib()  # the ranks load the library this process built
    out = summarize(run_ranks(run_cases, 4, "gloo", (cases, "cuda"), timeout=600))
    for s in out:
        np.testing.assert_array_equal(s["results"][0], want, err_msg=s["name"])


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
