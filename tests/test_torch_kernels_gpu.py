"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_gpu.py -q

K1 (ops/ntt_cuda.py), K2 (ops/pie_kernels.py) and K3 (ops/ntt_mxu.py) must
equal their plain versions bit for bit (integer residues: exact equality),
and K3 must equal K1. The on-device decrypt must give the host decrypt's
zero mask, and the streamed protocol and the host-resident table must
verify on the card.
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


def test_ntt_kernel_small_ring_and_launch_count(cuda):
    ps = ntt_primes(2, 31, 2 * 16)
    plan = NTTPlan(16, ps)
    x = _residues((2, 16), ps, seed=1)
    before = dict(ntt_cuda.launches)
    got = ntt_cuda.ntt(x.to(cuda), plan)
    assert ntt_cuda.launches == {"ntt": before["ntt"] + 1, "intt": before["intt"]}
    assert torch.equal(got.cpu(), ntt(x, plan))


def test_pie_kernel_matches_plain_main_geometry(cuda):
    H, D, P, L, N = 2, 12, 12, 6, 16384
    ps = ntt_primes(L, 31, 2 * N, avoid=(T32,))
    plan = NTTPlan(N, ps)
    tb = plan.tensors(cuda)
    idx = _residues((H, P, 2, L, N), ps, seed=2).to(cuda)
    pt = _residues((H, D, P, L, N), ps, seed=3).to(cuda)
    before = pie_kernels.launches
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p"], tb["pinv"])
    torch.cuda.synchronize()
    assert pie_kernels.launches == before + 1
    want = pie_kernels.indexed_inner_product_plain(idx, pt, tb["p"], tb["pinv"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1024, 16384, 32768])
@pytest.mark.parametrize("base", ["q", "aux"])
def test_ntt_mxu_kernel_matches_plain_and_k1(cuda, n, base):
    ps = _bases(n)[base]
    plan, mp = NTTPlan(n, ps), ntt_mxu.MxuNTTPlan(n, ps)
    x = _residues((3, len(ps), n), ps, seed=n + 1).to(cuda)
    before = dict(ntt_mxu.launches)
    got = ntt_mxu.ntt_mxu(x, mp)
    torch.cuda.synchronize()
    assert ntt_mxu.launches["ntt"] == before["ntt"] + 1
    assert torch.equal(got, ntt_mxu.ntt_mxu_plain(x, mp))
    k1 = ntt_cuda.ntt(x, plan)
    assert torch.equal(got, k1)
    back = ntt_mxu.intt_mxu(k1, mp)
    torch.cuda.synchronize()
    assert torch.equal(back, ntt_mxu.intt_mxu_plain(k1, mp))
    assert torch.equal(back, ntt_cuda.intt(k1, plan)) and torch.equal(back, x)


def test_ntt_mxu_kernel_rejects_small_tiles(cuda):
    """n = 128 splits as 16 x 8: m2 is not a multiple of the 16-wide tile."""
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
    got = pie_kernels.indexed_inner_product(idx, pt, tb["p"], tb["pinv"], p0=3)
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


def _small_protocol(**over):
    from nested_hashing_psi_tpu.config import HashTableParams, PSIParams

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
    from nested_hashing_psi_tpu.config import HashTableParams, PSIParams
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
