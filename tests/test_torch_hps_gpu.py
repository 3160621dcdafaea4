"""BFV's HPS kernels (csrc/hps.cu, ops/hps_cuda.py) against their plain
PyTorch versions on the CPU, bit for bit, on the card.

Every test needs a CUDA device (marker ``gpu``) and skips without one; on a
GPU machine:

    python -m pytest --noconftest tests/test_torch_hps_gpu.py -q

The shapes are the two BFV cells' (D = 12 and 48 depths of two operands at
ring 16384: L = 6 rescaled to 5 limbs, aux 8, the result shipped on 4), the
full basis' (6 limbs, aux 9), the largest counts the kernels take, ragged
row and coefficient counts, and residues on the rounding boundaries. The
plain versions run on the CPU: they are the oracle the JAX package is held
to.
"""

import math

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, RelinKey, tensor_product
from nested_hashing_psi_tpu_torch.ops import hps_cuda
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter, RNSRescale
from nested_hashing_psi_tpu_torch.ops.modmath import mont_constants
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

pytestmark = pytest.mark.gpu

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
N = 16384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _q(L, n=N):
    return list(ntt_primes(L, 31, 2 * n, avoid=(T32,)))


def _res(shape, primes, seed):
    """Random residues (..., len(primes), n) below each prime, int32."""
    rng = np.random.default_rng(seed)
    p = np.array(primes, np.int64).reshape(len(primes), 1)
    return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))


def _along_n(xs, primes, n=64):
    """The residues of the integers xs over primes, the integers along the
    coefficient axis, rows of n: (rows, len(primes), n)."""
    xs = list(xs) + [0] * (-len(xs) % n)
    res = torch.tensor([[x % p for x in xs] for p in primes], dtype=torch.int64).int()
    return res.reshape(len(primes), -1, n).transpose(0, 1).contiguous()


def _boundary(primes):
    """Integers whose fraction x / prod(primes) sits at one half and at
    0.5 +- 2^-40, and residues of the last prime near its half."""
    q = math.prod(primes)
    xs = [q // 2 + d for d in range(-2, 3)]
    for k in (-1, 1):
        xs += [q // 2 + k * (q >> 40) + d for d in range(-2, 3)]
    p = primes[-1]
    xs += [p // 2 + d for d in range(-3, 4)] + [q - p // 2 + d for d in range(-3, 4)]
    return xs


def _launches(fn):
    before = hps_cuda.launches
    out = fn()
    torch.cuda.synchronize()
    return out, hps_cuda.launches - before


def _eq(got, want):
    assert torch.equal(got.cpu(), want)


def _main(L=6, mul=5):
    q = _q(L)
    return q, RNSRescale(q, L - mul), BFVMulConverter(q[:mul], T32, N)


# ---- rescale + extension -------------------------------------------------

@pytest.mark.parametrize("D", [12, 48])
def test_rescale_extend_matches_plain_at_the_cells(cuda, D):
    q, rs, mc = _main()
    x = _res((2, D, 2, 6, N), q, seed=D)
    (keep, aux), n = _launches(lambda: rs.rescale_extend(x.to(cuda), mc.q_to_aux))
    want_keep, want_aux = rs.rescale_extend(x, mc.q_to_aux)
    assert n == 1
    _eq(keep, want_keep)
    _eq(aux, want_aux)


@pytest.mark.parametrize("D", [12, 48])
def test_ship_rescale_matches_plain(cuda, D):
    q = _q(5)  # the first five of the cells' six primes
    rs = RNSRescale(q, 1)
    x = _res((D, 2, 5, N), q, seed=D + 1)
    got, n = _launches(lambda: rs.rescale(x.to(cuda)))
    assert n == 1
    _eq(got, rs.rescale(x))


@pytest.mark.parametrize("correction", [True, False])
def test_full_basis_extension_matches_plain(cuda, correction):
    q = _q(6)
    mc = BFVMulConverter(q, T32, N)
    assert mc.K + 1 == 9
    x = _res((12, 2, 6, N), q, seed=7)
    got, n = _launches(lambda: mc.extend_q_to_aux(x.to(cuda), correction))
    assert n == 1
    _eq(got, mc.extend_q_to_aux(x, correction))


# ---- the tensor products -------------------------------------------------

@pytest.mark.parametrize("L,D", [(5, 12), (5, 48), (6, 12)])
def test_tensor_products_match_plain(cuda, L, D):
    q = _q(6)[:L]
    mc = BFVMulConverter(q, T32, N)
    aux = list(mc.aux_primes)
    a, b = _res((D, 2, L, N), q, seed=1), _res((D, 2, L, N), q, seed=2)
    ea, eb = _res((D, 2, len(aux), N), aux, seed=3), _res((D, 2, len(aux), N), aux, seed=4)
    (dq, daux), n = _launches(lambda: hps_cuda.tensor_products(
        a.to(cuda), b.to(cuda), ea.to(cuda), eb.to(cuda), mc))
    assert n == 1
    for got, u, v, ps in ((dq, a, b, q), (daux, ea, eb, aux)):
        p = torch.tensor(ps, dtype=torch.int64).reshape(-1, 1)
        pinv = torch.tensor([mont_constants(x)[0] for x in ps]).reshape(-1, 1)
        r2 = torch.tensor([mont_constants(x)[1] for x in ps]).reshape(-1, 1)
        _eq(got, tensor_product(u, v, p, pinv, r2))


# ---- scale-and-round + the return to q -----------------------------------

@pytest.mark.parametrize("L,D", [(5, 12), (5, 48), (6, 12)])
def test_scale_round_and_exact_to_q_match_plain(cuda, L, D):
    q = _q(6)[:L]
    mc = BFVMulConverter(q, T32, N)
    d_q = _res((D, 3, L, N), q, seed=5)
    d_aux = _res((D, 3, mc.K + 1, N), mc.aux_primes, seed=6)
    gq, ga = d_q.to(cuda), d_aux.to(cuda)
    y = mc.scale_round(d_q, d_aux)
    got, n = _launches(lambda: mc.scale_round_to_q(gq, ga))
    assert n == 1
    _eq(got, mc.exact_to_q(y))
    got_y, n = _launches(lambda: mc.scale_round(gq, ga))
    assert n == 1
    _eq(got_y, y)
    got_q, n = _launches(lambda: mc.exact_to_q(y.to(cuda)))
    assert n == 1
    _eq(got_q, mc.exact_to_q(y))


# ---- ragged counts, the largest counts, the rounding boundaries ----------

@pytest.mark.parametrize("shape", [(1,), (3,), (7, 2)])
@pytest.mark.parametrize("n", [16, 48, 1000])
def test_ragged_rows_and_coefficients(cuda, shape, n):
    q, rs, mc = _main()
    x = _res((*shape, 6, n), q, seed=n)
    keep, aux = rs.rescale_extend(x.to(cuda), mc.q_to_aux)
    want_keep, want_aux = rs.rescale_extend(x, mc.q_to_aux)
    _eq(keep, want_keep)
    _eq(aux, want_aux)
    d_q = _res((*shape, 5, n), q[:5], seed=n + 1)
    d_aux = _res((*shape, mc.K + 1, n), mc.aux_primes, seed=n + 2)
    _eq(mc.scale_round_to_q(d_q.to(cuda), d_aux.to(cuda)), mc.scale_round_to_q(d_q, d_aux))


def test_empty_inputs_launch_nothing(cuda):
    q, rs, mc = _main()
    x = torch.zeros((0, 6, N), dtype=torch.int32, device=cuda)
    (keep, aux), n = _launches(lambda: rs.rescale_extend(x, mc.q_to_aux))
    assert n == 0 and keep.shape == (0, 5, N) and aux.shape == (0, mc.K + 1, N)


def test_the_largest_limb_counts(cuda):
    """16 limbs rescaled to 14 and extended to 17 (the kernels' larger caps)."""
    n = 64
    q = _q(16, n)
    rs, mc = RNSRescale(q, 2), BFVMulConverter(q[:14], T32, n)
    assert mc.K + 1 <= hps_cuda.MAX_AUX
    x = _res((5, 16, n), q, seed=16)
    keep, aux = rs.rescale_extend(x.to(cuda), mc.q_to_aux)
    want_keep, want_aux = rs.rescale_extend(x, mc.q_to_aux)
    _eq(keep, want_keep)
    _eq(aux, want_aux)
    d_q, d_aux = _res((5, 14, n), q[:14], seed=17), _res((5, mc.K + 1, n), mc.aux_primes, 18)
    _eq(mc.scale_round_to_q(d_q.to(cuda), d_aux.to(cuda)), mc.scale_round_to_q(d_q, d_aux))
    with pytest.raises(ValueError, match="1 to 16"):
        hps_cuda.rescale_extend(torch.zeros((1, 17, n), dtype=torch.int32, device=cuda),
                                extension=mc.q_to_aux)


def test_rounding_boundaries(cuda):
    """The centred rescale's dropped residue near its prime's half, and the
    overflow counts' fractions at one half and 0.5 +- 2^-40."""
    q, rs, mc = _main()
    x = torch.cat([_along_n(_boundary(q[5:]), q), _along_n(_boundary(q[:5]), q),
                   _along_n(_boundary(q), q)])
    keep, aux = rs.rescale_extend(x.to(cuda), mc.q_to_aux)
    want_keep, want_aux = rs.rescale_extend(x, mc.q_to_aux)
    _eq(keep, want_keep)
    _eq(aux, want_aux)
    x5 = _along_n(_boundary(q[:5]), q[:5])
    _eq(mc.extend_q_to_aux(x5.to(cuda)), mc.extend_q_to_aux(x5))
    ship = RNSRescale(q[:5], 1)
    _eq(ship.rescale(x5.to(cuda)), ship.rescale(x5))
    full = BFVMulConverter(q, T32, N)
    x6 = _along_n(_boundary(q), q)
    _eq(full.extend_q_to_aux(x6.to(cuda)), full.extend_q_to_aux(x6))


def test_wrapper_refuses_on_the_card(cuda):
    q, rs, mc = _main()
    x = _res((2, 6, 64), q, seed=1).to(cuda)
    with pytest.raises(TypeError):
        hps_cuda.rescale_extend(x.long(), rs)
    with pytest.raises(ValueError, match="contiguous"):
        hps_cuda.rescale_extend(x.transpose(0, 2).contiguous().transpose(0, 2), rs)
    with pytest.raises(ValueError, match="rescaler takes 6"):
        hps_cuda.rescale_extend(x[:, :5].contiguous(), rs)
    d_q = _res((3, 5, 64), q[:5], seed=2).to(cuda)
    d_aux = _res((3, mc.K + 1, 64), mc.aux_primes, seed=3).to(cuda)
    with pytest.raises(ValueError, match="differ"):
        hps_cuda.scale_exact(d_q[:2], d_aux, mc)


# ---- the multiply on the card against the CPU -----------------------------

def _contexts(cuda):
    from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
    from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams

    sp = SchemeParams(ring_dim=N, plaintext_modulus=T32, num_limbs=6, scheme="bfv")
    cpu = make_context(sp, seed=0, device="cpu")
    sk, _ = cpu.keygen()
    rlk = cpu.relin_keygen(sk)
    return cpu, make_context(sp, seed=0, device=cuda), rlk


def test_hps_mul_relin_rescaled_matches_the_cpu(cuda):
    """The cells' product (D = 12, 6 -> 5 limbs, shipped on 4) and a product
    whose first operand already lies on 5 limbs, on the card and on the CPU;
    the card's launches the HPS kernels."""
    cpu, gpu, rlk = _contexts(cuda)
    grlk = RelinKey(rlk.b_mont.to(cuda), rlk.a_mont.to(cuda))
    q = list(cpu.q_primes)
    a, b = _res((12, 2, 6, N), q, seed=21), _res((12, 2, 6, N), q, seed=22)
    want = cpu.hps_mul_relin_rescaled(Ciphertext(a, "bfv"), Ciphertext(b, "bfv"), rlk, 5,
                                      ship_limbs=4)
    got, n = _launches(lambda: gpu.hps_mul_relin_rescaled(
        Ciphertext(a.to(cuda), "bfv"), Ciphertext(b.to(cuda), "bfv"), grlk, 5, ship_limbs=4))
    assert n == 4  # rescale + extension, tensor products, scale + return, ship rescale
    _eq(got.data, want.data)
    a5 = _res((12, 2, 5, N), q[:5], seed=23)
    want = cpu.hps_mul_relin_rescaled(Ciphertext(a5, "bfv"), Ciphertext(b, "bfv"), rlk, 5,
                                      a_limbs=5)
    got, n = _launches(lambda: gpu.hps_mul_relin_rescaled(
        Ciphertext(a5.to(cuda), "bfv"), Ciphertext(b.to(cuda), "bfv"), grlk, 5, a_limbs=5))
    assert n == 4  # b's rescale, the extension, tensor products, scale + return
    _eq(got.data, want.data)


def test_full_basis_mul_relin_matches_the_cpu(cuda):
    """The flat BFV product (``ct_ct_mul_relin``, HPS on all 6 limbs)."""
    cpu, gpu, rlk = _contexts(cuda)
    grlk = RelinKey(rlk.b_mont.to(cuda), rlk.a_mont.to(cuda))
    q = list(cpu.q_primes)
    a, b = _res((4, 2, 6, N), q, seed=31), _res((4, 2, 6, N), q, seed=32)
    want = cpu.ct_ct_mul_relin(Ciphertext(a, "bfv"), Ciphertext(b, "bfv"), rlk)
    got, n = _launches(lambda: gpu.ct_ct_mul_relin(
        Ciphertext(a.to(cuda), "bfv"), Ciphertext(b.to(cuda), "bfv"), grlk))
    assert n == 3  # the extension, tensor products, scale + return
    _eq(got.data, want.data)
