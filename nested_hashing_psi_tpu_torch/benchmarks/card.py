"""The card's peak rates and the kernels' bounds, in one place.

``chip_smoke.py``, ``bench.py`` and the other tools read the H100's memory
rate, its integer rates and the least time each kernel could take from
here, and the card's name and power limit from ``card_line``
(``nvidia-smi``).
"""

from __future__ import annotations

import subprocess

# H100 SXM peaks for the bounds: 3.35 TB/s of HBM3 and 1,979 T int8
# tensor-core ops/s (NVIDIA's data sheet). 32-bit integer instructions run
# on two pipes of 64 lanes per clock per SM (CUDA C Programming Guide,
# compute capability 9.0): multiplies on the FMA pipe, min/max and the
# fused add-min on the ALU pipe, adds on either; the four schedulers issue
# one warp instruction per clock each, 128 lanes per clock per SM in all,
# which a mix balanced over the two pipes reaches: 128 x 132 SMs x 1.98 GHz
# = 33.5 T ops/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
INT32_OPS_S = 128 * 132 * 1.98e9
# A butterfly: a Shoup product (IMAD.HI, IMAD, IMAD on the FMA pipe; a
# VIADDMNMX conditional subtract), an add_mod and a sub_mod (an IADD3 and a
# VIADDMNMX each): 8 instructions, 3 of them tied to the FMA pipe and 3 to
# the ALU pipe, so they balance.
BUTTERFLY_OPS = 8
SHOUP_OPS = 4       # the inverse's n^-1: a second Shoup product in its last stage
# A 32x32->64 multiply (IMAD.WIDE, IMAD.HI) takes two slots of the FMA pipe,
# which has half of the 128 lanes: INT32_OPS_S / 4 = 8.4 T/s, as the probe A1
# measured it (benchmarks/bench_vpu_ops.py, mix mulhi: 8.3 T/s).
WIDE_MUL_S = INT32_OPS_S / 4
# The decrypt kernel's products, in slots of the FMA pipe (half the 128
# lanes): a 64-bit Shoup product is the high half of x * wq (four wide
# 32x32->64 products) and the low halves of x * w and q * t (one wide and
# two low products each), 6 wide and 4 low, 16 slots; a coefficient's limb
# takes a 32-bit Shoup product (3) and y times the 96-bit constant (three
# wide products, 6), and under BGV a 64-bit Shoup product more.
FMA_SLOTS_S = INT32_OPS_S / 2
SHOUP64_SLOTS = 16
CRT_LIMB_SLOTS = 9


def bound(ops: float, ops_per_s: float, nbytes: float) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(rows: int, L: int, n: int, inverse: bool) -> tuple[float, str]:
    """K1 on rows x n residues: n/2 log n butterflies per row (plus, for the
    inverse, n/2 Shoup products for the n^-1 scale folded into its last
    stage); each row read and written once, plus the twiddle pairs of the L
    primes."""
    logn = n.bit_length() - 1
    ops = rows * (n // 2) * (logn * BUTTERFLY_OPS + (SHOUP_OPS if inverse else 0))
    return bound(ops, INT32_OPS_S, rows * n * 8 + L * n * 8 + L * 12)


def k2_bound(H: int, D: int, P: int, L: int, N: int, acc: bool = False) -> tuple[float, str]:
    """K2: index (H,P,2,L,N) and the P table positions read once, out
    (H,D,2,L,N) written once (with acc, also read once); its operations are
    the two exact 32x32->64 products per table word at WIDE_MUL_S (each
    output's one reduction and the adds run beside them)."""
    out = H * D * 2 * L * N
    return bound(2 * H * D * P * L * N, WIDE_MUL_S,
                 4 * (H * P * 2 * L * N + H * D * P * L * N + out * (2 if acc else 1)) + 8 * L)


def decrypt_bound(rows: int, L: int, n: int, length: int, bgv: bool) -> tuple[float, str]:
    """The decrypt kernel on rows x L x n phase words: each read once, the
    (rows, length) mask written once, the twiddle table (2n words of 8
    bytes) and s2n read once; its operations the FMA-pipe slots of its
    products: the CRT of every coefficient's limbs, then n/2 log n
    butterflies of one 64-bit Shoup product each."""
    logn = n.bit_length() - 1
    per_limb = CRT_LIMB_SLOTS + (SHOUP64_SLOTS if bgv else 0)
    slots = rows * (n * L * per_limb + n // 2 * logn * SHOUP64_SLOTS)
    return bound(slots, FMA_SLOTS_S, rows * (L * n * 4 + length) + n * 20 + L * 64 + 32)


def k3_bound(rows: int, L: int, n: int, m1: int, digits: int) -> tuple[float, str]:
    """K3: two digit-stacked matrix stages per row, digits^2 * n * (m1 + m2)
    int8 multiply-adds (2 ops each); rows read and written once plus the
    int8 digit matrices and twiddles of the L primes."""
    m2 = n // m1
    macs = rows * digits * digits * n * (m1 + m2)
    table_bytes = L * digits * digits * (m1 * m1 + m2 * m2) + L * n * 8
    return bound(2 * macs, INT8_OPS_S, rows * n * 8 + table_bytes)


def ntt_roofline_rate(n: int) -> float:
    """Limb transforms/s if each residue of a transform is read once and
    written once at HBM_BYTES_S and nothing else limits it (bench.py's
    ``vs_baseline`` divides by this): 25.6 M/s at n = 16384."""
    return HBM_BYTES_S / (2 * n * 4)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or a note."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except OSError:
        out = []
    return out[0] if out else "nvidia-smi unavailable"
