"""Matrix-product bounds on a four-step NTT, beside K1 and K3.

Counterpart of ``benchmarks/bench_ntt_f32mxu.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_f32mxu [--device cuda]

The question of the JAX probe: could a stage-matmul formulation of the
four-step NTT (m1 = m2 = 128 at n = 2^14) beat the butterfly kernel? An
exact float32 product needs K * 2^(2b) <= 2^24, so at K = 128 the digits
are 8 bits wide and a stage costs 16 separate (128, 128) @ (128, 128)
digit-pair products per polynomial; the int8 form stacks 5 digit planes of
7 bits along the contraction. This times the three matrix-product forms of
the JAX probe at its shapes (``TB`` = 64 polynomials' stage work per
call), calls issued back to back (CUDA events), and turns calls/s into an
upper bound on limb-NTT/s (two stages a transform, twiddles and
recombination not counted):

  f32 16 digit-pair products batched      torch.bmm, float32 (TF32 off)
  f32 one dense (32768,128) @ (128,512)   torch.mm, float32 (TF32 off)
  int8 5 x 7-bit stacked stage            torch._int_mm, int8 -> int32

Float32 products run with ``torch.backends.cuda.matmul.allow_tf32 =
False``, so they are exact IEEE float32, not TF32. In place of the JAX
probe's TPU baseline it prints K1's and K3's measured forward limb-NTT/s
on (64, 6, 2^14) from the same run, each a chain of transforms on the last
one's output (``timing.chain``), with the card's name and power limit.
``--device cpu`` runs everything on the host; the tests call ``run`` at
small sizes.
"""

from __future__ import annotations

import argparse
import json

import torch

from nested_hashing_psi_tpu_torch.benchmarks import card
from nested_hashing_psi_tpu_torch.benchmarks.timing import chain, time_ms
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, ntt_mxu
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

N = 1 << 14
M = 128    # m1 = m2 = 128
TB = 64    # polynomial tiles per call (64 polynomials' stage work)
LIMBS = 6


def matmul_rates(device: torch.device, m: int = M, tb: int = TB, iters: int = 30) -> dict:
    """calls/s of the three product forms."""
    gen = torch.Generator(device=device).manual_seed(0)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=device).to(dtype)

    g8 = ints(0, 255, (16, m, m), torch.float32)
    x32 = ints(0, 255, (16, tb * m, m), torch.float32)
    xbig = ints(0, 255, (4 * tb * m, m), torch.float32)
    gbig = ints(0, 255, (m, 4 * m), torch.float32)
    # dot_general(Gi (5, m, 5m), Xi (tb, 5m, m)) over the 5m axis: one
    # (5m, 5m) @ (5m, tb m) product of the same multiply-adds
    gi = ints(-127, 127, (5 * m, 5 * m), torch.int8)
    xi = ints(0, 127, (5 * m, tb * m), torch.int8)
    forms = {
        "f32_digit_pair_stage": lambda: torch.bmm(x32, g8),
        "f32_single_dense": lambda: torch.mm(xbig, gbig),
        "int8_stacked_stage": lambda: torch._int_mm(gi, xi),
    }
    out = {}
    for name, fn in forms.items():
        ms = time_ms(fn, device, iters)
        out[name] = {"calls_s": 1e3 / ms, "ms": ms,
                     "limb_ntt_s_upper_bound": 1e3 / ms * tb / 2}
    return out


def kernel_rates(device: torch.device, n: int = N, batch: int = TB, limbs: int = LIMBS,
                 iters: int = 20) -> dict:
    """Forward limb-NTT/s of K1 and K3 on (batch, limbs, n) residues (the
    plain versions on the CPU)."""
    ps = ntt_primes(limbs, 31, 2 * n)
    plan, mplan = NTTPlan(n, ps), ntt_mxu.MxuNTTPlan(n, ps)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randint(0, min(ps), (batch, limbs, n), generator=gen, device=device,
                      dtype=torch.int32)
    out = {}
    for name, fn in (("k1", lambda a: ntt_cuda.ntt(a, plan)),
                     ("k3", lambda a: ntt_mxu.ntt_mxu(a, mplan))):
        ms = time_ms(chain(fn, x), device, iters)
        out[name] = {"ms": ms, "limb_ntt_s": batch * limbs / (ms / 1e3)}
    return out


def run(device: torch.device, m: int = M, tb: int = TB, n: int = N, batch: int = TB,
        iters: int = 30) -> dict:
    """The three products' rates beside K1's and K3's, printed and returned."""
    torch.backends.cuda.matmul.allow_tf32 = False  # exact float32 products
    where = card.card_line() if device.type == "cuda" else "cpu: host clock"
    mm = matmul_rates(device, m, tb, iters)
    for name, r in mm.items():
        print(f"[f32mxu] {name}: {r['calls_s']:.1f} calls/s -> <= "
              f"{r['limb_ntt_s_upper_bound']:,.0f} limb-NTT/s (matmuls only)", flush=True)
    kern = kernel_rates(device, n, batch, LIMBS, iters)
    print(f"[f32mxu] K1 {kern['k1']['limb_ntt_s']:,.0f} limb-NTT/s, K3 "
          f"{kern['k3']['limb_ntt_s']:,.0f} limb-NTT/s on ({batch}, {LIMBS}, {n}); {where}",
          flush=True)
    res = {"matmuls": mm, "kernels": kern, "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "card": where}
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    return run(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
