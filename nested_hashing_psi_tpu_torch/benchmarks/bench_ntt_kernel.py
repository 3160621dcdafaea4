"""K1 alone: forward and inverse rates, by form and batch.

Counterpart of ``benchmarks/bench_ntt_kernel.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_kernel [form:batch ...]
        [--device cuda]

Each argument is ``form:batch`` (default ``auto:512``): the form is
``auto`` (the kernel's own choice from n), ``whole`` (``ntt_cuda.WHOLE_ROW``)
or ``split`` (``ntt_cuda.SPLIT``), the batch the leading dimension of a
(batch, 6, 16384) input of 31-bit residues. Forward and inverse are each
timed as a chain, every transform consuming the last one's output
(``timing.chain``), launched back to back and timed by CUDA events after
warm-ups; the line gives limb transforms/s and the share of K1's bound
(``card.k1_bound``) with the card's name and power limit. ``--device cpu``
times the plain version on the host clock; the tests call ``rates`` and
``run_chain`` at small sizes.
"""

from __future__ import annotations

import argparse
import json

import torch

from nested_hashing_psi_tpu_torch.benchmarks import card
from nested_hashing_psi_tpu_torch.benchmarks.timing import chain, time_ms
from nested_hashing_psi_tpu_torch.ops import ntt_cuda
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

N = 1 << 14
LIMBS = 6
FORMS = {"auto": None, "whole": ntt_cuda.WHOLE_ROW, "split": ntt_cuda.SPLIT}


def transform(plan: NTTPlan, inverse: bool, form: str):
    """K1 in ``form`` on a CUDA tensor, the plain version on a CPU one."""
    code = FORMS[form]

    def fn(x):
        if not x.is_cuda:
            return intt(x, plan) if inverse else ntt(x, plan)
        if code is None:
            return ntt_cuda.intt(x, plan) if inverse else ntt_cuda.ntt(x, plan)
        return ntt_cuda._launch(x, plan, inverse, form=code)
    return fn


def run_chain(x: torch.Tensor, plan: NTTPlan, inverse: bool, form: str, k: int) -> torch.Tensor:
    """x transformed k times over, each transform on the last one's output."""
    fn = transform(plan, inverse, form)
    for _ in range(k):
        x = fn(x)
    return x


def rates(form: str, batch: int, device: torch.device, n: int = N, limbs: int = LIMBS,
          iters: int = 20) -> dict:
    ps = ntt_primes(limbs, 31, 2 * n)
    plan = NTTPlan(n, ps)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(0, min(ps), (batch, limbs, n), generator=gen, device=device,
                      dtype=torch.int32)
    out = {"form": form, "batch": batch, "limbs": limbs, "n": n}
    for name, inverse in (("fwd", False), ("inv", True)):
        ms = time_ms(chain(transform(plan, inverse, form), x), device, iters)
        bound_ms, bound_by = card.k1_bound(batch * limbs, limbs, n, inverse)
        out.update({f"{name}_ms": ms, f"{name}_limb_transforms_s": batch * limbs / (ms / 1e3),
                    f"{name}_bound_ms": bound_ms, f"{name}_bound_by": bound_by,
                    f"{name}_share": bound_ms / ms if device.type == "cuda" else None})
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*", default=["auto:512"], help="form:batch ...")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    where = card.card_line() if device.type == "cuda" else "cpu: the plain version, host clock"
    results = []
    for spec in a.specs:
        form, _, batch = spec.partition(":")
        if form not in FORMS:
            raise ValueError(f"form {form!r} is not one of {sorted(FORMS)}")
        r = rates(form, int(batch or 512), device)
        results.append(r)
        print(f"[bench_ntt_kernel] form={form} batch={r['batch']} (x{LIMBS}x{N}): fwd "
              f"{r['fwd_limb_transforms_s']:,.0f} limb-NTT/s ({r['fwd_ms']:.4f} ms, share "
              f"{r['fwd_share']})   inv {r['inv_limb_transforms_s']:,.0f} ({r['inv_ms']:.4f} "
              f"ms, share {r['inv_share']}); {where}", flush=True)
    print(json.dumps({"bench_ntt_kernel": results, "card": where}), flush=True)
    return results


if __name__ == "__main__":
    main()
