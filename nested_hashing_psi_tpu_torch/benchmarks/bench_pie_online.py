"""The batched-PIE online step at the JAX tool's sweep configurations.

Counterpart of ``benchmarks/bench_pie_online.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_pie_online
        [--config small|2^16|2^20|2^24] [--limbs L] [--device cuda]

Reference sweep rows (Performance-Evaluation/Parameters1.txt), e.g. 1024
clients vs a 2^20 server: nSimpleHF = 2, simpleSize = 4949, maxPP = 14,
cuckooSize = 14; the 2^24 / 512 row: simpleSize = 3053, maxPP = 58. The
table, masks, index and minus ciphertexts are synthetic residues below the
smallest prime, drawn on the device from a seeded ``torch.Generator`` (the
2^24 table is 3.08 GB; hashing correctness is the tests' business), and the
PIE is built from them by ``BatchedFHEPIE.from_artifact``. The context is
BGV at t = 65537 with the config's limbs (the JAX tool's), so the step is
K2 and the flat BGV product with its relinearisation.

Prints the step's ms (the host clock over back-to-back queries ending in
one synchronise, after a warm-up), its ct x pt modmul rate and table
stream rate, and K2 alone at the table's shape (CUDA events over calls
back to back) beside its bound (``card.k2_bound``) and share, with the
card's name and power limit. K2's result at that shape is held to its
plain version (``pie_kernels.indexed_inner_product_plain``) on the same
tensors, ``K2_CHECK_DEPTHS`` depths of the table at a time (``k2_plain``,
also timed), bit-exact; a difference raises before any time is printed.
``--device cpu`` runs the plain versions; the tests call ``run`` with a
small ring.
"""

from __future__ import annotations

import argparse
import json

import torch

from nested_hashing_psi_tpu_torch.benchmarks import card
from nested_hashing_psi_tpu_torch.benchmarks.timing import time_ms, wall_ms
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.ops import pie_kernels
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE, position_sum
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

CONFIGS = {
    # name: (H, D=maxPP, P=cuckooSize, simple_size, n_simple, limbs)
    "small": (2, 6, 6, 442, 2, 7),
    "2^16": (2, 12, 12, 442, 2, 7),
    "2^20": (2, 14, 14, 4949, 2, 7),
    "2^24": (2, 58, 58, 3053, 2, 7),
}
# depths of the table per plain product in K2's check: at P = 58, L = 7 the
# plain version's int64 products take 8 x 2 x 58 x 2 x 7 x 16384 x 8 B = 1.7 GB
K2_CHECK_DEPTHS = 8


def synthetic_pie(config: str, device: torch.device, limbs: int | None = None,
                  ring: int = 16384, seed: int = 0) -> tuple[BatchedFHEPIE, torch.Tensor,
                                                              torch.Tensor]:
    """(PIE, index ciphertexts (H, P, 2, L, N), minus (2, L, N)) of a config,
    every residue drawn on ``device``."""
    H, D, P, simple, n_simple, L = CONFIGS[config]
    L = limbs or L
    batch = simple * n_simple
    if batch > ring:
        raise ValueError(f"{batch} slots do not fit ring {ring}")
    ctx = BGVContext(SchemeParams(ring_dim=ring, plaintext_modulus=65537, num_limbs=L),
                     seed=1, device=device)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    gen = torch.Generator(device=device).manual_seed(seed)
    pmin = min(ctx.q_primes)

    def residues(*shape):
        return torch.randint(0, pmin, shape, generator=gen, device=device, dtype=torch.int32)

    table, mask = residues(H, D, P, L, ring), residues(D, L, ring)
    pie = BatchedFHEPIE.from_artifact(ctx, rlk, table, mask, H, D, P, batch)
    return pie, residues(H, P, 2, L, ring), residues(2, L, ring)


def k2_plain(pie: BatchedFHEPIE, idx: torch.Tensor) -> torch.Tensor:
    """K2's plain version over the whole table, ``K2_CHECK_DEPTHS`` depths
    at a time: (H, D, 2, L, N)."""
    ctx, table = pie.ctx, pie.table_pt
    return torch.cat([pie_kernels.indexed_inner_product_plain(
        idx, table[:, d0:d0 + K2_CHECK_DEPTHS], ctx.p, ctx.pinv)
        for d0 in range(0, table.shape[1], K2_CHECK_DEPTHS)], dim=1)


def k2_max_abs_err(pie: BatchedFHEPIE, idx: torch.Tensor) -> int:
    """K2's position sum over the whole table against ``k2_plain`` on the
    same tensors: the largest absolute difference (0: bit-exact)."""
    got = position_sum(pie.ctx, idx, pie.table_pt)
    return int((got.long() - k2_plain(pie, idx).long()).abs().max())


def run(config: str, device: torch.device, limbs: int | None = None, ring: int = 16384,
        iters: int = 5) -> dict:
    pie, idx, minus = synthetic_pie(config, device, limbs, ring)
    H, D, P, L, N = pie.table_pt.shape
    table_bytes = pie.table_pt.numel() * 4
    print(f"[bench_pie_online] config {config}: H={H} D={D} P={P} batch={pie.batch_slots} "
          f"L={L} N={N}; table plaintext tensor {table_bytes / 1e9:.2f} GB", flush=True)
    err = k2_max_abs_err(pie, idx)
    if err:
        raise RuntimeError(f"K2 at ({H}, {D}, {P}, {L}, {N}) differs from its plain version "
                           f"(max_abs_err {err})")
    out = pie(idx, minus)
    pie_kernels.reset_launches()
    dt = wall_ms(lambda: pie(idx, minus), device, iters, warm=0) / 1e3
    k2_launches = pie_kernels.launches
    modmuls = H * D * P * 2 * L * N
    ctx = pie.ctx
    k2_ms = time_ms(lambda: position_sum(ctx, idx, pie.table_pt), device, 10)
    plain_ms = time_ms(lambda: k2_plain(pie, idx), device, 1)
    bound_ms, bound_by = card.k2_bound(H, D, P, L, N)
    res = {"config": config, "H": H, "D": D, "P": P, "L": L, "N": N,
           "batch_slots": pie.batch_slots, "table_bytes": table_bytes,
           "result_shape": list(out.data.shape), "online_ms": dt * 1e3,
           "ct_pt_gmodmuls_s": modmuls / dt / 1e9, "table_stream_GBs": table_bytes / dt / 1e9,
           "k2_launches": k2_launches, "k2_max_abs_err": err, "k2_ms": k2_ms,
           "k2_plain_ms": plain_ms,
           "k2_bound_ms": bound_ms, "k2_bound_by": bound_by, "device": device.type,
           # a share of the card's bound only from a card's time
           "k2_share": bound_ms / k2_ms if device.type == "cuda" else None,
           "card": card.card_line() if device.type == "cuda" else "none (cpu: host clocks)"}
    print(f"[bench_pie_online] online step: {res['online_ms']:.3f} ms "
          f"({res['ct_pt_gmodmuls_s']:.1f} G ct*pt modmuls/s, "
          f"{res['table_stream_GBs']:.0f} GB/s table stream); K2 {k2_ms:.4f} ms (max_abs_err "
          f"{err} vs plain, plain {plain_ms:.3f} ms), bound {bound_ms:.4f} ms ({bound_by}), share {res['k2_share']}; "
          f"{res['card']}", flush=True)
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="2^20", choices=CONFIGS)
    ap.add_argument("--limbs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    return run(a.config, resolve_device(a.device), a.limbs)


if __name__ == "__main__":
    main()
