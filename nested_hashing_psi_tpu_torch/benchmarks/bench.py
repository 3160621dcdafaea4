"""The north-star bench of the port: prints ONE JSON line.

Counterpart of the root ``bench.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench [--device cuda]

Metric: K1's rate at n = 2^14 over L = 6 31-bit limbs, in single-limb
negacyclic transforms per second, HBM-resident (``hbm_batch`` 512: 201 MB
in and 201 MB out, beyond the card's 50 MB L2). ``vs_baseline`` divides it
by the card's roofline for a fused transform, one read and one write of
each residue at 3.35 TB/s (``card.ntt_roofline_rate``: 25.6 M/s).
``plain_hbm`` is the port's plain ``ops/ntt.py`` at the same batch,
``l2_resident`` K1 at ``l2_batch`` 16 (6.3 MB, inside the L2). Each rate is
a chain (every transform consumes the last one's output,
``timing.chain``) captured in one CUDA graph and replayed, timed by CUDA
events: the device's rate without the host's pace.

``pie_online`` times the whole batched-PIE online step at the
Parameters1.txt 2^20 x 2048 row (H = 2, D = P = 12, 16044 slots, ring
16384, BFV with the rescaled-mult pipeline; ``small_pie.bench_row``) in
four readings:

  ms_per_query_single  host clock around one query and a synchronise
  ms_per_query_steady  host clock over queries issued back to back on
                       the stream, ending in one synchronise
  ms_per_query_device  the same queries captured in one CUDA graph
  ms_per_query         Q = 32 queries, each followed by its on-device
                       decrypt (``DeviceDecryptor.zero_mask``) packed to
                       N/32 words, then one copy of the Q masks to the host

Query 0 of the Q = 32 run is the real query; the others rotate its index
ciphertexts, so no two are alike. Query 0's packed mask must equal the
host decrypt of a single run (``check_query0``), or the bench raises.
``first_call_s`` is the first query's wall time (tables built, the
kernel library loaded). The line names the card and its power limit.
``--device cpu`` runs the plain versions (host clocks; no device number);
the tests call ``ntt_rates``, ``small_pie.bench_row``, ``pie_online`` and
``headline`` at small sizes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.benchmarks import card, small_pie
from nested_hashing_psi_tpu_torch.benchmarks.timing import chain, graph_ms, wall_ms
from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
from nested_hashing_psi_tpu_torch.ops import ntt_cuda
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

N = 1 << 14
LIMBS = 6
L2_BATCH = 16      # 16 * 6 * 64 KiB = 6.3 MB: inside the 50 MB L2
HBM_BATCH = 512    # 512 * 6 * 64 KiB = 201 MB per direction


def ntt_rates(device: torch.device, n: int = N, limbs: int = LIMBS,
              hbm_batch: int = HBM_BATCH, l2_batch: int = L2_BATCH) -> dict:
    """K1 at the HBM and L2 batches, the plain NTT at the HBM batch:
    limb transforms/s of a chain replayed from a CUDA graph."""
    ps = ntt_primes(limbs, 31, 2 * n)
    plan = NTTPlan(n, ps)
    gen = torch.Generator(device=device).manual_seed(0)

    def data(batch):
        return torch.randint(0, min(ps), (batch, limbs, n), generator=gen, device=device,
                             dtype=torch.int32)

    def rate(fn, x, inner):
        return x.shape[0] * limbs / (graph_ms(chain(fn, x), device, inner) / 1e3)

    x_big = data(hbm_batch)
    out = {"k1": rate(lambda a: ntt_cuda.ntt(a, plan), x_big, 40),
           "plain": rate(lambda a: ntt(a, plan), x_big, 4)}
    del x_big
    out["l2"] = rate(lambda a: ntt_cuda.ntt(a, plan), data(l2_batch), 200)
    out["k1_bound_ms"], out["k1_bound_by"] = card.k1_bound(hbm_batch * limbs, limbs, n, False)
    out.update(n=n, limbs=limbs, hbm_batch=hbm_batch, l2_batch=l2_batch)
    return out


def pack_words(zero: torch.Tensor) -> torch.Tensor:
    """(D, N) per-slot zero mask -> (N/32,) words: bit j of word w is slot
    32 w + j of the mask's any over depths (little-endian, np.packbits)."""
    bits = zero.any(dim=0).reshape(-1, 32).to(torch.int64)
    return (bits << torch.arange(32, device=zero.device)).sum(dim=1)


def check_query0(words0: np.ndarray, host_slots) -> None:
    """Raise unless query 0's packed mask equals the host decrypt's."""
    want = np.packbits((np.asarray(host_slots, dtype=object) == 0).any(axis=0).astype(np.uint8),
                       bitorder="little").view(np.uint32)
    if not np.array_equal(np.asarray(words0, dtype=np.uint32), want):
        raise RuntimeError("pipelined mask mismatch: query 0's packed device mask differs "
                           "from the host decrypt")


def pie_online(built: small_pie.SmallPIE, device: torch.device, queries: int = 32,
               iters: int = 10, steady_iters: int = 20) -> dict:
    """The four readings of the online step of ``built`` (see the module)."""
    ctx, sk, rlk, pie, ops, idx_ct, minus_ct = built
    idx, minus = idx_ct.data, minus_ct.data

    def query():
        return pie.run(idx_ct, minus_ct)

    first_call_s = wall_ms(query, device, 1, warm=0) / 1e3
    single_ms = sum(wall_ms(query, device, 1, warm=0) for _ in range(iters)) / iters
    steady_ms = wall_ms(lambda: pie(idx, minus), device, steady_iters)
    device_ms = graph_ms(lambda: pie(idx, minus), device, steady_iters)
    out = query()

    L_ship = pie.ship_limbs or ctx.L
    sctx, ssk = ctx.context_for_limbs(L_ship), ctx.shrink_key_to(sk, L_ship)
    dec = DeviceDecryptor(sctx)
    idx_b = torch.stack([torch.roll(idx, q, dims=-1) for q in range(queries)])

    def pipeline() -> np.ndarray:
        words = torch.stack([pack_words(dec.zero_mask(pie(idx_b[q], minus).data, ssk.s_mont))
                             for q in range(queries)])
        return words.cpu().numpy().astype(np.uint32)

    masks = pipeline()
    slots, _ = ctx.decrypt(out, sk)
    check_query0(masks[0], slots)
    best = min(wall_ms(pipeline, device, 1, warm=0) for _ in range(3)) / queries

    return {
        "config": f"Parameters1.txt row 12 (server 2^20, client 2048) geometry: H={pie.H} "
                  f"D={pie.D} P={pie.P}, {pie.batch_slots} slots, ring {ctx.n}",
        "H": pie.H, "D": pie.D, "P": pie.P, "limbs": ctx.L, "mul_limbs": pie.mul_limbs,
        "ship_limbs": pie.ship_limbs, "batch_slots": pie.batch_slots,
        "ms_per_query": best, "pipeline_Q": queries,
        "ms_per_query_single": single_ms, "ms_per_query_steady": steady_ms,
        "ms_per_query_device": device_ms,
        "depth_rows_per_sec": pie.D / (device_ms / 1e3),
        "first_call_s": first_call_s,
        "query0_mask_equals_host_decrypt": True,
    }


def headline(rates: dict, pie: dict, device: torch.device) -> dict:
    """The JSON line: the JAX bench's keys where their meaning carries over."""
    on_card = device.type == "cuda"
    n, limbs, hbm_batch = rates["n"], rates["limbs"], rates["hbm_batch"]
    return {
        "metric": f"ntt_per_sec_per_chip_n{n}",
        "value": rates["k1"],
        "unit": "limb-transforms/s",
        # shares of the card's roofline and of K1's bound only from a card's rate
        "vs_baseline": rates["k1"] / card.ntt_roofline_rate(n) if on_card else None,
        "roofline": card.ntt_roofline_rate(n),
        "k1_bound_share": (rates["k1_bound_ms"] / 1e3 * rates["k1"] / (hbm_batch * limbs)
                           if on_card else None),
        "resident": "hbm",
        "hbm_batch": hbm_batch,
        "plain_hbm": rates["plain"],
        "l2_resident": rates["l2"],
        "l2_batch": rates["l2_batch"],
        "limbs": limbs,
        "pie_online": pie,
        "device": device.type,
        "card": card.card_line() if on_card else "none (cpu: host clocks)",
        "timing": "rates and ms_per_query_device: CUDA events around the replays of one CUDA "
                  "graph (the rates' graphs chain each transform on the last one's output); "
                  "the other readings: the host clock ending in a synchronise",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    rates = ntt_rates(device)
    pie = pie_online(small_pie.bench_row(device=device), device)
    result = headline(rates, pie, device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
