"""Profile the port's server offline build at a chosen scale, by stage.

Counterpart of ``benchmarks/profile_build.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.profile_build [log2_items]
        [--simpleSize S] [--inner I] [--device cuda]

  gen     -- RandomDataInput server-set generation (host)
  hash    -- tabulation hashing of every (item, simple hash function) pair
             on the host (the reference's stage; the build hashes on the
             device)
  insert  -- the nested cuckoo insert on the device
             (``hashing.device_build.insert_hierarchical``), read from its
             ``build.insert`` span: seconds between two synchronises, the
             device's time between its events, rounds and evictions
  encode  -- the whole BatchedFHEPIE build on the device at ring 16384 and
             the client's L (depth shuffle, mask fold, packed encode, K1),
             read from its ``build.encode`` span, with its rows

The spans are the ones the server's ``run_offline_phase`` opens and the
benchmark's ``build_insert_s`` and ``build_encode_s`` read, so the tool and
the cell read one split. The default geometry is the JAX script's
(Parameters1.txt row 24's 8022 simple slots, inner tables scaled to the
load; log2_items 22); ``--simpleSize``/``--inner`` set the BatchedFHE rows'
(the 2^20 main row: 8022 and 12; the north star, bench_e2e_psi's: 4505 and
48). ``NHPSI_RING_DIM`` overrides the ring, as in the CLI. ``main`` returns
the stages' seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import (
    SchemeParams,
    bfv_batched_client_limbs,
    plaintext_modulus_for_bit_size,
)
from nested_hashing_psi_tpu_torch.hashing import HierarchicalCuckooHashTable, TabulationHashing
from nested_hashing_psi_tpu_torch.hashing.device_build import insert_hierarchical
from nested_hashing_psi_tpu_torch.ops import ntt_cuda
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
from nested_hashing_psi_tpu_torch.utils.device import resolve_device, synchronize
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER


def last_span(name: str) -> dict:
    """The last span ``name`` on the tracer: host seconds, device ms (None
    without a card) and its counts."""
    s = [x for x in TRACER.between(0, 2**63 - 1) if x.name == name][-1]
    return {"s": (s.end_ns - s.start_ns) / 1e9, "device_ms": s.device_ms, **(s.counts or {})}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2_items", type=int, nargs="?", default=22)
    ap.add_argument("--simpleSize", type=int, default=8022)
    ap.add_argument("--inner", type=int, default=0,
                    help="inner table size and depth (0: scaled to the load, as the JAX script)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    n, simple, H = 1 << a.log2_items, a.simpleSize, 2
    load = n / (2 * simple)  # items per outer cell (x2 simple hash functions)
    inner = a.inner or max(8, int((load * 1.16) ** 0.5 + 1))
    ring = int(os.environ.get("NHPSI_RING_DIM") or 16384)
    t = plaintext_modulus_for_bit_size(32)
    L = bfv_batched_client_limbs(t.bit_length(), inner, H, ring_dim=ring)
    print(f"[profile_build] n=2^{a.log2_items} simple={simple} inner={inner}x{inner} "
          f"ring={ring} L={L} device={device}", flush=True)

    t0 = time.perf_counter()
    server = RandomDataInput(n, 2048, 1025, 123456789, 32).get_server_set()
    t_gen = time.perf_counter() - t0
    print(f"gen: {t_gen:.3f}s ({n / t_gen / 1e6:.2f} M items/s)", flush=True)

    hasher = TabulationHashing(987654321, 4)
    t0 = time.perf_counter()
    for h in range(2):
        hasher.hash_index(server, h, simple)
    t_hash = time.perf_counter() - t0
    print(f"hash(2 simple hf): {t_hash:.3f}s ({2 * n / t_hash / 1e6:.2f} M hashes/s)", flush=True)

    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=simple, each_cuckoo_table_size=inner,
        n_simple_hash_functions=2, n_cuckoo_hash_functions=H,
        max_items_per_position=inner, seed=7,
    )
    insert_hierarchical(hct, server, device)
    ins = last_span("build.insert")
    print(f"insert (device): {ins['s']:.3f}s ({2 * n / ins['s'] / 1e6:.2f} M pairs/s), device "
          f"events {ins['device_ms']} ms, {ins['rounds']} rounds, {ins['evictions']} evictions, "
          f"{ins['attempts']} attempt(s)", flush=True)

    ctx = make_context(SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=L,
                                    scheme="bfv"), seed=1, device=device)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    synchronize(device)
    ntt_cuda.reset_launches()
    pie = BatchedFHEPIE(ctx, hct, rlk, mask_seed=1)
    enc = last_span("build.encode")
    print(f"encode (device): {enc['s']:.3f}s for {enc['rows']} rows ({pie.D} of them masks), "
          f"table {tuple(pie.table_pt.shape)} ({pie.table_pt.numel() * 4 / 1e9:.3f} GB), device "
          f"events {enc['device_ms']} ms; K1 launches "
          f"{ntt_cuda.launches['ntt'] + ntt_cuda.launches['intt']}", flush=True)
    out = {"log2_items": a.log2_items, "simple": simple, "inner": inner, "ring": ring, "L": L,
           "device": str(device), "gen_s": t_gen, "hash_s": t_hash, "insert_s": ins["s"],
           "insert_device_ms": ins["device_ms"], "rounds": ins["rounds"],
           "evictions": ins["evictions"], "encode_s": enc["s"],
           "encode_device_ms": enc["device_ms"], "rows": enc["rows"],
           "table_bytes": pie.table_pt.numel() * 4}
    print(f"[profile_build] {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
