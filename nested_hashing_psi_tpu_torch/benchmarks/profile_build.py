"""Profile the port's server offline build at a chosen scale, by stage.

Counterpart of ``benchmarks/profile_build.py``:

    python -m nested_hashing_psi_tpu_torch.benchmarks.profile_build [log2_items]
        [--simpleSize S] [--inner I] [--device cuda]

  gen     -- RandomDataInput server-set generation
  hash    -- tabulation hashing of every (item, simple hash function) pair
  insert  -- HierarchicalCuckooHashTable.insert_all (includes hash), under
             cProfile (its top functions by cumulative time are printed)
  encode  -- the whole BatchedFHEPIE build on the device at ring 16384 and
             the client's L (depth shuffle, mask fold, packed encode, K1 on
             each slab), split into PackedEncoder.encode (host NTT mod t),
             PackedEncoder.to_rns (host), K1 (the slab NTTs, timed between
             device synchronisations) and the rest.

The default geometry is the JAX script's (Parameters1.txt row 24's 8022
simple slots, inner tables scaled to the load; log2_items 22);
``--simpleSize``/``--inner`` set the BatchedFHE rows' (the 2^20 main row:
8022 and 12; the north star, bench_e2e_psi's: 4505 and 48).
``NHPSI_RING_DIM`` overrides the ring, as in the CLI. ``main`` returns the
stages' seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import time

import torch

from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.fhe.encoding import PackedEncoder
from nested_hashing_psi_tpu_torch.fhe.params import (
    SchemeParams,
    bfv_batched_client_limbs,
    plaintext_modulus_for_bit_size,
)
from nested_hashing_psi_tpu_torch.hashing import HierarchicalCuckooHashTable, TabulationHashing
from nested_hashing_psi_tpu_torch.ops import ntt_cuda
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import _sync, resolve_device


@contextlib.contextmanager
def timed_methods(targets, device: torch.device, totals: dict[str, float]):
    """Time every call of each (class, method name, label) in ``targets``
    into ``totals[label]`` (the device synchronised before and after each
    call); the methods are restored on exit."""
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in targets]

    def wrap(fn, label):
        def run(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(device)
            totals[label] = totals.get(label, 0.0) + time.perf_counter() - t0
            return out
        return run

    try:
        for (cls, name, fn), (_, _, label) in zip(saved, targets):
            setattr(cls, name, wrap(fn, label))
        yield totals
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _top(prof: cProfile.Profile, n: int) -> str:
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(n)
    return out.getvalue()


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
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    hct.insert_all(server)
    prof.disable()
    t_ins = time.perf_counter() - t0
    print(f"insert_all: {t_ins:.3f}s ({2 * n / t_ins / 1e6:.2f} M pairs/s)", flush=True)
    print(_top(prof, 14), flush=True)

    ctx = make_context(SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=L,
                                    scheme="bfv"), seed=1, device=device)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    _sync(device)
    ntt_cuda.reset_launches()
    parts: dict[str, float] = {}
    with timed_methods([(PackedEncoder, "encode", "packed_encode"),
                        (PackedEncoder, "to_rns", "to_rns"),
                        (BGVContext, "_ntt_fast", "k1")], device, parts):
        t0 = time.perf_counter()
        pie = BatchedFHEPIE(ctx, hct, rlk, mask_seed=1)
        _sync(device)
        t_enc = time.perf_counter() - t0
    rows = pie.H * pie.D * pie.P
    parts["rest"] = t_enc - sum(parts.values())
    print(f"encode: {t_enc:.3f}s for {rows} table rows + {pie.D} mask rows, table "
          f"{tuple(pie.table_pt.shape)} ({pie.table_pt.numel() * 4 / 1e9:.3f} GB); of which "
          + ", ".join(f"{k} {v:.3f}s" for k, v in parts.items())
          + f"; K1 launches {ntt_cuda.launches['ntt'] + ntt_cuda.launches['intt']}", flush=True)
    out = {"log2_items": a.log2_items, "simple": simple, "inner": inner, "ring": ring, "L": L,
           "device": str(device), "gen_s": t_gen, "hash_s": t_hash, "insert_s": t_ins,
           "encode_s": t_enc, **{f"encode_{k}_s": v for k, v in parts.items()},
           "table_bytes": pie.table_pt.numel() * 4}
    print(f"[profile_build] {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
