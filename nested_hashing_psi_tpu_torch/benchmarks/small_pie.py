"""A seeded batched-FHE PIE with its keys and one query, for the tools.

Counterpart of ``__graft_entry__._build_small_pie``, which the JAX
package's ``bench.py``, ``benchmarks/profile_online.py`` and
``benchmarks/scaling_report.py`` build on. The hierarchical table, its
item placement, the client's cuckoo table and the PIE's packed table and
masks are deterministic and equal the JAX builder's for the same
arguments; the keys and the query's noise come from the context's own
generator. ``bench_row`` builds the bench geometry: the Parameters1.txt
2^20-server x 2048-client row (H = 2, D = P = 12, 8022 simple slots per
table, ring 16384, 32-bit items, the client's limbs from
``bfv_batched_client_limbs``), under BFV with the rescaled-mult pipeline
(``mul_limbs`` and ``ship_limbs`` from the noise model).
"""

from __future__ import annotations

from typing import NamedTuple

from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext, RelinKey, SecretKey
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, bfv_batched_client_limbs
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEClientOps, BatchedFHEPIE
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1  # the 32-bit items' plaintext modulus
# the bench row: Parameters1.txt's 2^20 x 2048 2HF equal-block row
BENCH_ROW = dict(ring=1 << 14, H=2, D=12, P=12, simple=8022, t=T32)
CLIENT_ITEMS = (105, 131, 9999)  # 105 and 131 are server items, 9999 is not


class SmallPIE(NamedTuple):
    """What the builder returns (the JAX builder's 7-tuple, by name)."""

    ctx: BGVContext
    sk: SecretKey
    rlk: RelinKey
    pie: BatchedFHEPIE
    ops: BatchedFHEClientOps
    idx_ct: Ciphertext
    minus_ct: Ciphertext


def tables(H: int = 2, P: int = 8, D: int = 4, simple: int = 64, seed: int = 1):
    """(server hierarchical table, client cuckoo table): 3 * simple server
    items 100, 101, ... and the client items ``CLIENT_ITEMS``, inserted with
    the JAX builder's seeds."""
    n_simple_hf = 2
    hasher = TabulationHashing(987654321, n_simple_hf + H)
    hct = HierarchicalCuckooHashTable(
        hasher,
        each_simple_table_size=simple,
        each_cuckoo_table_size=P,
        n_simple_hash_functions=n_simple_hf,
        n_cuckoo_hash_functions=H,
        max_items_per_position=D,
        seed=seed,
    )
    hct.insert_all(items_from_ints(list(range(100, 100 + simple * 3))))
    client_table = CuckooHashTable(
        hasher,
        each_table_size=simple,
        n_hash_functions=n_simple_hf,
        max_items_per_position=1,
        seed=seed + 1,
    )
    client_table.insert_all(items_from_ints(list(CLIENT_ITEMS)))
    return hct, client_table


def build_small_pie(ring: int = 512, limbs: int = 6, H: int = 2, P: int = 8, D: int = 4,
                    simple: int = 64, seed: int = 1, t: int = 65537, scheme: str = "bgv",
                    *, device="cuda") -> SmallPIE:
    """The PIE over ``tables(...)``, its context (seeded), keys and one
    encrypted query, on ``device`` (``cuda`` raises without a card)."""
    device = resolve_device(device)
    if 2 * simple > ring:
        raise ValueError(f"2 x {simple} simple slots do not fit ring {ring}")
    hct, client_table = tables(H, P, D, simple, seed)
    ctx = make_context(
        SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=limbs, scheme=scheme),
        seed=seed, device=device,
    )
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    pie = BatchedFHEPIE(ctx, hct, rlk, mask_seed=seed + 2)
    ops = BatchedFHEClientOps(ctx, client_table, 2, H, P)
    idx_ct, minus_ct = ops.encrypt_query(sk)
    return SmallPIE(ctx, sk, rlk, pie, ops, idx_ct, minus_ct)


def bench_row(*, device="cuda", **over) -> SmallPIE:
    """``build_small_pie`` at ``BENCH_ROW`` (any of its keys overridden, for
    a small run on the CPU) under BFV, with the client's limb count."""
    row = {**BENCH_ROW, **over}
    limbs = bfv_batched_client_limbs(row["t"].bit_length(), row["P"], row["H"])
    return build_small_pie(ring=row["ring"], limbs=limbs, H=row["H"], P=row["P"], D=row["D"],
                           simple=row["simple"], t=row["t"], scheme="bfv", device=device)
