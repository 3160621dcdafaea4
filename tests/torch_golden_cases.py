"""The reference's golden PIE tests, run through the port (no JAX).

The three functions follow ``tests/test_goldens_reference_scale.py`` line
for line, on the port's hashing copies, contexts and PIE engines, at the
reference's scale when ``ring`` is 16384 (its ``RING``):

- ``golden_fhe_pie`` (the reference's TestFHEPIE): 15,000 items in a bare
  100 x 100 cuckoo table with 3 hash functions, BFV with t = 2^32+2^20+2^19+1;
  the client's element, taken from the set, gives exactly one zero slot.
  SimpleFHE path: K1 in the ct x pt products and the EvalSum key switches.
- ``golden_batched_fhe_pie`` (TestBatchedFHEPIE): the nested 1 x 10 x 20
  table, 2 + 2 hash functions, 100 items, both batch slots carrying the
  client's element: exactly two zeros, one in each slot. BatchedFHE path:
  K2's position sum and K1 in the HPS multiply.
- ``golden_inner_product`` (TestFHEInnerP): known 12-slot vectors,
  EvalInnerProduct, EvalMerge and a wire round trip: slots [0, 1, 0, 1].

Each takes the device it runs on and the ring (a smaller ring for the CPU
parity tests, where the security bound is waived as the reference's
``SchemeParams.validate_security(allow_insecure=True)`` allows), raises
``AssertionError`` when a pass criterion fails (the same criteria and noise
bounds as the reference's tests), and returns its zero pattern, noise and
bound, seconds, the K1/K2 launches it made (kernel launches: 0 on the CPU)
and, for the parity tests, its tables and result ciphertext.
``tests/test_torch_kernels_gpu.py`` runs them on the card;
``tests/test_torch_goldens.py`` holds them against the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, default_num_limbs
from nested_hashing_psi_tpu_torch.hashing import HierarchicalCuckooHashTable, TabulationHashing
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE
from nested_hashing_psi_tpu_torch.protocol.channel import tensor_from_bytes, tensor_to_bytes
from nested_hashing_psi_tpu_torch.utils.device import synchronize

T_33 = (1 << 32) + (1 << 20) + (1 << 19) + 1  # reference 32-bit-items modulus
FIX_SEED = 122333444455555                    # reference test item seed
HASH_SEED = 12223222                          # reference test hasher seed
RING = 16384


def _random_items_mod_t(count: int, t: int, seed: int) -> list[int]:
    """Nonzero uniform draws mod t (the reference's randomBiginteger(mt) % n
    loop)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        v = int(rng.integers(0, 1 << 63, dtype=np.uint64)) % t
        if v:
            out.append(v)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _counts() -> dict:
    return {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
            "pie_ip": pie_kernels.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def golden_fhe_pie(device, ring: int = RING) -> dict:
    """TestFHEPIE semantics: 15,000 items / 100x100 table / 3 HFs / 33-bit t."""
    before, t0 = _counts(), time.perf_counter()
    n_items, table_size, bin_size, n_hf = 15000, 100, 100, 3
    items = _random_items_mod_t(n_items, T_33, FIX_SEED)
    client_elem = items[n_items // 2]

    hasher = TabulationHashing(HASH_SEED, 1 + n_hf)
    hct = HierarchicalCuckooHashTable(
        hasher,
        each_simple_table_size=1,          # bare cuckoo table (no outer split)
        each_cuckoo_table_size=table_size,
        n_simple_hash_functions=1,
        n_cuckoo_hash_functions=n_hf,
        max_items_per_position=bin_size,
        seed=5,
    )
    hct.insert_all(items_from_ints(items))
    stored = hct.table[..., 0]
    _check((stored != 0).sum() == n_items, "not all 15,000 items were inserted")

    limbs = default_num_limbs(T_33.bit_length(), 0, table_size, "bfv", eval_sum=True)
    ctx = make_context(
        SchemeParams(ring, T_33, num_limbs=limbs, scheme="bfv"), seed=11, device=device
    )
    ctx.params.validate_security(allow_insecure=ring != RING)  # log2(q) under HEStd_128
    sk, _ = ctx.keygen()
    gks = {k: v for k, v in ctx.galois_keygen(sk, ctx.sum_ladder_elements()).items()}

    pie = SimpleFHEPIE(ctx, hct, gks, mask_seed=17)

    # client: one-hot(hash pos) || -elem per hash function
    vec = np.zeros((1, n_hf, table_size + 1), dtype=object)
    item = items_from_ints([client_elem])
    for h in range(n_hf):
        pos = int(hasher.hash_index(item, 1 + h, table_size)[0])
        vec[0, h, pos] = 1
    vec[0, :, table_size] = -client_elem
    pt = ctx.make_plaintext_rns(vec.reshape(n_hf, table_size + 1))
    idx_ct = Ciphertext(ctx.encrypt_sk(pt, sk).data.reshape(1, n_hf, 2, ctx.L, ctx.n))

    synchronize(device)
    t1 = time.perf_counter()
    result = pie.run(idx_ct)
    synchronize(device)
    online_s = time.perf_counter() - t1
    slots, noise = ctx.decrypt(result, sk, length=bin_size)
    bound = ctx.params.q.bit_length() - T_33.bit_length() - 2
    _check(noise < bound, f"noise margin blown: {noise}")

    zeros = np.array(
        [[int(v) == 0 for v in bins] for bins in np.asarray(slots).reshape(n_hf, -1)]
    )
    _check(zeros.any(), "client element from the set must produce a 0 slot")
    # the element is stored at exactly one (hf, bin); masks are nonzero
    _check(zeros.sum() == 1, f"{zeros.sum()} zero slots, expected exactly one")
    return {"zeros": zeros, "noise": noise, "noise_bound": bound, "ring": ctx.n, "L": ctx.L,
            "seconds": time.perf_counter() - t0, "online_s": online_s,
            "launches": _since(before), "table": hct.table, "table_pt": pie.table_pt,
            "result": result}


def golden_batched_fhe_pie(device, ring: int = RING) -> dict:
    """TestBatchedFHEPIE: 1x10x20 nested table, 2+2 HFs, 100 items, exact
    reference seeds, both batch slots carrying the client element."""
    before, t0 = _counts(), time.perf_counter()
    n_items = 100
    n_simple_hf, n_cuckoo_hf = 2, 2
    simple_size, cuckoo_size, bin_size = 1, 10, 20
    items = _random_items_mod_t(n_items, T_33, FIX_SEED)
    client_elem = items[n_items // 2]

    hasher = TabulationHashing(HASH_SEED, n_simple_hf + n_cuckoo_hf)
    hct = HierarchicalCuckooHashTable(
        hasher,
        each_simple_table_size=simple_size,
        each_cuckoo_table_size=cuckoo_size,
        n_simple_hash_functions=n_simple_hf,
        n_cuckoo_hash_functions=n_cuckoo_hf,
        max_items_per_position=bin_size,
        seed=6,
    )
    hct.insert_all(items_from_ints(items))

    limbs = default_num_limbs(T_33.bit_length(), n_cuckoo_hf - 1, cuckoo_size)
    ctx = make_context(
        SchemeParams(ring, T_33, num_limbs=limbs, scheme="bfv"), seed=12, device=device
    )
    ctx.params.validate_security(allow_insecure=ring != RING)
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    pie = BatchedFHEPIE(ctx, hct, rlk, mask_seed=18)
    _check(pie.batch_slots == n_simple_hf * simple_size == 2, "batch slots != 2")

    # index matrix: both slots carry the element
    item = items_from_ints([client_elem])
    index = np.zeros((n_cuckoo_hf, cuckoo_size, pie.batch_slots), dtype=object)
    for h in range(n_cuckoo_hf):
        pos = int(hasher.hash_index(item, n_simple_hf + h, cuckoo_size)[0])
        index[h, pos, :] = 1
    idx_pt = ctx.make_plaintext_rns(
        index.reshape(n_cuckoo_hf * cuckoo_size, pie.batch_slots)
    )
    idx_ct = Ciphertext(
        ctx.encrypt_sk(idx_pt, sk).data.reshape(n_cuckoo_hf, cuckoo_size, 2, ctx.L, ctx.n)
    )
    minus = np.full(pie.batch_slots, -client_elem, dtype=object)
    minus_ct = ctx.encrypt_sk(ctx.make_plaintext_rns(minus), sk)

    synchronize(device)
    t1 = time.perf_counter()
    result = pie.run(idx_ct, minus_ct)
    synchronize(device)
    online_s = time.perf_counter() - t1
    slots, noise = ctx.decrypt(result, sk, length=pie.batch_slots)
    bound = ctx.params.q.bit_length() - T_33.bit_length() - 2
    _check(noise < bound, f"noise margin blown: {noise}")

    zeros = np.array([[int(v) == 0 for v in row] for row in np.asarray(slots)])
    _check(zeros.shape == (bin_size, 2), f"zero pattern shape {zeros.shape}")
    # "Test should output matches twice": the element lives at exactly one
    # depth; both slots match there and nowhere else
    _check(zeros.sum() == 2, f"{zeros.sum()} zeros, expected exactly two")
    _check(zeros.any(axis=0).all(), "both batch slots must match")
    return {"zeros": zeros, "noise": noise, "noise_bound": bound, "ring": ctx.n, "L": ctx.L,
            "seconds": time.perf_counter() - t0, "online_s": online_s,
            "launches": _since(before), "table": hct.table, "table_pt": pie.table_pt,
            "result": result}


def golden_inner_product(device, ring: int = RING) -> dict:
    """TestFHEInnerP: known 12-slot vectors; EvalInnerProduct of (ct1,pt3)
    and (ct2,pt3) merged -> slots [0, 1, 0, 1]; the ciphertext survives a
    wire round trip."""
    before, t0 = _counts(), time.perf_counter()
    t = 65537
    v1 = [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 123]
    v2 = [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 654]
    v3 = [-653 + t, 243, 65536, -123, 432, 43, 25, 643, 31, 324, 31, 1]

    limbs = default_num_limbs(17, 0, 12)
    ctx = make_context(SchemeParams(ring, t, num_limbs=limbs, scheme="bfv"), seed=13,
                       device=device)
    sk, pk = ctx.keygen()
    gks = ctx.galois_keygen(sk, ctx.sum_ladder_elements())

    pt3 = ctx.make_plaintext_mont(np.array(v3, dtype=object))
    ct1 = ctx.encrypt_pk(ctx.make_plaintext_rns(np.array(v1, dtype=object)), pk)
    ct2 = ctx.encrypt_pk(ctx.make_plaintext_rns(np.array(v2, dtype=object)), pk)
    # serialization round trip (the reference serializes context/pk/cts)
    ct1 = Ciphertext(
        convert.from_numpy(tensor_from_bytes(tensor_to_bytes(convert.to_numpy(ct1.data))),
                           device),
        ct1.form, ct1.scale,
    )

    def inner(ct):
        prod = Ciphertext(ctx.ct_pt_mul(ct, pt3).data, ct.form, ct.scale)
        return ctx.eval_sum_all_slots(prod, gks)

    r1, r2 = inner(ct1), inner(ct2)
    # EvalMerge equivalent: one-hot selectors place result i in slot i
    sel = ctx.make_plaintext_mont(np.eye(4, dtype=np.int64).astype(object))
    merged = None
    for i, r in enumerate([r1, r2, r1, r2]):
        part = ctx.ct_pt_mul(r, sel[i])
        merged = part if merged is None else ctx.ct_add(merged, part)

    slots, noise = ctx.decrypt(merged, sk, length=6)
    bound = ctx.params.q.bit_length() - 20
    _check(noise < bound, f"noise margin blown: {noise}")
    got = [int(v) for v in np.asarray(slots)[:4]]
    _check(got == [0, 1, 0, 1], f"merged slots {got}, expected [0, 1, 0, 1]")
    return {"zeros": np.array([v == 0 for v in got]), "slots": got, "noise": noise,
            "noise_bound": bound, "ring": ctx.n, "L": ctx.L,
            "seconds": time.perf_counter() - t0,
            "launches": _since(before), "result": merged}
