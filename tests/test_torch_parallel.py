"""The port's sharded online steps (``parallel.mesh``) against the JAX package.

Each case mirrors a case of ``tests/test_parallel.py`` at its sizes: the
dp x tp step (dp = 4 x tp = 2, ring 64, L = 8: BGV, BFV, BGV with
pos_chunk, and leveled BGV at dp = 8 x tp = 1, whose 7 result limbs do not
split over tp = 2), the ring-sharded step over 8 ranks (BGV, BFV), the
pipelined step over 8 ranks (BGV, BFV) and the SimpleFHE step over 8 ranks.
The inputs are the port's keys, table and query; the port's side runs in 8
gloo CPU ranks (``parallel.launch.run_ranks``, one spawn for every case,
ranks importing no JAX), the JAX side in this process on its 8 virtual CPU
devices, under ``jax.enable_x64(True)`` (the port's float64 estimates)
where the JAX step allows it: its ring-exchange NTT (sp) and pipelined
step (pp) fail to trace with 64-bit indices and run in 32-bit mode.
Three results must be bit-equal: the port's gathered result, the JAX
package's sharded result and the port's unsharded step. The pipelined
step's bytes per rank are pinned to (k - 1) * H * (D/k) * 2 * L * N * 4.
"""

import gc
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

from nested_hashing_psi_tpu.fhe import bfv as j_bfv
from nested_hashing_psi_tpu.fhe.bgv import RelinKey as JRelinKey
from nested_hashing_psi_tpu.fhe.params import SchemeParams as JSchemeParams
from nested_hashing_psi_tpu.hashing import HierarchicalCuckooHashTable as JHCT
from nested_hashing_psi_tpu.hashing import TabulationHashing as JTab
from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints as j_items
from nested_hashing_psi_tpu.parallel import mesh as jmesh
from nested_hashing_psi_tpu.pie import simple_fhe as j_simple
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.tabulation import items_from_ints
from nested_hashing_psi_tpu_torch.parallel import comm, mesh as tmesh
from nested_hashing_psi_tpu_torch.parallel.launch import run_ranks
from nested_hashing_psi_tpu_torch.parallel.multihost import (
    Mesh,
    _one_rank_per_device,
    host_to_global,
    init_distributed,
    rank_device,
)
from nested_hashing_psi_tpu_torch.pie.batched_fhe import (
    BatchedFHEClientOps,
    BatchedFHEPIE,
    batched_pie_forward,
)
from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEClientOps, SimpleFHEPIE
from torch_parallel_cases import run_cases, summarize

torch.set_num_threads(1)

WORLD = 8
T16 = 65537
RANKS_TIMEOUT = 240.0
BATCHED_CASES = {
    # name: (kind, scheme, mesh, options)
    "dp_tp_bgv": ("dp_tp", "bgv", (4, 2), {}),
    "dp_tp_bfv": ("dp_tp", "bfv", (4, 2), {}),
    "dp_tp_bgv_pos_chunk": ("dp_tp", "bgv", (4, 2), {"pos_chunk": 2}),
    "dp_tp_bgv_leveled": ("dp_tp", "bgv", (8, 1), {"leveled": True, "n_hash": 2}),
    "sp_bgv": ("sp", "bgv", None, {}),
    "sp_bfv": ("sp", "bfv", None, {}),
    "pp_bgv": ("pp", "bgv", None, {}),
    "pp_bfv": ("pp", "bfv", None, {}),
}


def _batched_inputs(scheme: str, seed: int) -> dict:
    """The port's keys, table (mul_limbs = 0: the full basis) and query at
    the JAX tests' sizes: ring 64, L = 8, D = P = 8, H = 2."""
    hasher = TabulationHashing(55 + seed, 4)
    hct = HierarchicalCuckooHashTable(
        hasher, each_simple_table_size=16, each_cuckoo_table_size=8,
        n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
        max_items_per_position=8, seed=seed,
    )
    hct.insert_all(items_from_ints(list(range(50 + seed, 200 + seed))))
    params = SchemeParams(ring_dim=64, plaintext_modulus=T16, num_limbs=8, scheme=scheme)
    ctx = make_context(params, seed=seed, device="cpu")
    sk, _ = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    pie = BatchedFHEPIE(ctx, hct, rlk, mask_seed=seed + 1, mul_limbs=0)
    ct_table = CuckooHashTable(hasher, 16, 2, max_items_per_position=1, seed=seed + 2)
    ct_table.insert_all(items_from_ints([55 + seed, 5000]))
    idx, minus = BatchedFHEClientOps(ctx, ct_table, 2, 2, 8).encrypt_query(sk)
    arrays = dict(idx=idx.data, minus=minus.data, table=pie.table_pt, mask=pie.mask_pt,
                  rlk_b=rlk.b_mont, rlk_a=rlk.a_mont)
    return dict(params=params, ctx=ctx, rlk=rlk,
                inputs={k: convert.to_numpy(v) for k, v in arrays.items()})


def _simple_hct(table_cls, hashing_cls, to_items):
    hct = table_cls(hashing_cls(66, 4), each_simple_table_size=8, each_cuckoo_table_size=6,
                    n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                    max_items_per_position=4, seed=5)
    hct.insert_all(to_items(list(range(50, 120))))
    return hct


def _simple_inputs() -> dict:
    """test_parallel.py's SimpleFHE case: ring 32, L = 8, 16 pies; the same
    nested table built by both packages (their hashing is pinned equal)."""
    hct = _simple_hct(HierarchicalCuckooHashTable, TabulationHashing, items_from_ints)
    params = SchemeParams(ring_dim=32, plaintext_modulus=T16, num_limbs=8)
    ctx = make_context(params, seed=6, device="cpu")
    sk, _ = ctx.keygen()
    gks = ctx.galois_keygen(sk, ctx.sum_ladder_elements())
    pie = SimpleFHEPIE(ctx, hct, gks, mask_seed=7)
    ct_table = CuckooHashTable(hct.hasher, 8, 2, max_items_per_position=1, seed=8)
    ct_table.insert_all(items_from_ints([60, 61]))
    idx = SimpleFHEClientOps(ctx, ct_table, 2, 2, 6, 4).encrypt_query(sk)
    return dict(params=params, pie=pie, hct=hct, jhct=_simple_hct(JHCT, JTab, j_items),
                gks=convert.galois_keys_to_numpy(gks), idx=idx,
                inputs={"idx": convert.to_numpy(idx.data)})


def _jax_batched(kind, scheme, mesh_shape, opts, data) -> np.ndarray:
    p = data["params"]
    jctx = j_bfv.make_context(JSchemeParams(ring_dim=p.ring_dim, plaintext_modulus=p.plaintext_modulus,
                                            num_limbs=p.num_limbs, scheme=scheme), seed=0)
    devs = np.array(jax.devices()[:WORLD])
    if kind == "dp_tp":
        fn, sh = jmesh.sharded_pie_step(jctx, JMesh(devs.reshape(mesh_shape), ("dp", "tp")),
                                        **opts)
    elif kind == "sp":
        fn, sh = jmesh.sp_sharded_pie_step(jctx, JMesh(devs, ("sp",)))
    else:
        fn, sh = jmesh.pp_pipelined_pie_step(jctx, JMesh(devs, ("pp",)))
    a = data["inputs"]
    put = lambda k, s: jax.device_put(jnp.asarray(a[k]), sh[s])  # noqa: E731
    return np.asarray(fn(put("idx", "idx"), put("minus", "minus"), put("table", "table"),
                         put("mask", "mask"), put("rlk_b", "rlk"), put("rlk_a", "rlk")))


def _jax_simple(data) -> np.ndarray:
    p = data["params"]
    jctx = j_bfv.make_context(JSchemeParams(ring_dim=p.ring_dim, plaintext_modulus=p.plaintext_modulus,
                                            num_limbs=p.num_limbs), seed=0)
    gks = {k: JRelinKey(b_mont=jnp.asarray(b), a_mont=jnp.asarray(a))
           for k, (b, a) in data["gks"].items()}
    jpie = j_simple.SimpleFHEPIE(jctx, data["jhct"], gks, mask_seed=7)
    mesh = JMesh(np.array(jax.devices()[:WORLD]).reshape(4, 2), ("dp", "tp"))
    fn, sh = jmesh.sharded_simple_pie_step(jpie, mesh)
    return np.asarray(fn(jax.device_put(jnp.asarray(data["inputs"]["idx"]), sh["idx"])))


@pytest.fixture(scope="module")
def runs():
    """Every case's three results: the port's 8 gloo ranks (started first,
    running while the JAX side computes), the JAX package's sharded step
    and the port's unsharded step."""
    batched = {name: _batched_inputs(scheme, seed=10 * i + 1)
               for i, (name, (_, scheme, _, _)) in enumerate(BATCHED_CASES.items())}
    simple = _simple_inputs()
    cases = [dict(name=name, kind=kind, params=batched[name]["params"], mesh=mesh_shape,
                  inputs=batched[name]["inputs"], **opts)
             for name, (kind, _, mesh_shape, opts) in BATCHED_CASES.items()]
    cases.append(dict(name="simple", kind="simple", params=simple["params"], mesh=(4, 2),
                      inputs=simple["inputs"], hct=simple["hct"],
                      galois_keys=simple["gks"], mask_seed=7))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, run_cases, WORLD, "gloo", (cases, "cpu"),
                            RANKS_TIMEOUT)
        out = {}
        for name, (kind, scheme, mesh_shape, opts) in BATCHED_CASES.items():
            d = batched[name]
            t = {k: convert.from_numpy(v, "cpu") for k, v in d["inputs"].items()}
            unsharded = batched_pie_forward(
                d["ctx"], d["rlk"], t["idx"], t["minus"], t["table"], t["mask"],
                leveled=opts.get("leveled", False)).data
            # the JAX ring-exchange NTT's dynamic slices refuse x64 indices
            with jax.enable_x64(kind == "dp_tp"):
                out[name] = dict(jax=_jax_batched(kind, scheme, mesh_shape, opts, d),
                                 unsharded=convert.to_numpy(unsharded))
        with jax.enable_x64(True):
            out["simple"] = dict(jax=_jax_simple(simple), unsharded=convert.to_numpy(
                simple["pie"].run(simple["idx"]).data))
        for s in summarize(ranks.result()):
            out[s["name"]].update(port=s["results"][0], counts=s["counts"],
                                  transport=s["transport"], mesh=s["mesh"])
    return dict(out=out, batched=batched)


@pytest.mark.parametrize("name", list(BATCHED_CASES) + ["simple"])
def test_sharded_step_bit_equal_three_ways(runs, name):
    r = runs["out"][name]
    assert r["transport"] == "gloo"
    assert r["port"].shape == r["unsharded"].shape
    np.testing.assert_array_equal(r["port"], r["unsharded"])
    np.testing.assert_array_equal(r["jax"], r["unsharded"])


@pytest.mark.parametrize("name", ["pp_bgv", "pp_bfv"])
def test_pipelined_step_sends_the_pinned_bytes(runs, name):
    """(k - 1) hops of the (H, D/k, 2, L, N) running sum per rank."""
    H, D, P, L, N = runs["batched"][name]["inputs"]["table"].shape
    k = WORLD
    want = (k - 1) * H * (D // k) * 2 * L * N * 4
    assert [c[0]["bytes_sent"] for c in runs["out"][name]["counts"]] == [want] * k


def test_dp_tp_bytes_are_the_limb_gathers(runs):
    """Per query each rank of a tp pair sends its limb half of the position
    sums and of minus once; the masks and relin key, gathered on the first
    query, are not sent again."""
    H, D, P, L, N = runs["batched"]["dp_tp_bgv"]["inputs"]["table"].shape
    dp, tp = 4, 2
    per = (H * (D // dp) * 2 + 2) * (L // tp) * N * 4 * (tp - 1)
    assert [c[0]["bytes_sent"] for c in runs["out"]["dp_tp_bgv"]["counts"]] == [per] * WORLD


def test_sp_form_scale_matches_unsharded():
    for scheme in ("bgv", "bfv"):
        ctx = make_context(SchemeParams(ring_dim=64, plaintext_modulus=T16, num_limbs=8,
                                        scheme=scheme), seed=1, device="cpu")
        assert tmesh.sp_result_form_scale(ctx, 2) == (scheme, 1)


def _bare_mesh(shape: dict) -> Mesh:
    """A mesh record without process groups: enough for the checks made
    before any collective."""
    return Mesh(tuple(shape), shape, {a: 0 for a in shape}, {}, torch.device("cpu"))


def test_unshardable_limbs_raise_as_in_jax():
    """L = 9 does not split over tp = 2 (test_parallel.py's production
    geometry shards the depths only), nor a leveled result of 7 limbs."""
    ctx = make_context(SchemeParams(ring_dim=64, plaintext_modulus=T16, num_limbs=9),
                       seed=1, device="cpu")
    with pytest.raises(ValueError, match="9 limbs do not split over tp = 2"):
        tmesh.sharded_pie_step(ctx, _bare_mesh({"dp": 4, "tp": 2}))
    ctx8 = make_context(SchemeParams(ring_dim=64, plaintext_modulus=T16, num_limbs=8),
                        seed=1, device="cpu")
    with pytest.raises(ValueError, match="7 limbs do not split over tp = 2"):
        tmesh.sharded_pie_step(ctx8, _bare_mesh({"dp": 4, "tp": 2}), leveled=True, n_hash=2)
    with pytest.raises(ValueError, match="does not split 4 ways"):
        host_to_global(_bare_mesh({"dp": 4, "tp": 1}), ("dp", None), np.zeros((6, 2), np.uint32))


def test_backend_is_the_callers_and_nccl_wants_its_own_gpu(monkeypatch):
    """No backend is picked for the caller; an nccl rank needs a CUDA card
    of its own: with none visible it raises, and a card that another rank
    already posted to the store raises."""
    with pytest.raises(ValueError, match="backend must be"):
        init_distributed(None, 1, 0, "mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="nccl rank 0 needs a CUDA device"):
        init_distributed(None, 1, 0, "nccl")
    assert not dist.is_initialized()
    store = dist.HashStore()
    store.set("nhpsi/nccl_device/0", "host/GPU-A")
    with pytest.raises(ValueError, match="shares host/GPU-A with ranks \\[0\\]"):
        _one_rank_per_device(store, 1, 2, "host/GPU-A")
    store = dist.HashStore()
    store.set("nhpsi/nccl_device/0", "host/GPU-B")
    _one_rank_per_device(store, 1, 2, "host/GPU-A")


def test_collectives_on_one_rank_return_their_input():
    """On a group of one rank all_gather and all_to_all return the tensor
    they were given and send nothing, as a collective over a mesh axis of
    size 1 does nothing in JAX: no copy to host memory, on any transport."""
    init_distributed(None, 1, 0, "gloo")
    try:
        group = dist.group.WORLD
        x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
        comm.reset_bytes()
        assert comm.all_gather(x, 1, group) is x
        assert comm.all_to_all(x, 2, 1, group) is x
        assert comm.bytes_sent == 0
        assert torch.equal(x, torch.arange(24, dtype=torch.int32).reshape(2, 3, 4))
    finally:
        dist.destroy_process_group()


def test_nccl_rank_takes_its_card_on_its_host(monkeypatch):
    """Ranks laid out host by host: on 2 hosts x 2 cards rank r takes card
    r mod 2 of its host; two ranks on a host with one card take the same
    card, which the store check above refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [rank_device(r) for r in range(4)] == [torch.device("cuda", r % 2) for r in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device(0) == rank_device(1) == torch.device("cuda", 0)


def test_rank_program_computes_on_the_card_unless_asked(monkeypatch):
    """run_cases and a mesh default to the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cases(0, 1, [])
    assert run_cases(0, 1, [], "cpu") == []


def test_simple_step_keeps_only_its_slice():
    """The SimpleFHE step of rank 3 of 8 holds copies of its 2 of the 16
    pies and no reference to the PIE: once the PIE is dropped, its table is
    freed, and the step still answers its pies as the PIE did."""
    data = _simple_inputs()
    pie, idx = data.pop("pie"), data["idx"].data
    want = pie.run(data["idx"]).data[6:8]
    mesh = _bare_mesh({"dp": 4, "tp": 2})
    mesh.index.update(dp=1, tp=1)
    step, _ = tmesh.sharded_simple_pie_step(pie, mesh)
    table = weakref.ref(pie.table_pt)
    del pie
    gc.collect()
    assert table() is None
    np.testing.assert_array_equal(step(idx[6:8]).numpy(), want.numpy())


def test_a_failing_rank_fails_the_launch():
    """Every rank raises; run_ranks raises with their tracebacks and leaves
    no rank running."""
    with pytest.raises(RuntimeError, match="unknown case kind 'nope'"):
        run_ranks(run_cases, 2, "gloo", ([dict(name="bad", kind="nope", inputs={})], "cpu"),
                  timeout=60)
