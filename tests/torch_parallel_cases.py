"""The rank program of the parallel tests, on the CPU and on the card: ``run_cases``.

It runs sharded steps of ``nested_hashing_psi_tpu_torch.parallel`` on given
inputs and imports no JAX, so that ranks spawned from a test can import it
(``run_ranks`` pickles it by module name; spawned ranks inherit this
directory on ``sys.path``).

``launch.run_ranks(run_cases, world, backend, (cases, device))`` runs, in
every rank, each case of the list in turn: it builds the case's mesh over
all ranks and its context on ``device``, cuts the rank's shards out of the
host inputs (``multihost.host_to_global``) and runs the step twice: the
first query (which gathers what the dp x tp step keeps), then one query
with the counters set to 0 just before and read just after (bytes this
rank sent, K1's forward and inverse and K2's launches). It gathers the
result (``global_to_host``) and, with ``iters``, times the step: per query,
every rank waits at a barrier, then runs the step to a device synchronise
on the host clock. Rank 0 returns the gathered results; every rank its
counts and times.

A case is a dict: ``name``; ``kind`` (``dp_tp``, ``sp``, ``pp``,
``simple``, ``dist_ntt``, ``ring_ntt``); ``inputs`` (numpy uint32: idx,
minus, table, mask, rlk_b, rlk_a for the batched steps, idx for simple, x
for the NTTs); ``params`` (``fhe.params.SchemeParams``; for the NTTs the
tuple (n, primes, m1)); ``mesh`` ((dp, tp) over all ranks, for dp_tp and
simple); the step options ``leveled``, ``n_hash``, ``pos_chunk``; for
simple ``hct``, ``galois_keys`` (numpy, ``convert.galois_keys_to_numpy``)
and ``mask_seed``, from which every rank builds the same PIE; and
``warm``/``iters`` for timing (default 0: not timed).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
from nested_hashing_psi_tpu_torch.ops.ntt4 import FourStepPlan
from nested_hashing_psi_tpu_torch.parallel import comm, dist_ntt, mesh as pmesh
from nested_hashing_psi_tpu_torch.parallel.multihost import (
    global_mesh,
    global_to_host,
    host_to_global,
    compute_device,
)
from nested_hashing_psi_tpu_torch.utils.device import synchronize

BATCHED = ("idx", "minus", "table", "mask", "rlk_b", "rlk_a")


def _counts() -> dict:
    return {"bytes_sent": comm.bytes_sent, "ntt_fwd": ntt_cuda.launches["ntt"],
            "ntt_inv": ntt_cuda.launches["intt"], "pie_ip": pie_kernels.launches}


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _reset() -> None:
    comm.reset_bytes()
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()


KINDS = ("dp_tp", "sp", "pp", "simple", "dist_ntt", "ring_ntt")


def _build(case: dict, world: int, device: torch.device, contexts: dict):
    """(mesh, [(fn, in specs, out spec, input names)]) of one case: the
    NTT cases run their forward, then their inverse on its output."""
    kind, inputs = case["kind"], case["inputs"]
    if kind not in KINDS:
        raise ValueError(f"unknown case kind {kind!r}")
    if kind in ("dist_ntt", "ring_ntt"):
        n, primes, m1 = case["params"]
        axis = ("sp",)
        m = global_mesh(axes=axis, device=device)
        ndim = inputs["x"].ndim
        lead = (None,) * (ndim - 2)
        if kind == "dist_ntt":
            fwd, inv = dist_ntt.dist_ntt_fns(FourStepPlan(n, tuple(primes), m1), m, "sp", ndim)
            s2, s1 = lead + (None, "sp"), lead + ("sp", None)
            return m, [(fwd, (s2,), s1, ("x",)), (inv, (s1,), s2, None)]
        fwd, inv = dist_ntt.dist_ntt_ring_fns(NTTPlan(n, tuple(primes)), m, "sp", ndim)
        s = lead + (None, "sp")
        return m, [(fwd, (s,), s, ("x",)), (inv, (s,), s, None)]
    params = case["params"]
    if params not in contexts:
        contexts[params] = make_context(params, seed=0, device=device)
    ctx = contexts[params]
    if kind == "simple":
        from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEPIE

        m = pmesh.make_mesh(world, case["mesh"][1], device=device)
        gks = convert.galois_keys_from_numpy(case["galois_keys"], device)
        pie = SimpleFHEPIE(ctx, case["hct"], gks, mask_seed=case["mask_seed"])
        fn, sh = pmesh.sharded_simple_pie_step(pie, m)
        return m, [(fn, (sh["idx"],), sh["out"], ("idx",))]
    if kind == "dp_tp":
        m = pmesh.make_mesh(world, case["mesh"][1], device=device)
        fn, sh = pmesh.sharded_pie_step(ctx, m, case.get("leveled", False), case.get("n_hash"),
                                        case.get("pos_chunk"))
    elif kind == "sp":
        m = global_mesh(axes=("sp",), device=device)
        fn, sh = pmesh.sp_sharded_pie_step(ctx, m, "sp", case.get("pos_chunk"))
    else:
        m = global_mesh(axes=("pp",), device=device)
        fn, sh = pmesh.pp_pipelined_pie_step(ctx, m, "pp", case.get("leveled", False),
                                             case.get("n_hash"))
    specs = tuple(sh[k] for k in ("idx", "minus", "table", "mask", "rlk", "rlk"))
    return m, [(fn, specs, sh["out"], BATCHED)]


def run_cases(rank: int, world: int, cases: list, device="cuda") -> list:
    """Every case in turn (see the module docstring) -> one dict per case:
    ``results`` (rank 0: the gathered output of each stage, else None),
    ``counts`` and ``ms`` (this rank's, per stage), ``transport``, ``mesh``
    and ``held`` (the device bytes this rank's step and its inputs hold once
    built, a first context included; 0 on the CPU). ``cuda`` is the rank's
    current card and must exist."""
    device = compute_device(device)
    contexts, out = {}, []
    for case in cases:
        synchronize(device)
        base = _allocated(device)
        m, stages = _build(case, world, device, contexts)
        args = None
        results, counts, ms = [], [], []
        for fn, in_specs, out_spec, names in stages:
            if names is not None:
                args = [host_to_global(m, s, case["inputs"][k]) for s, k in zip(in_specs, names)]
                held = _allocated(device) - base
            fn(*args)  # the first query
            synchronize(device)
            _reset()
            local = fn(*args)
            synchronize(device)
            counts.append(_counts())
            for _ in range(case.get("warm", 0)):
                fn(*args)
            ms.append([])
            for _ in range(case.get("iters", 0)):
                dist.barrier()
                synchronize(device)
                t0 = time.perf_counter()
                fn(*args)
                synchronize(device)
                ms[-1].append((time.perf_counter() - t0) * 1e3)
            results.append(global_to_host(local, m, out_spec))
            args = [local]  # an NTT's inverse runs on its forward's output
        group = next(iter(m.groups.values()))
        out.append({"name": case["name"], "results": results if rank == 0 else None,
                    "counts": counts, "ms": ms, "transport": comm.transport(group, device),
                    "mesh": dict(m.shape), "held": held})
        del m, stages, fn, args, local  # so the next case's held bytes start clean
    return out


def summarize(rank_outputs: list) -> list:
    """Per case, from ``run_ranks``' list of every rank's ``run_cases``
    output: rank 0's results, the counts and held bytes of every rank, and per stage the
    step's ms per query (per timed query the slowest rank's: median, min,
    max; None where it was not timed)."""
    summary = []
    for i, first in enumerate(rank_outputs[0]):
        per_rank = [r[i] for r in rank_outputs]
        times = []
        for stage in range(len(first["ms"])):
            slowest = [max(t) for t in zip(*(r["ms"][stage] for r in per_rank))]
            times.append({"median": float(np.median(slowest)), "min": min(slowest),
                          "max": max(slowest)} if slowest else None)
        summary.append({
            "name": first["name"], "results": first["results"], "transport": first["transport"],
            "mesh": first["mesh"], "counts": [r["counts"] for r in per_rank], "ms": times,
            "held": [r["held"] for r in per_rank]})
    return summary
