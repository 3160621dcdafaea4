"""Time the probes A1, A2 and A3 of several trees of the port on one GPU, in turns.

    python -m nested_hashing_psi_tpu_torch.benchmarks.probe_sweep TREE [TREE ...] [--turns 2] [--iters 20] [--out FILE]

A tree is a directory holding ``nested_hashing_psi_tpu_torch/``: the
repository root, an unpacked ``git archive`` of another commit (the parent:
``git archive HEAD | tar -x -C build/parent``), or a copy with an edited
``csrc/`` under ``build/`` (ignored by git). Each tree builds its own kernel
library under its own ``build/``; all trees build at once first. A turn
then runs every tree in a fresh process of its own -- A2's and A3's
``run`` at (512, 6, 16384): every variant held bit-exact against its plain
version, then timed with CUDA events, K1 on the same input beside them;
and A1's 11 mixes at (64, 128, 128) through the tree's own ``vpu_ops``:
each held bit-exact against its plain version at K = 64, then read at K =
64 and at 2^15 as the device's time per call from a CUDA graph of chained
calls (``timing.graph_ms`` over ``timing.chain``), with its SASS
instructions per application from the tree's own library -- in the order
given, and the next turn in the reverse order (parent, this, this, parent
for two trees). Prints each tree's ms per variant and turn, and the median
over the turns, A1's with its shares of each launch's bound by pipe
(``a1_rows``), under the card's name and power limit; the JSON goes to
``--out`` (``build/probe_sweep.json`` of the repository by default).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

from nested_hashing_psi_tpu_torch.benchmarks import bench_vpu_ops
from nested_hashing_psi_tpu_torch.benchmarks.card import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = ("exact", "lazy", "lazy_ps", "stages", "moves", "k1")

BUILD = """
import sys
sys.path.insert(0, sys.argv[1])
from nested_hashing_psi_tpu_torch.ops import cuda_lib
cuda_lib.build()
"""

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_anatomy, bench_ntt_lazy_probe
from nested_hashing_psi_tpu_torch.benchmarks import bench_vpu_ops as a1, timing
lazy = bench_ntt_lazy_probe.run(iters=int(sys.argv[2]))
anat = bench_ntt_anatomy.run(iters=int(sys.argv[2]))
out = {v: lazy[v]["ms"] for v in bench_ntt_lazy_probe.VARIANTS}
out.update({v: anat[v]["ms"] for v in bench_ntt_anatomy.VARIANTS})
out["k1"] = anat["k1_ms"]
dev = torch.device("cuda")
x = torch.from_numpy(np.random.default_rng(0).integers(0, 1 << 31, size=a1.SHAPE, dtype=np.int64)
                     .astype(np.int32)).to(dev)
out["a1"] = {}
for name in a1.MIXES:
    bad = a1.same(a1.vpu_ops(x, name), a1.vpu_ops_plain(x, name), name)
    if bad:
        raise RuntimeError(f"A1 {name}: {bad} elements differ from the plain version")
    s = a1.sass_per_application(name)
    out["a1"][name] = {"sass": {"fma_slots": s["fma_slots"], "alu": s["alu"]}, **{
        key: timing.graph_ms(timing.chain(lambda v: a1.vpu_ops(v, name, k), x), dev)
        for key, k in (("ms", a1.K), ("rate_ms", a1.RATE_K))}}
print("RESULT " + json.dumps(out), flush=True)
"""


def run_tree(tree: str, iters: int) -> dict:
    """One tree's ms per variant, from a fresh process; raises if it fails
    (a variant that differs from its plain version raises there)."""
    proc = subprocess.run([sys.executable, "-c", RUN, tree, str(iters)], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree} failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def a1_rows(turns: list[dict]) -> dict:
    """A1 of one tree from its turns (each {mix: {ms, rate_ms, sass}}): per
    mix the median device ms over the turns at K and at RATE_K, each
    launch's bound by pipe from the tree's own SASS counts and the shares;
    the K launches of every mix summed against the sum of their own bounds
    (``bench_vpu_ops.summed_bound_ms``), per turn and for the medians."""
    a1, elems = bench_vpu_ops, math.prod(bench_vpu_ops.SHAPE)
    sass = {m: r["sass"] for m, r in turns[0].items()}
    mixes = {}
    for m, s in sass.items():
        r = {key: statistics.median(t[m][key] for t in turns) for key in ("ms", "rate_ms")}
        r["bound_ms"] = a1.bound_ms(elems, a1.K, s)[0]
        r["rate_bound_ms"] = a1.bound_ms(elems, a1.RATE_K, s)[0]
        r["share"], r["rate_share"] = r["bound_ms"] / r["ms"], r["rate_bound_ms"] / r["rate_ms"]
        mixes[m] = r
    bound, by = a1.summed_bound_ms(sass, elems, a1.K)
    turn_ms = [sum(t[m]["ms"] for m in sass) for t in turns]
    median_ms = sum(r["ms"] for r in mixes.values())
    return {"mixes": mixes, "summed_bound_ms": bound, "summed_bound_by": by,
            "summed_ms_turns": turn_ms, "summed_share_turns": [bound / t for t in turn_ms],
            "summed_ms": median_ms, "summed_share": bound / median_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe_sweep.json"))
    a = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in a.trees]
    for t in trees:
        if not os.path.isdir(os.path.join(t, "nested_hashing_psi_tpu_torch")):
            raise SystemExit(f"{t} holds no nested_hashing_psi_tpu_torch/")
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, t], cwd=t) for t in trees]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's kernel library did not build")
    card = card_line()
    runs: dict[str, list[dict]] = {t: [] for t in trees}
    for turn in range(a.turns):
        for t in trees if turn % 2 == 0 else trees[::-1]:
            runs[t].append(run_tree(t, a.iters))
            one = a1_rows([runs[t][-1]["a1"]])
            print(f"[probe_sweep] turn {turn} {os.path.relpath(t, ROOT)}: " + ", ".join(
                f"{v} {runs[t][-1][v]:.4f}" for v in VARIANTS) + f"; A1 K = "
                f"{bench_vpu_ops.K} summed {one['summed_ms']:.4f} ms (share "
                f"{one['summed_share']:.3f})", flush=True)
    res = {"card": card, "shape": [512, 6, 16384], "a1_shape": list(bench_vpu_ops.SHAPE),
           "a1_k": [bench_vpu_ops.K, bench_vpu_ops.RATE_K], "iters": a.iters,
           "trees": {os.path.relpath(t, ROOT): {
               "turns": runs[t],
               "median_ms": {v: statistics.median(r[v] for r in runs[t]) for v in VARIANTS},
               "a1": a1_rows([r["a1"] for r in runs[t]])}
               for t in trees}}
    print(f"[probe_sweep] {card}; (512, 6, 16384), median ms over {a.turns} turns:", flush=True)
    for name, r in res["trees"].items():
        print(f"[probe_sweep]   {name}: " + ", ".join(
            f"{v} {r['median_ms'][v]:.4f}" for v in VARIANTS), flush=True)
    print(f"[probe_sweep] {card}; A1 at {tuple(bench_vpu_ops.SHAPE)}, median device ms over "
          f"{a.turns} turns (share of the launch's bound by pipe) at K = {bench_vpu_ops.K} | K = "
          f"{bench_vpu_ops.RATE_K}:", flush=True)
    for name, r in res["trees"].items():
        a1 = r["a1"]
        print(f"[probe_sweep]   {name}: " + "; ".join(
            f"{m} {x['ms']:.4f} ({x['share']:.3f}) | {x['rate_ms']:.4f} ({x['rate_share']:.3f})"
            for m, x in a1["mixes"].items()) + f"; K = {bench_vpu_ops.K} summed "
            f"{a1['summed_ms']:.4f} ms against {a1['summed_bound_ms']:.4f} ms, share "
            f"{a1['summed_share']:.3f} (turns " + ", ".join(
                f"{v:.3f}" for v in a1["summed_share_turns"]) + ")", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
