"""Time the NTT probes A2 and A3 of several trees of the port on one GPU, in turns.

    python -m nested_hashing_psi_tpu_torch.benchmarks.probe_sweep TREE [TREE ...] [--turns 2] [--iters 20] [--out FILE]

A tree is a directory holding ``nested_hashing_psi_tpu_torch/``: the
repository root, an unpacked ``git archive`` of another commit (the parent:
``git archive HEAD | tar -x -C build/parent``), or a copy with an edited
``csrc/`` under ``build/`` (ignored by git). Each tree builds its own kernel
library under its own ``build/``; all trees build at once first. A turn
then runs every tree in a fresh process of its own -- A2's and A3's
``run`` at (512, 6, 16384): every variant held bit-exact against its plain
version, then timed with CUDA events, K1 on the same input beside them --
in the order given, and the next turn in the reverse order (parent, this,
this, parent for two trees). Prints each tree's ms per variant and turn,
and the median over the turns, under the card's name and power limit; the
JSON goes to ``--out`` (``build/probe_sweep.json`` of the repository by
default).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

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
from nested_hashing_psi_tpu_torch.benchmarks import bench_ntt_anatomy, bench_ntt_lazy_probe
lazy = bench_ntt_lazy_probe.run(iters=int(sys.argv[2]))
anat = bench_ntt_anatomy.run(iters=int(sys.argv[2]))
out = {v: lazy[v]["ms"] for v in bench_ntt_lazy_probe.VARIANTS}
out.update({v: anat[v]["ms"] for v in bench_ntt_anatomy.VARIANTS})
out["k1"] = anat["k1_ms"]
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
            print(f"[probe_sweep] turn {turn} {os.path.relpath(t, ROOT)}: " + ", ".join(
                f"{v} {runs[t][-1][v]:.4f}" for v in VARIANTS), flush=True)
    res = {"card": card, "shape": [512, 6, 16384], "iters": a.iters,
           "trees": {os.path.relpath(t, ROOT): {
               "turns": runs[t],
               "median_ms": {v: statistics.median(r[v] for r in runs[t]) for v in VARIANTS}}
               for t in trees}}
    print(f"[probe_sweep] {card}; (512, 6, 16384), median ms over {a.turns} turns:", flush=True)
    for name, r in res["trees"].items():
        print(f"[probe_sweep]   {name}: " + ", ".join(
            f"{v} {r['median_ms'][v]:.4f}" for v in VARIANTS), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
