"""Run cells of the benchmark several times, each run a process of its own,
and summarise them: the medians and the spreads (the distance between the
first and third quartile of ``statistics.quantiles(values, n=4)``, as a
share of the median) by which ``BENCHMARK.json``'s bounds are set.

    python -m psi_bench.sweep --out FILE.jsonl --job CELL:SEED[,SEED...]:SECONDS:TRACE[:PART.KEY=JSON...] ...

Jobs run in order, their seeds in order. Every result line, with the end
of each run's standard error, is appended to ``FILE.jsonl`` (keep it under
``build/``, which git ignores); the summary, grouped by job, goes to
standard output. ``--set`` values (``program.bit_size=16`` for the
control) are never used in a measured run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values: list[float]) -> float | None:
    """(Q3 - Q1) / median, or None for fewer than two values."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def parse_job(text: str) -> dict:
    cell, seeds, seconds, trace, *sets = text.split(":")
    return {"cell": cell, "seeds": [int(s) for s in seeds.split(",")],
            "seconds": seconds, "trace": trace, "sets": sets}


def run_one(job: dict, seed: int, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "psi_bench.run", "--workload", job["cell"], "--seed",
           str(seed), "--seconds", job["seconds"], "--trace", job["trace"]]
    for s in job["sets"]:
        cmd += ["--set", s]
    begin = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return {"cell": job["cell"], "seed": seed, "trace": job["trace"], "sets": job["sets"],
            "rc": rc, "wall_s": time.perf_counter() - begin, "line": line,
            "stderr_tail": err[-3000:]}


def summarise(records: list[dict]) -> list[str]:
    out = []
    lines = [r["line"] for r in records if r["line"]]
    out.append(f"  runs {len(records)}, rc {[r['rc'] for r in records]}, correct "
               f"{[ln['correct'] for ln in lines]}, attempted "
               f"{[ln['attempted'] for ln in lines]}, wall_s "
               f"{[round(r['wall_s'], 1) for r in records]}")
    for ln in lines:
        out.append("  checks " + ", ".join(f"{k} {c['value']} (limit {c['limit']})"
                                         for k, c in ln["checks"].items()))
    for r in records:
        out.extend(f"  | {x}" for x in r["stderr_tail"].splitlines() if x.startswith("psi_bench:"))
    names = sorted({n for ln in lines for n in ln["metrics"]})
    for n in names:
        vals = [ln["metrics"][n]["value"] for ln in lines if n in ln["metrics"]]
        sp = spread(vals)
        out.append(f"  {n}: median {statistics.median(vals):.6g} spread "
                   f"{'-' if sp is None else f'{sp:.4f}'} values {[f'{v:.6g}' for v in vals]}")
    for key in ("memory_peak_bytes", "busy_s", "window_s"):
        vals = [ln["device"][key] for ln in lines if key in ln["device"]]
        if vals:
            out.append(f"  device.{key}: {vals}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--job", action="append", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    path = args.out
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    failed = False
    for text in args.job:
        job = parse_job(text)
        records = []
        for seed in job["seeds"]:
            rec = run_one(job, seed, args.timeout)
            records.append(rec)
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            failed |= rec["rc"] != 0
            if rec["rc"] != 0:
                print(f"{job['cell']} seed {seed} rc {rec['rc']}:\n{rec['stderr_tail'][-1500:]}",
                      flush=True)
        print(f"{text}", flush=True)
        print("\n".join(summarise(records)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
