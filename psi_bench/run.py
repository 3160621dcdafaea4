"""One run of one cell of ``BENCHMARK.json``.

    python -m psi_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes the server's set and the pool of
client sets from the seed (``sets.py``), sets the port's parties up and
builds the server's table (``exchange.py``), warms up with the traffic's
first exchanges, then measures a window of ``--seconds``: a closed loop in
which one client sends the next exchange when the last is answered, each
timed from its first frame to the intersection in hand. The window runs to
the end of its last exchange. With ``--trace 1`` a stretch of the window
runs under torch.profiler (``trace.py``) and the line carries the per-layer
metrics instead of the end-to-end ones. Once the window has closed, the
parties are stopped, the device's peak memory is read and the program's
state is freed, the reference (``reference.py``) judges every answer of the
window: ``wrong_items`` (limit 0) counts each item served and not in the
intersection, or in it and not served; an exchange still unanswered a
minute after the close is given up, and each of its sets misses its whole
intersection. The last line of standard output is the result's JSON; the
numbers compared, each beside its limit, end standard error.

Without a CUDA card (or with fewer than the cell asks for) the run fails
and prints no result: there is no CPU fallback. The run also fails if JAX,
its libraries or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from psi_bench import reference, sets, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nested_hashing_psi_tpu")
LATE_S = 60.0  # an exchange still unanswered this long after the close is given up
TOP = 10  # entries of each breakdown list
TRACE_TRIES = 3  # stretches traced before a trace with no kernel is taken as it is


def forbidden_modules(names) -> list[str]:
    """The top-level module names among ``names`` that a run may not load,
    compared whole (``nested_hashing_psi_tpu_torch`` is not one)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc and g++ builds already live in ``build/nhpsi_torch/``)."""
    base = os.path.join(root, "build", "psi_bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")


@dataclass
class Trace:
    start_ns: int
    stop_ns: int
    sets: int
    ops: list
    spans: list
    server_us: list


@dataclass
class Run:
    """What a run measured, handed to every metric's reader."""
    config: dict
    traffic: dict
    shape: dict = field(default_factory=dict)
    setup_s: float = 0.0
    offline_s: float = 0.0
    window_s: float = 0.0
    sets_done: int = 0
    latencies_ms: list = field(default_factory=list)
    wire_bytes: int = 0
    trace: Trace | None = None


def set_order(traffic: dict, seed: int):
    """Pool indices of exchange k: the pool in a seeded order, cycled."""
    pool, per = traffic["pool"], traffic["sets_per_exchange"]
    order = list(range(pool))
    random.Random(seed ^ 0x5E75).shuffle(order)
    return lambda k: [order[(k * per + j) % pool] for j in range(per)]


def _apply(overrides: dict, config: dict, traffic: dict) -> dict:
    program = {}
    for key, value in (overrides or {}).items():
        part, _, name = key.partition(".")
        {"config": config, "traffic": traffic, "program": program}[part][name] = value
    return program


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None) -> tuple[spec.Cell, Run, dict]:
    """One run of a cell on ``device``: -> (cell, run, result line)."""
    import torch

    from psi_bench import exchange
    from psi_bench.trace import Profile

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load(root, workload)
    config, traffic = dict(cell.config), dict(cell.traffic)
    program = _apply(overrides, config, traffic)
    run = Run(config, traffic)

    server_items = sets.server_set(seed, config["server_set_size"], config["bit_size"])
    size = config["client_set_size"]
    pool = sets.client_pool(seed, server_items, traffic["pool"], size,
                            round(size * traffic["common_share"]), config["bit_size"])
    session = exchange.Session(config, server_items, device, time_decrypt=trace,
                               program=program)
    sets_of = set_order(traffic, seed)

    def ask(qs):
        return [session.ask_one(qs[0])] if len(qs) == 1 else session.ask_many(qs)

    late = threading.Timer(seconds + LATE_S, session.give_up)
    late.daemon = True
    try:
        session.open(pool)
        run.offline_s, run.shape = session.offline_s, session.shape()
        for k in range(traffic["warmup_exchanges"]):
            ask(sets_of(k))
        if device != "cpu":
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start

        answers, exchanges, missing = [], [], []
        prof, tries, traced_from = None, 0, traffic["trace_after"]
        session.reset_wire()
        t0 = time.perf_counter()
        late.start()
        k = 0
        while time.perf_counter() - t0 < seconds:
            if trace and prof is None and k == traced_from and tries < TRACE_TRIES:
                prof, tries = Profile(), tries + 1
                prof.start()
            qs = sets_of(traffic["warmup_exchanges"] + k)
            begin_ns, begin = time.time_ns(), time.perf_counter()
            try:
                served = ask(qs)
            except ConnectionError:
                if not session.gave_up:
                    raise
                missing = qs
                break
            end = time.perf_counter()
            exchanges.append(("exchange", begin_ns, time.time_ns()))
            answers.extend(zip(qs, served))
            run.latencies_ms.append((end - begin) * 1e3)
            k += 1
            if prof is not None and k == traced_from + traffic["trace_exchanges"]:
                prof.stop()
                if any(op[0] == "kernel" for op in prof.ops) or tries == TRACE_TRIES:
                    run.trace = _trace(prof, traffic, session, exchanges)
                else:  # the profiler recorded no kernel: trace the next stretch
                    traced_from = k
                prof = None
        run.window_s = time.perf_counter() - t0
        if prof is not None:  # the window closed inside the traced stretch
            prof.stop()
            run.trace = _trace(prof, traffic, session, exchanges)
        run.wire_bytes, run.sets_done = session.wire_bytes, len(answers)
    finally:
        late.cancel()
        session.close()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del session
    if device != "cpu":
        torch.cuda.empty_cache()

    # a set given up misses its whole intersection
    wrong = reference.judge(server_items, pool, answers)
    wrong += [max(1, len(reference.intersection(server_items, pool[q]))) for q in missing]
    checks = {"wrong_items": {"value": sum(wrong), "limit": 0}}
    correct = bool(answers) and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(wrong),
            "failed": sum(1 for w in wrong if w),
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        t = run.trace
        busy = _busy_ns(t)
        dev["busy_s"], dev["window_s"] = busy / 1e9, (t.stop_ns - t.start_ns) / 1e9
        line["breakdown"] = _breakdown(t)
    line["checks"] = checks
    return cell, run, line


def _trace(prof, traffic: dict, session, exchanges: list) -> Trace:
    lo, hi = prof.start_ns, prof.stop_ns
    spans = [s for s in session.spans if s[1] is not None and lo <= s[1] <= hi]
    steps = [(s, us) for s, us in session.server_us if s is not None and lo <= s <= hi]
    mine = [e for e in exchanges if lo <= e[1] <= hi]
    return Trace(lo, hi, len(mine) * traffic["sets_per_exchange"], prof.ops,
                 spans + mine, steps)


def _busy_ns(t: Trace) -> int:
    from psi_bench.trace import union_ns

    return union_ns([(op[2], op[3]) for op in t.ops], t.start_ns, t.stop_ns)


def _breakdown(t: Trace) -> dict:
    from psi_bench.trace import gaps_ns, span_at

    by_name = defaultdict(int)
    for _, name, s, e in t.ops:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(gaps_ns([(op[2], op[3]) for op in t.ops], t.start_ns, t.stop_ns),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[span_at(t.spans, (s + e) // 2), (e - s) / 1e9] for s, e in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[], metavar="PART.KEY=JSON",
                    help="override a config., traffic. or program. value (the control: "
                         "program.bit_size=16; never in a measured run)")
    args = ap.parse_args(argv)
    root = os.getcwd()
    cache_dirs(root)
    cell = spec.load(root, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"psi_bench: the cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        try:
            overrides[key] = json.loads(value)
        except json.JSONDecodeError:
            overrides[key] = value
    _, run, line = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", overrides, T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"psi_bench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"psi_bench: {line['attempted']} sets, shape {run.shape}, setup_s {run.setup_s:.3f}, "
          f"window_s {run.window_s:.3f}", file=sys.stderr)
    lat = sorted(run.latencies_ms)
    if len(lat) >= 20:
        q = statistics.quantiles(lat, n=100)
        print(f"psi_bench: exchange ms p50 {q[49]:.1f} p90 {q[89]:.1f} p95 {q[94]:.1f} "
              f"p99 {q[98]:.1f} max {lat[-1]:.1f}; over twice the median "
              f"{sum(x > 2 * q[49] for x in lat)} of {len(lat)}", file=sys.stderr)
    if run.trace is not None:
        kinds = [op[0] for op in run.trace.ops]
        print(f"psi_bench: traced {run.trace.sets} sets, {kinds.count('kernel')} kernels, "
              f"{kinds.count('copy')} copies, {len(run.trace.spans)} spans", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
