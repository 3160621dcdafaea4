"""What ``BENCHMARK.json`` names, found by name under the benchmark's folder.

A cell (``workloads`` entry) joins a configuration (its ``file``), a traffic
mix (``psi_bench/traffic/<traffic>.json``) and the metrics that list it or
list no cells. A metric's reader is ``psi_bench/metrics/<name>.py``.
Adding a configuration, a mix or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = "psi_bench"


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # callable(run) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[Metric] = field(default_factory=list)
    per_layer: list[Metric] = field(default_factory=list)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(root: str, name: str):
    """The ``read`` function of metric ``name``'s reader file."""
    folder = os.path.join(root, BENCH_DIR, "metrics")
    path = os.path.join(folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} under {folder}")
    spec = importlib.util.spec_from_file_location(f"{BENCH_DIR}_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(root: str, entries: list[dict], cell: str) -> list[Metric]:
    return [Metric(m["name"], m["unit"], reader(root, m["name"]))
            for m in entries if cell in m.get("workloads", [cell])]


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return Cell(workload, int(w["chips"]), config, traffic,
                _metrics(root, bench["end_to_end"], workload),
                _metrics(root, bench["per_layer"], workload))
