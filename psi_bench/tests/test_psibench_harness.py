"""Whole runs of the harness on the CPU, on tiny configurations (ring 128)
of the benchmark's own cells, mixes and metrics: each ends in a
well-formed result line; a sound run is correct."""

import json

import pytest
import torch

from psi_bench import run
from psi_bench.tests import tiny

with open(f"{tiny.REPO}/BENCHMARK.json") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]] + tiny.LATER_CELLS
SEED = 2**33 + 17
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def check_line(line, cell, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)  # one JSON object
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert DEVICE_KEYS <= set(line["device"])
    want = {m.name: m.unit for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float | int)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_cpu_and_is_correct(root, workload, trace):
    cell, rec, line = run.run_cell(root, workload, SEED + trace, 2.0, bool(trace),
                                   device="cpu", overrides=tiny.SMALL_TRAFFIC)
    check_line(line, cell, trace)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["wrong_items"]["value"] == 0
    assert rec.sets_done == line["attempted"]
    if not trace:
        assert {"setup_s", "sets_per_s"} <= set(line["metrics"])
        assert ("online_p95_ms" in line["metrics"]) == (cell.traffic["sets_per_exchange"] == 1)
    else:
        assert {"offline_s", "online_mib_per_set"} <= set(line["metrics"])
