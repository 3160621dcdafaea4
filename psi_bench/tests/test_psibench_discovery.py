"""A configuration, a traffic mix and a metric added as new files (and
entries in BENCHMARK.json) are found by name, with no edit to a file of
the harness, and run."""

import json
import os

import pytest
import torch

from psi_bench import run, spec
from psi_bench.tests import tiny


@pytest.fixture()
def root(tmp_path):
    torch.set_num_threads(1)
    root = tiny.make_root(str(tmp_path))
    bench_dir = os.path.join(root, "psi_bench")
    with open(os.path.join(bench_dir, "configs", "bfv_s2p20_c2048.json")) as f:
        config = {**json.load(f), "name": "bfv_other", "client_set_size": 16}
    with open(os.path.join(bench_dir, "configs", "bfv_other.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "traffic", "split16.json")) as f:
        mix = {**json.load(f), "sets_per_exchange": 2, "pool": 2}
    with open(os.path.join(bench_dir, "traffic", "pairs.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "metrics", "exchanges_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.latencies_ms))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "bfv_other", "source": "a test",
                             "file": "psi_bench/configs/bfv_other.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "bfv_other.pairs", "config": "bfv_other",
                               "traffic": "pairs", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "exchanges_done", "unit": "exchanges",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["bfv_other.pairs"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_new_files_are_found_by_name(root):
    cell = spec.load(root, "bfv_other.pairs")
    assert cell.config["client_set_size"] == 16 and cell.traffic["sets_per_exchange"] == 2
    names = [m.name for m in cell.end_to_end]
    assert "exchanges_done" in names and "online_p95_ms" not in names
    assert {m.name for m in cell.per_layer} == set()  # no per-layer metric lists it


def test_a_cell_of_new_files_runs_and_reports_the_new_metric(root):
    _, rec, line = run.run_cell(root, "bfv_other.pairs", 2**33 + 3, 1.0, False, device="cpu")
    assert line["correct"] and line["metrics"]["exchanges_done"]["value"] == len(rec.latencies_ms)
    assert line["metrics"]["exchanges_done"]["unit"] == "exchanges"


def test_a_metric_is_read_by_the_file_of_its_name_alone(root):
    read = spec.reader(root, "server_step_ms")
    assert read is not None and read.__module__.endswith("server_step_ms")
    for name in ("no_such_metric", "server_step_ms.latency"):
        with pytest.raises(FileNotFoundError):
            spec.reader(root, name)
