"""The import check and the run's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from psi_bench import run
from psi_bench.tests.tiny import REPO


@pytest.mark.parametrize("names, found", [
    (["nested_hashing_psi_tpu"], ["nested_hashing_psi_tpu"]),
    (["nested_hashing_psi_tpu.ops.ntt"], ["nested_hashing_psi_tpu"]),
    (["nested_hashing_psi_tpu_torch", "nested_hashing_psi_tpu_torch.ops"], []),
    (["jax.numpy", "jaxlib", "flax.linen", "numpy"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "torch"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def test_without_a_card_the_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    p = subprocess.run([sys.executable, "-m", "psi_bench.run", "--workload",
                        "bfv_s2p20_c2048.interactive", "--seed", str(2**33), "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_benchmark_json_names_only_files_under_its_paths():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["psi_bench"]
    for c in bench["configs"]:
        assert c["file"].startswith("psi_bench/") and os.path.exists(os.path.join(REPO, c["file"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(REPO, "psi_bench", "traffic", f"{w['traffic']}.json"))


def test_no_harness_source_imports_the_jax_package():
    bench = os.path.join(REPO, "psi_bench")
    for dirpath, _, files in os.walk(bench):
        for name in files:
            if name.endswith(".py") and not name.startswith("test_"):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                for line in text.splitlines():
                    words = line.replace(",", " ").split()
                    if words[:1] in (["import"], ["from"]):
                        assert run.forbidden_modules([words[1]]) == [], (name, line)
