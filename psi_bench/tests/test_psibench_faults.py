"""The comparison that decides ``correct`` fails what it must: the control
(the program's own 16-bit path, t = 65537, serving the cell's 32-bit
items) at the cell's own size on the card, and each fault that a one-chip
cell can have, planted in the program under a whole run of the harness on
the CPU, with the look for a card skipped. (No cell spans chips, so no
exchange between chips can be left out.)

The control's false items need a client item equal mod t to one of the
H x D server items it is compared with: about 24 / 65537 of an item, 0.4
a 2048-item set, 6 in the pool of 16. At a size a CPU run holds they do
not appear, so the control runs on the card; on the CPU the test only
checks that the control's path runs through the harness."""

import json
import subprocess
import sys
import time

import pytest
import torch

from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext
from nested_hashing_psi_tpu_torch.pie import batched_fhe as pie_mod
from psi_bench import run
from psi_bench.tests import tiny

SEED = 2**32 + 4242
with open(f"{tiny.REPO}/BENCHMARK.json") as _f:
    CARD_CELLS = [w["name"] for w in json.load(_f)["workloads"]]
CELLS = CARD_CELLS + tiny.LATER_CELLS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def run_tiny(root, workload, extra=None):
    # a multi-query exchange of distinct sets, as in the cell (its pool)
    pool = {"traffic.pool": 16} if "split16" in workload else {}
    _, _, line = run.run_cell(root, workload, SEED, 1.0, False, device="cpu",
                              overrides={**tiny.SMALL_TRAFFIC, **pool, **(extra or {})})
    return line


def assert_caught(line):
    assert line["correct"] is False
    assert line["checks"]["wrong_items"]["value"] > 0 and line["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_path_runs_through_the_harness(root, workload):
    line = run_tiny(root, workload, {"program.bit_size": 16})
    assert line["attempted"] > 0 and "wrong_items" in line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CARD_CELLS)
def test_control_at_the_cells_size_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size, on a CUDA card")
    p = subprocess.run([sys.executable, "-m", "psi_bench.run", "--workload", workload,
                        "--seed", str(2**33 + 99), "--seconds", "10", "--trace", "0",
                        "--set", "program.bit_size=16"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert_caught(json.loads(p.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload", CELLS)
def test_step_that_returns_its_state_unchanged(root, workload, monkeypatch):
    def unchanged(self, idx, minus):
        return Ciphertext(minus.expand(self.D, *minus.shape).clone(), self.ctx.default_form)

    monkeypatch.setattr(pie_mod.BatchedFHEPIE, "forward", unchanged)
    assert_caught(run_tiny(root, workload))


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_batch_left_out(root, workload, monkeypatch):
    if "split16" in workload:  # half of the sets served, their answers reused
        many = pie_mod.BatchedFHEPIE.run_many

        def half(self, idx, minus):
            h = idx.shape[0] // 2
            out = many(self, idx[:h], minus[:h])
            return torch.cat([out, out[: idx.shape[0] - h]])

        monkeypatch.setattr(pie_mod.BatchedFHEPIE, "run_many", half)
    else:  # half of the positions summed
        psum = pie_mod.position_sum

        def half(ctx, idx, table, p0=None, acc=None):
            return psum(ctx, idx[:, : idx.shape[1] // 2], table, p0 or 0, acc)

        monkeypatch.setattr(pie_mod, "position_sum", half)
    assert_caught(run_tiny(root, workload))


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_it_is_produced(root, workload, monkeypatch):
    extract = pie_mod.BatchedFHEClientOps.extract_intersection_mask
    monkeypatch.setattr(pie_mod.BatchedFHEClientOps, "extract_intersection_mask",
                        lambda self, mask: extract(self, mask)[1:])
    assert_caught(run_tiny(root, workload))


@pytest.mark.parametrize("workload", ["bfv_s2p20_c2048.interactive"])
def test_sets_that_never_come_are_wrong(root, workload, monkeypatch):
    forward, calls = pie_mod.BatchedFHEPIE.forward, []

    def stalls(self, idx, minus):  # the window's third answer comes too late
        calls.append(1)
        if len(calls) == 4:  # one warm-up exchange, then the window's
            time.sleep(2.5)
        return forward(self, idx, minus)

    monkeypatch.setattr(pie_mod.BatchedFHEPIE, "forward", stalls)
    monkeypatch.setattr(run, "LATE_S", 0.5)
    line = run_tiny(root, workload, {"traffic.warmup_exchanges": 1})
    assert_caught(line)
    assert line["failed"] == 1 and line["attempted"] == 3
