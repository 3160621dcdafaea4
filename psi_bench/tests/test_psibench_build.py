"""The readers of the server's build spans (``build_spans.py``,
``metrics/build_*_s.py``) on made-up spans and without them, and the north
star's cell found by name and run end to end on a tiny configuration."""

import types

import pytest
import torch

from psi_bench import run, spec
from psi_bench.tests import tiny
from psi_bench.tests.tiny import REPO

from nested_hashing_psi_tpu_torch.utils import profiling
from nested_hashing_psi_tpu_torch.utils.profiling import Span

CELL = "bfv_s2p24_c4096.interactive_pool4"
BUILD = ("build_insert_s", "build_encode_s", "build_host_s")
S = 1_000_000_000
MADE_UP = [  # name, parent, start s, end s
    ("build.insert", "server.offline", 1, 2),      # an earlier build
    ("build.encode", "server.offline", 2, 3),
    ("server.offline", None, 0, 4),
    ("build.insert", "server.offline", 11, 15),    # the last build
    ("build.encode", "server.offline", 16, 26),
    ("server.offline", None, 10, 30),
    ("client.exchange", None, 40, 41),
]


def with_spans(monkeypatch, rows):
    spans = [Span(n, s * S, e * S, p, None, "t") for n, p, s, e in rows]
    monkeypatch.setattr(profiling, "TRACER", types.SimpleNamespace(
        between=lambda lo, hi: [s for s in spans if s.end_ns >= lo and s.start_ns <= hi]))
    return run.Run({}, {})


@pytest.mark.parametrize("name, want", [("build_insert_s", 4.0), ("build_encode_s", 10.0),
                                        ("build_host_s", 20.0 - 4.0 - 10.0)])
def test_readers_on_made_up_spans(monkeypatch, name, want):
    assert spec.reader(REPO, name)(with_spans(monkeypatch, MADE_UP)) == pytest.approx(want)


@pytest.mark.parametrize("name", BUILD)
def test_readers_find_nothing_without_the_build_spans(monkeypatch, name):
    """A program whose build opens no span (the parent of these readers),
    and one without the tracer: every reader says None."""
    online = [r for r in MADE_UP if not r[0].startswith(("build.", "server.offline"))]
    assert spec.reader(REPO, name)(with_spans(monkeypatch, online)) is None
    monkeypatch.delattr(profiling, "TRACER")
    assert spec.reader(REPO, name)(run.Run({}, {})) is None


def test_host_reader_needs_the_inner_spans(monkeypatch):
    offline_only = [r for r in MADE_UP if r[0] == "server.offline"]
    assert spec.reader(REPO, "build_host_s")(with_spans(monkeypatch, offline_only)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def test_the_north_star_cell_is_found_by_name(root):
    cell = spec.load(REPO, CELL)
    assert cell.chips == 1 and cell.config["server_set_size"] == 1 << 24
    assert cell.config["reduced"] == [] and cell.traffic["pool"] == 4
    assert {m.name for m in cell.end_to_end} == {"sets_per_s", "online_p95_ms", "setup_s"}
    old = spec.load(REPO, "bfv_s2p20_c2048.interactive")
    assert {m.name for m in cell.per_layer} == {m.name for m in old.per_layer}
    assert set(BUILD) <= {m.name for m in cell.per_layer}
    assert spec.load(root, CELL).config["ring_dim"] == tiny.TINY["ring_dim"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_north_star_cell_runs_on_the_tiny_root(root, trace):
    cell, rec, line = run.run_cell(root, CELL, 2**33 + 41 + trace, 2.0, bool(trace),
                                   device="cpu", overrides=tiny.SMALL_TRAFFIC)
    assert line["correct"] and line["failed"] == 0 and rec.sets_done == line["attempted"] > 0
    if trace:  # the device trace's metrics have no device to read on the CPU
        assert set(BUILD) | {"offline_s", "online_mib_per_set", "server_step_ms"} \
            <= set(line["metrics"]) <= {m.name for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
