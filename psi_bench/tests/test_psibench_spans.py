"""The readers of the program's spans: their arithmetic on made-up spans
and device operations, and a whole ``--trace 1`` run on the CPU, in which
every host reader finds a number and the device readers find none."""

import json
import types

import pytest
import torch

from psi_bench import program_spans, run, spec
from psi_bench.tests import tiny
from psi_bench.tests.tiny import REPO

from nested_hashing_psi_tpu_torch.utils import profiling
from nested_hashing_psi_tpu_torch.utils.profiling import Span

with open(f"{REPO}/BENCHMARK.json") as _f:
    SPAN_METRICS = {m["name"]: m["workloads"] for m in json.load(_f)["per_layer"]
                    if m["source"] == "program_span" and m["name"] != "server_step_ms"}
DEVICE_READERS = {"server_mul_relin_ms", "idle_unattributed_share"}
SEED = 2**33 + 29


def test_interval_arithmetic():
    assert program_spans.merged([(5, 9), (0, 3), (2, 4), (7, 7)]) == [(0, 4), (5, 9)]
    assert program_spans.minus([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) == \
        [(0, 2), (4, 8), (22, 25), (26, 30)]
    assert program_spans.minus([(0, 10)], []) == [(0, 10)]
    assert program_spans.overlap_ns([(0, 4), (6, 10)], [(3, 7), (9, 20)]) == 1 + 1 + 1


MS = 1_000_000
MADE_UP = [  # name, thread, parent, start ms, end ms, device ms
    ("client.exchange", "c", None, 0, 20, None),
    ("wire.pack", "c", "client.exchange", 0, 2, None),
    ("wire.unpack", "c", "client.exchange", 2, 12, None),
    ("wire.wait", "c", "wire.unpack", 2, 11, None),
    ("client.decrypt", "c", "client.exchange", 12, 18, None),
    ("decrypt.crt", "c", "client.decrypt", 14, 18, None),
    ("client.extract", "c", "client.exchange", 18, 19, None),
    ("server.exchange", "s", None, 0, 11, None),
    ("wire.unpack", "s", "server.exchange", 0, 3, None),
    ("wire.wait", "s", "wire.unpack", 0, 2, None),
    ("server.step", "s", "server.exchange", 3, 10, None),
    ("scheme.mul_relin", "s", "pie.combine", 5, 9, 3.5),
    ("wire.pack", "s", "server.exchange", 10, 11, None),
]


def made_up_run(monkeypatch, scheme="bgv"):
    spans = [Span(n, s * MS, e * MS, p, 1, t, None, d) for n, t, p, s, e, d in MADE_UP]
    monkeypatch.setattr(profiling, "TRACER", types.SimpleNamespace(
        between=lambda lo, hi: [s for s in spans if s.end_ns >= lo and s.start_ns <= hi]))
    # the device ran 1-4 and 5-9 ms: idle 0-1, 4-5 and 9-20 of the stretch
    ops = [("kernel", "k", 1 * MS, 4 * MS), ("kernel", "k", 5 * MS, 9 * MS)]
    t = run.Trace(0, 20 * MS, 2, ops, [], [])
    return run.Run({}, {}, shape={"scheme": scheme}, trace=t)


@pytest.mark.parametrize("name, want", [
    ("wire_pack_ms", (2 + 1) / 2),
    ("wire_unpack_ms", ((10 - 9) + (3 - 2)) / 2),   # less the waits inside
    ("server_mul_relin_ms", 3.5 / 2),               # the device's time
    ("client_decrypt_host_ms", 4 / 2),
    ("client_extract_ms", 1 / 2),
    # idle 0-1, 4-5, 9-20 (13 ms); work: server 2-11 (its waits 0-2 out),
    # client 0-2 and 11-19: unattributed 19-20, 1 ms
    ("idle_unattributed_share", 100 * 1 / 13),
])
def test_readers_on_made_up_spans(monkeypatch, name, want):
    assert spec.reader(REPO, name)(made_up_run(monkeypatch)) == pytest.approx(want)


def test_decrypt_host_reader_is_silent_under_bfv(monkeypatch):
    assert spec.reader(REPO, "client_decrypt_host_ms")(made_up_run(monkeypatch, "bfv")) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_readers_find_nothing_without_the_tracer(monkeypatch, name):
    """The program before its tracer has no ``TRACER``: every reader says None."""
    made_up = made_up_run(monkeypatch)
    monkeypatch.delattr(profiling, "TRACER")
    assert spec.reader(REPO, name)(made_up) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["bfv_s2p20_c2048.interactive",
                                      "bgv_s2p20_c2048.interactive"])
def test_traced_cpu_run_reads_the_host_spans(root, workload):
    # a window long enough for the traced stretch on a loaded host
    _, rec, line = run.run_cell(root, workload, SEED, 6.0, True, device="cpu",
                                overrides=tiny.SMALL_TRAFFIC)
    assert line["correct"] and rec.trace is not None and rec.trace.sets > 0
    mine = {n for n, cells in SPAN_METRICS.items() if workload in cells}
    host = mine - DEVICE_READERS
    assert host and host <= set(line["metrics"])
    assert all(line["metrics"][n]["value"] > 0 for n in host)
    assert not (DEVICE_READERS & set(line["metrics"]))  # no device on the CPU
    assert not profiling.TRACER.enabled
