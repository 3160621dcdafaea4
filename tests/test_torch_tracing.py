"""The port's tracer (``utils/profiling.py``): off, a whole run keeps
nothing and reads no clock but for the server's offline build, whose spans
are recorded always; on (``enable()`` or a torch.profiler session), a CPU
loopback BatchedFHE exchange at ring 128 records every span the protocol,
wire, PIE and scheme layers open, nested as they are called, in each
party's thread, numbered by the party's online phase, each frame's span
with the host copies its path made; ``between`` clips;
``device_trace`` writes the spans into its chrome trace, aligned with the
profiler's events."""

import contextlib
import itertools
import json
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import (
    BatchedFHEPSIClient,
    BatchedFHEPSIServer,
)
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel
from nested_hashing_psi_tpu_torch.protocol.runner import default_data, run_parties
from nested_hashing_psi_tpu_torch.utils import profiling
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER, Profiler

torch.set_num_threads(1)

RING, LIMBS = 128, 10
EXCHANGES = 3

# each span the online phase opens, by party, with its parent
CLIENT = {
    "client.exchange": None, "wire.pack": "client.exchange", "wire.unpack": "client.exchange",
    "wire.wait": "wire.unpack", "client.decrypt": "client.exchange",
    "decrypt.phase": "client.decrypt", "decrypt.download": "client.decrypt",
    "decrypt.crt": "client.decrypt", "client.extract": "client.exchange",
}
SERVER = {
    "server.exchange": None, "wire.unpack": "server.exchange", "wire.wait": "wire.unpack",
    "server.step": "server.exchange", "pie.position_sum": "server.step",
    "pie.combine": "server.step", "scheme.mul_relin": "pie.combine",
    "wire.pack": "server.exchange",
}


@pytest.fixture
def tracer():
    TRACER.disable()
    TRACER.clear()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.clear()


@contextlib.contextmanager
def enabled():
    TRACER.enable()
    try:
        yield
    finally:
        TRACER.disable()


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def exchange_run(scheme: str, on_from: int | None, switch_on):
    """Both parties over a loopback channel, the server in its own thread:
    set-up, the offline build, then EXCHANGES online phases. ``switch_on``
    (a context) is entered before online phase ``on_from`` (0-based; -1:
    before set-up; None: never) and left when both parties are done.
    -> (client, the server thread's name)."""
    psi = PSIParams(server_set_size=300, client_set_size=12, intersection_set_size=5,
                    hash_seed=987654321, item_seed=123456789, bit_size=32, fhe=True,
                    batched=True, bgv=scheme == "bgv", ring_dim=RING, num_limbs=LIMBS)
    ht = HashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=4)
    ch_client, ch_server = LoopbackChannel.pair()
    client = BatchedFHEPSIClient(default_data(psi), psi, ht, ch_client, device="cpu")
    server = BatchedFHEPSIServer(default_data(psi), psi, ht, ch_server, device="cpu")
    names = []

    def serve():
        names.append(threading.current_thread().name)
        server.run_setup_phase()
        server._signal_phase_over()
        server.run_offline_phase()
        server._signal_phase_over()
        for _ in range(EXCHANGES):
            server.run_online_phase()

    def ask(stack):
        if on_from == -1:
            stack.enter_context(switch_on())
        client.run_setup_phase()
        client._read_phase_over()
        client.run_offline_phase()
        client._read_phase_over()
        for k in range(EXCHANGES):
            if k == on_from:
                stack.enter_context(switch_on())
            client.run_online_phase()
            assert client.intersection_matches()

    with contextlib.ExitStack() as stack:
        run_parties(lambda: ask(stack), serve, ch_server)
    return client, names[0]


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_off_keeps_nothing_and_reads_no_clock(tracer, monkeypatch, scheme):
    """Off, set-up, the offline phases and the online phases keep nothing
    and read no clock, but for the server's offline build, whose three
    spans are recorded always: only ``synced_span`` may read the clock."""
    synced = profiling.synced_span.__wrapped__.__code__
    clock = time.time_ns

    def build_clock():
        frame = sys._getframe(1)
        while frame is not None and frame.f_code is not synced:
            frame = frame.f_back
        if frame is None:
            raise AssertionError("an off span read the clock")
        return clock()

    monkeypatch.setattr(time, "time_ns", build_clock)
    client, _ = exchange_run(scheme, None, enabled)
    assert client.exchanges == EXCHANGES
    assert [s.name for s in tracer.spans] == ["build.insert", "build.encode", "server.offline"]


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
@pytest.mark.parametrize("mode, on_from", [("enable", -1), ("profiler", 1)])
def test_on_records_the_exchange_nested(tracer, scheme, mode, on_from):
    _, server_thread = exchange_run(scheme, on_from,
                                    enabled if mode == "enable" else cpu_profiler)
    spans = [s for s in tracer.spans if s.exchange is not None]  # set-up's have none
    main = threading.current_thread().name
    assert {s.thread for s in spans} == {main, server_thread}
    first = max(on_from, 0) + 1  # the first online phase recorded, 1-based
    for party, want in ((main, CLIENT), (server_thread, SERVER)):
        mine = [s for s in spans if s.thread == party]
        assert {s.name for s in mine} <= set(want)
        # numbered by the party's own count, counted while off too
        assert {s.exchange for s in mine} == set(range(first, EXCHANGES + 1))
        root = next(n for n, p in want.items() if p is None)
        roots = {s.exchange: s for s in mine if s.name == root}
        # the server may have opened the phase after the switch while off
        late = on_from >= 0 and party == server_thread
        assert set(range(first + late, EXCHANGES + 1)) <= set(roots)
        for s in mine:
            if s.exchange in roots:
                assert s.parent == want[s.name], s
                assert _within(s, roots[s.exchange]), s
        for k in roots:
            assert {s.name for s in mine if s.exchange == k} == set(want)
    client = {s.exchange: s for s in spans if s.name == "client.exchange"}
    for step in (s for s in spans if s.name == "server.step"):
        assert _within(step, client[step.exchange])  # the same request
    frames = [s for s in spans if s.name in ("wire.pack", "wire.unpack")]
    assert all(s.nbytes > 0 for s in frames)
    # on the CPU every frame is joined into bytes (one copy of its payload),
    # a residue frame read onto the device copied once, a meta vector (at
    # most two uint64) read as it came
    for s in frames:
        copies = 1 if s.name == "wire.pack" else int(s.nbytes > 16)
        assert s.counts == {"host_copies": copies}, s
    minus = 2 * LIMBS * RING * 4
    assert [s.nbytes for s in frames if s.thread == main][0] == minus


def test_device_span_on_the_cpu_has_no_device_ms():
    """A span on an explicit CPU device records no device time; ``device=True``
    means the card where there is one: it times it there, and records
    nothing on a machine without one."""
    prof = Profiler()
    with prof.span("cpu", device=torch.device("cpu")):
        torch.ones(8).add_(1)
    if torch.cuda.is_available():
        torch.cuda.init()  # device=True times the card once CUDA is in use
    with prof.span("default", device=True):
        torch.ones(8).add_(1)
    got = {s.name: s.device_ms for s in prof.between(0, 2**63)}
    assert got["cpu"] is None
    if torch.cuda.is_available():
        assert got["default"] is not None and got["default"] >= 0
    else:
        assert got["default"] is None


def test_between_clips_to_the_stretch(monkeypatch):
    ticks = itertools.count(10, 10)
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    prof = Profiler()
    with prof.span("outer", exchange=4):    # 10 .. 60
        with prof.span("a", nbytes=8):      # 20 .. 30
            pass
        with prof.span("b"):                # 40 .. 50
            pass
    with prof.span("after"):                # 70 .. 80
        pass
    got = [(s.name, s.start_ns, s.end_ns, s.parent, s.exchange) for s in prof.between(25, 45)]
    assert got == [("a", 25, 30, "outer", 4), ("b", 40, 45, "outer", 4),
                   ("outer", 25, 45, None, 4)]
    assert [s.start_ns for s in prof.spans] == [20, 40, 10, 70]  # the originals unclipped
    assert prof.between(81, 90) == []
    prof.clear()
    assert prof.spans == []


def test_device_trace_writes_the_spans_aligned(tracer, tmp_path):
    log = str(tmp_path / "trace")
    with profiling.device_trace(log):
        with TRACER.span("outer", exchange=1):
            with TRACER.span("inner", nbytes=16):
                torch.ones(64).add_(1)
    assert TRACER.spans and not TRACER.enabled  # recorded under the profiler alone
    with open(os.path.join(log, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    assert mine["inner"]["args"] == {"parent": "outer", "exchange": 1, "nbytes": 16}
    tracks = {e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"
              and e.get("pid") == "program spans"}
    assert tracks == {threading.current_thread().name}
    add = next(e for e in events if e.get("name") == "aten::add_")
    inner = mine["inner"]
    assert inner["ts"] <= add["ts"] and add["ts"] + add["dur"] <= inner["ts"] + inner["dur"]


@pytest.mark.gpu
def test_device_spans_time_the_card_and_add_no_device_operation():
    """On a card: a device span's events give its device time, and tracing a
    step under torch.profiler adds no device operation (no event, no range
    on the device's timeline) to the kernels it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(1024, 1024, device="cuda")
    prof = Profiler()

    def plain():
        return (x @ x).sum().item()

    def spanned():
        with prof.span("outer", device=x.device):
            with prof.span("inner", device=True):
                return (x @ x).sum().item()

    device_ops = []
    for step in (plain, spanned):
        step()  # warm
        prof.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            step()
            torch.cuda.synchronize()
        device_ops.append(sorted(e.name() for e in p.profiler.kineto_results.events()
                                 if e.device_type().name == "CUDA"))
    assert device_ops[0] == device_ops[1] and device_ops[0]
    got = {s.name: s.device_ms for s in prof.between(0, 2**63)}
    assert 0 < got["inner"] <= got["outer"]
