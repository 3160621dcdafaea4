"""Tracing and profiling utilities (the port's copy of
``nested_hashing_psi_tpu.utils.profiling``).

 - Span, Profiler: nestable wall-clock spans kept in memory. ``TRACER`` is
   the port's one tracer: the protocol, wire, scheme and PIE layers open
   their spans on it. It records only while it is enabled (``enable``) or
   while a torch.profiler session is active, so a traced stretch of a run
   holds the program's spans with nothing else switched on. Off, a span
   is one flag read: it creates no object and reads no clock.
 - device_trace: context manager around torch.profiler, writing a chrome
   trace of the host, (on a GPU) the device and the tracer's spans into a
   directory.

Spans are on the clock of ``time.time_ns``, the clock onto which a
torch.profiler trace's device operations are mapped (through an anchor
recorded as the trace starts), so a span's interval and a kernel's compare
directly. A span's ``parent`` is the name of the innermost span open in the
same thread when it opened, ``thread`` that thread's name, ``exchange`` the
online-phase ordinal its party last declared in that thread
(``span(..., exchange=k)``), ``nbytes`` the frame's size for a wire span.
A span opened with ``device=`` a CUDA device (or True, where CUDA is in
use) also records a pair of timing events on the current stream;
``device_ms`` is their elapsed time, resolved when the spans are read
(``between``), never while they are recorded. No span emits a
``record_function`` range.

``synced_span`` opens a span that is recorded whether or not the tracer
records, with the device synchronised at both ends so that its host time
holds the device work issued inside it: the server's offline build
(``server.offline``, ``build.insert``, ``build.encode``) runs once, in
set-up, outside any traced stretch. Such a span carries its ``counts``
(e.g. the insert's rounds and evictions).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

from nested_hashing_psi_tpu_torch.utils.device import synchronize

_OFF = contextlib.nullcontext()  # what an off span returns: reusable, holds nothing


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None = None
    parent: str | None = None
    exchange: int | None = None
    thread: str | None = None
    nbytes: int | None = None
    device_ms: float | None = None
    counts: dict | None = None

    @property
    def duration_us(self) -> int:
        assert self.end_ns is not None
        return (self.end_ns - self.start_ns) // 1000


def _cuda_stream(device):
    """The current stream of ``device`` when the span should time the
    device: a CUDA ``torch.device``, or True while CUDA is in use."""
    if device is True:
        return torch.cuda.current_stream() if torch.cuda.is_initialized() else None
    if getattr(device, "type", None) == "cuda":
        return torch.cuda.current_stream(device)
    return None


class _Open:
    """The context of one recorded span: pushes it on its thread's stack,
    records it (and its end event) when the block exits."""

    __slots__ = ("prof", "span", "stack")

    def __init__(self, prof: "Profiler", name: str, nbytes, device):
        local = prof._thread_state()
        self.prof, self.stack = prof, local.stack
        parent = local.stack[-1].name if local.stack else None
        self.span = Span(name, 0, None, parent, local.exchange, local.name, nbytes)
        stream = _cuda_stream(device) if device else None
        if stream is not None:
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record(stream)
            self.span._events = (begin, end, stream)
        self.span.start_ns = time.time_ns()
        local.stack.append(self.span)

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        events = getattr(s, "_events", None)
        if events is not None:
            events[1].record(events[2])
        s.end_ns = time.time_ns()
        if self.stack and self.stack[-1] is s:
            self.stack.pop()
        self.prof.spans.append(s)
        return False


class Profiler:
    """Spans kept in memory, in the order they closed. A fresh profiler
    records every span, as the JAX package's does; the module's ``TRACER``
    starts disabled and records while enabled or while torch.profiler is
    active."""

    def __init__(self, enabled: bool = True):
        self.spans: list[Span] = []
        self.enabled = enabled
        self._local = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Forget every span, and each thread's open spans and ordinal."""
        self.spans = []
        self._local = threading.local()

    def _thread_state(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.exchange = [], None
            local.name = threading.current_thread().name
        return local

    def span(self, name: str, *, nbytes: int | None = None, device=False,
             exchange: int | None = None):
        """Context manager: a span ``name`` while the profiler records, else
        nothing. ``exchange`` declares this thread's online-phase ordinal
        for this span and every later one (whether or not it records)."""
        if exchange is not None:
            self._thread_state().exchange = exchange
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, nbytes, device)

    def between(self, lo_ns: int, hi_ns: int) -> list[Span]:
        """Copies of the closed spans that overlap [lo_ns, hi_ns], clipped to
        it, with ``device_ms`` resolved (None for a span the edge cut, whose
        device time cannot be split, and for a span without events)."""
        out = []
        for s in list(self.spans):
            if s.end_ns < lo_ns or s.start_ns > hi_ns:
                continue
            events = getattr(s, "_events", None)
            ms = None
            if events is not None and lo_ns <= s.start_ns and s.end_ns <= hi_ns:
                events[1].synchronize()
                ms = events[0].elapsed_time(events[1])
            out.append(dataclasses.replace(s, start_ns=max(s.start_ns, lo_ns),
                                           end_ns=min(s.end_ns, hi_ns), device_ms=ms))
        return out

    def report(self) -> dict[str, int]:
        return {s.name: s.duration_us for s in self.spans}


TRACER = Profiler(enabled=False)


@contextlib.contextmanager
def synced_span(name: str, device):
    """A span on ``TRACER`` recorded whether or not it records, timed on
    the host clock between two synchronises of ``device`` (a
    ``torch.device``), with the device's events beside it. Yields the
    span, whose ``counts`` the block may set."""
    synchronize(device)
    with _Open(TRACER, name, None, device) as span:
        yield span
        synchronize(device)

_ANCHOR_OP = "aten::empty"  # the op device_trace issues first, to align the clocks


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a region with torch.profiler (host ops, and the device's
    kernels when CUDA is available) and write it to
    ``log_dir/trace.json``, a chrome trace (chrome://tracing, Perfetto),
    with ``TRACER``'s spans of the region on a track of their own per
    thread. The profiler's clock is aligned to the spans' by the first
    ``aten::empty`` this thread issues in the trace, taken right after a
    ``time.time_ns`` reading. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        anchor = time.time_ns()
        torch.empty(0)
        lo = time.time_ns()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        hi = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    tid = threading.get_native_id()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == _ANCHOR_OP and e.start_thread_id() == tid]
    offset = min(starts) - anchor if starts else 0
    _add_spans(path, TRACER.between(lo, hi), offset)


def _add_spans(path: str, spans: list[Span], offset_ns: int) -> None:
    """Append ``spans`` to the chrome trace at ``path``, shifted onto the
    profiler's clock by ``offset_ns``: process "program spans", one thread
    track per span thread."""
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = "program spans"
    tids = {name: i for i, name in enumerate(dict.fromkeys(s.thread for s in spans))}
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": i, "args": {"name": n}}
               for n, i in tids.items()]
    for s in spans:
        args = {k: getattr(s, k) for k in ("parent", "exchange", "nbytes", "device_ms")
                if getattr(s, k) is not None}
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": tids[s.thread], "ts": (s.start_ns + offset_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
