"""Timing and kernel tracing for the port's tools, in one module.

The probes and the bench and eval tools all time here:

  time_ms   CUDA events around calls issued back to back, after warm-ups
  graph_ms  CUDA events around replays of one CUDA graph of such calls:
            the device's time without the host's pace between launches
  wall_ms   the host clock around calls ending in one synchronise

Calls on one CUDA stream run in order and eager PyTorch elides none, so
nothing here fetches an element or ties one call to the next. Where a
call's output has its input's shape (an NTT), ``chain`` makes each call
transform the last one's output (x = fn(x)), as the JAX tools chain
theirs. On the CPU (the plain versions, for the tests) every function
takes the host clock.

The kernels' launch counters (``ntt_cuda.launches``,
``pie_kernels.launches``) go up where a wrapper launches its kernel; a
CUDA graph's capture is such a call, its replays are not, so they count
wrapper calls, each captured call once.

Every tool writes under ``EVAL_DIR``, ``eval_results_torch/`` at the
repository's root (listed in ``.gitignore``), never the working directory
or the JAX package's ``eval_results/``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVAL_DIR = os.path.join(ROOT, "eval_results_torch")
TRACE_TRIES = 3  # traces traced_kernels takes on the card before it returns none


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def time_ms(fn, device, iters: int) -> float:
    """Mean ms of fn(): CUDA events over ``iters`` calls back to back after
    two warm-ups on a GPU, the host clock after one on the CPU."""
    fn()
    if not _on_card(device):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    fn()
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def wall_ms(fn, device, iters: int, warm: int = 1) -> float:
    """Mean ms of fn() by the host clock over ``iters`` calls back to back
    (after ``warm``), ending in one synchronise: the pace of calls issued
    one after another, the host's share included."""
    for _ in range(warm):
        fn()
    if _on_card(device):
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if _on_card(device):
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def graph_ms(fn, device, iters: int = 20, reps: int = 5) -> float:
    """Mean device ms per call of ``iters`` calls of fn() captured in one
    CUDA graph, over ``reps`` replays after a warm one (CUDA events); on
    the CPU ``time_ms``. Nothing is allocated between the capture and the
    replays, so the inputs the graph read stay where it read them."""
    if not _on_card(device):
        return time_ms(fn, device, iters)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm up (and build cached tables) outside the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(device)
    del graph
    return start.elapsed_time(stop) / (reps * iters)


def chain(fn, x):
    """A call with no argument that applies fn to the last call's output,
    starting from x: each call transforms the last one's result."""
    state = [x]

    def step():
        state[0] = fn(state[0])
        return state[0]
    return step


def kernel_events(trace_path: str) -> list[tuple[str, float]]:
    """(name, ms) of every device kernel in a chrome trace of torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["dur"] / 1e3) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


def traced_kernels(fn, device, calls: int = 1,
                   log_dir: str | None = None) -> list[tuple[str, float]]:
    """(name, ms) of every device kernel that ``calls`` calls of fn() ran
    (after one warm-up), from a torch.profiler trace written to
    ``log_dir/trace.json`` (else a temporary directory); none on the CPU.
    On the card a trace that holds no kernel is taken again, up to
    TRACE_TRIES traces in all: on an H100 (torch 2.11) a trace now and
    then records none, even the first of a fresh process; the caller
    decides what an empty result means."""
    from nested_hashing_psi_tpu_torch.utils.profiling import device_trace

    fn()
    if _on_card(device):
        torch.cuda.synchronize(device)
    for _ in range(TRACE_TRIES if _on_card(device) else 1):
        with tempfile.TemporaryDirectory() as tmp:
            d = log_dir or tmp
            with device_trace(d):
                for _ in range(calls):
                    fn()
            kernels = kernel_events(os.path.join(d, "trace.json"))
        if kernels:
            break
    return kernels
