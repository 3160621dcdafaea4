"""Tracing and profiling utilities (the port's copy of
``nested_hashing_psi_tpu.utils.profiling``).

 - Span, Profiler: nestable wall-clock spans collected into a flat report,
 - device_trace: context manager around torch.profiler, writing a chrome
   trace of the host and (on a GPU) the device into a directory,
 - batched_pie_op_counts: rough roofline accounting (bytes moved, modmuls)
   for one batched-PIE online step, derived from static shapes.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None = None

    @property
    def duration_us(self) -> int:
        assert self.end_ns is not None
        return (self.end_ns - self.start_ns) // 1000


@dataclass
class Profiler:
    spans: list[Span] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        s = Span(name, time.monotonic_ns())
        try:
            yield s
        finally:
            s.end_ns = time.monotonic_ns()
            self.spans.append(s)

    def report(self) -> dict[str, int]:
        return {s.name: s.duration_us for s in self.spans}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a region with torch.profiler (host ops, and the device's
    kernels when CUDA is available) and write it to
    ``log_dir/trace.json``, a chrome trace (chrome://tracing, Perfetto).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def batched_pie_op_counts(H: int, D: int, P: int, L: int, N: int) -> dict[str, float]:
    """Static roofline accounting for one batched-PIE online step."""
    ct_pt_modmul = H * D * P * 2 * L * N
    relin_ntts = D * (H - 1) * (L + L * L)          # decompose iNTT + digit NTTs
    ntt_modmul = relin_ntts * (N // 2) * (N.bit_length() - 1) / N * N
    table_bytes = H * D * P * L * N * 4
    return {
        "ct_pt_modmuls": float(ct_pt_modmul),
        "relin_limb_ntts": float(relin_ntts),
        "approx_ntt_modmuls": float(ntt_modmul),
        "table_read_bytes": float(table_bytes),
    }
