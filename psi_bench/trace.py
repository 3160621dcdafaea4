"""The device trace of a traced stretch, and the arithmetic on it.

``Profile`` runs ``torch.profiler`` (CPU and CUDA activities) over a
stretch of the window and keeps what it recorded in memory: every device
operation as ``(kind, name, start_ns, end_ns)``, on the host clock of
``time.time_ns`` (an annotation recorded at the start fixes the offset
between the two clocks). ``kind`` is ``copy`` for a memcpy or memset and
``kernel`` for any other operation. The harness's spans are on the same clock and never overlap in
time: each ends in a synchronise, so the device operations it issued run
inside it, and an operation is attributed to the span that holds its start.

Copied here from the port's ``benchmarks/timing.py`` (the kernel events of
a torch.profiler trace) and ``benchmarks/card.py`` (K2's bound at the H100's
peaks), so that a change to the program cannot change the yardstick.
"""

from __future__ import annotations

import time

# H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3; 32-bit integer
# instructions at 128 lanes a clock an SM, 132 SMs at 1.98 GHz, a 32x32->64
# product taking two slots of the FMA pipe's half of them.
HBM_BYTES_S = 3.35e12
WIDE_MUL_S = 128 * 132 * 1.98e9 / 4

K1_NAMES = ("ntt_fwd_kernel", "ntt_inv_kernel")  # csrc/ntt.cu
K2_NAMES = ("pie_ip_kernel",)                     # csrc/pie_ip.cu


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_NAMES)


def is_k2(name: str) -> bool:
    return any(k in name for k in K2_NAMES)


def k2_bound_s(H: int, D: int, P: int, L: int, N: int) -> float:
    """Least seconds of one position sum: the index ciphertexts (H,P,2,L,N)
    and the table (H,D,P,L,N) read once and the sum (H,D,2,L,N) written
    once at HBM_BYTES_S, or its two 32x32->64 products a table word at
    WIDE_MUL_S, whichever is longer (``card.k2_bound``)."""
    nbytes = 4 * (H * P * 2 * L * N + H * D * P * L * N + H * D * 2 * L * N) + 8 * L
    return max(nbytes / HBM_BYTES_S, 2 * H * D * P * L * N / WIDE_MUL_S)


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


def span_at(spans, t: int, default: str = "between_exchanges") -> str:
    for name, s, e in spans:
        if s <= t <= e:
            return name
    return default


def in_spans(ops, spans, name: str):
    """The operations whose start lies in a span called ``name``."""
    marks = sorted((s, e) for n, s, e in spans if n == name)
    return [op for op in ops if any(s <= op[2] <= e for s, e in marks)]


def _annotation(event) -> bool:
    """A range of ``record_function`` drawn on the device's timeline, not an
    operation (torch 2.11's events have no activity type)."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else event.name().startswith("psi_bench.")


class Profile:
    """torch.profiler over a stretch; ``ops`` after ``stop``."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.ops: list[tuple[str, str, int, int]] = []
        self.start_ns = self.stop_ns = None

    def start(self) -> None:
        from torch.profiler import record_function

        self._prof.__enter__()
        self._anchor = time.time_ns()
        with record_function("psi_bench.anchor"):
            pass
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stop_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        offset = next((e.start_ns() - self._anchor for e in events
                       if e.name() == "psi_bench.anchor"), 0)
        for e in events:
            if e.device_type().name != "CUDA" or _annotation(e):
                continue
            name = e.name()
            kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
            self.ops.append((kind, name, e.start_ns() - offset, e.end_ns() - offset))
        self._prof = None
