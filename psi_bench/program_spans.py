"""The program's own spans over a traced stretch, and the arithmetic the
readers of ``program_span`` metrics share.

The port keeps its spans in memory on ``utils.profiling.TRACER``, on the
clock of ``time.time_ns`` (the clock ``trace.Profile`` maps the device's
operations onto), and records them while torch.profiler runs: the traced
stretch of a ``--trace 1`` run holds them with nothing switched on by the
harness. A program without that tracer gives no spans, and every reader
then returns None.

Span names (the program's): ``client.exchange``, ``server.exchange`` (a
party's online phase), ``wire.pack`` / ``wire.unpack`` (a frame sent /
received), ``wire.wait`` (a read blocked on the peer), ``server.step``,
``pie.position_sum``, ``pie.combine``, ``scheme.mul_relin``,
``client.decrypt`` with ``decrypt.device`` or ``decrypt.phase``,
``decrypt.download`` and ``decrypt.crt``, and ``client.extract``.
"""

from __future__ import annotations

WAIT = "wire.wait"
# open through a whole exchange, or the time spent waiting on the peer:
# none of them says what the host was doing
NOT_WORK = (WAIT, "client.exchange", "server.exchange")


def spans(run):
    """The program's spans of the traced stretch, clipped to it, or None."""
    t = run.trace
    if t is None or not t.sets:
        return None
    from nested_hashing_psi_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)
    if tracer is None or not hasattr(tracer, "between"):
        return None
    return tracer.between(t.start_ns, t.stop_ns) or None


def host_ms_per_set(run, name: str, minus_waits: bool = False):
    """Host ms a set in spans called ``name`` (both parties), less the
    ``wire.wait`` spans directly inside them with ``minus_waits``."""
    found = spans(run)
    mine = [s for s in found or () if s.name == name]
    if not mine:
        return None
    ns = sum(s.end_ns - s.start_ns for s in mine)
    if minus_waits:
        ns -= sum(s.end_ns - s.start_ns for s in found if s.name == WAIT and s.parent == name)
    return ns / 1e6 / run.trace.sets


def device_ms_per_set(run, name: str):
    """Device ms a set between the timing events of spans called ``name``;
    None where no such span timed the device (the CPU)."""
    ms = [s.device_ms for s in spans(run) or () if s.name == name and s.device_ms is not None]
    return sum(ms) / run.trace.sets if ms else None


def merged(intervals) -> list[tuple[int, int]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a, b) -> list[tuple[int, int]]:
    """Sorted disjoint intervals ``a`` less sorted disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def working(found) -> list[tuple[int, int]]:
    """When some thread was inside a span that names its work: in each
    thread, the union of its spans other than ``NOT_WORK`` less the union
    of its ``wire.wait`` spans; then the union over the threads."""
    out = []
    for thread in {s.thread for s in found}:
        own = [s for s in found if s.thread == thread]
        work = merged((s.start_ns, s.end_ns) for s in own if s.name not in NOT_WORK)
        waits = merged((s.start_ns, s.end_ns) for s in own if s.name == WAIT)
        out += minus(work, waits)
    return merged(out)
