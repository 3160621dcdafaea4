"""The program's spans of the server's offline build, read through its
tracer as ``program_spans.py`` reads the online ones.

The build runs once, in set-up, outside any traced stretch, and the program
records its spans whether or not torch.profiler runs: ``server.offline``
(the server's whole ``run_offline_phase``) holding ``build.insert`` (the
nested cuckoo insert on the device) and ``build.encode`` (the packed table
and masks), each timed on the host clock between two synchronises. A
program without them gives no such span, and every reader then returns
None.
"""

from __future__ import annotations

OFFLINE, INSERT, ENCODE = "server.offline", "build.insert", "build.encode"


def _spans(name: str) -> list:
    from nested_hashing_psi_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)
    if tracer is None or not hasattr(tracer, "between"):
        return []
    return [s for s in tracer.between(0, 2**63 - 1) if s.name == name]


def last_s(name: str):
    """Seconds of the last span called ``name``, or None."""
    found = _spans(name)
    return (found[-1].end_ns - found[-1].start_ns) / 1e9 if found else None


def host_s():
    """Seconds of the last ``server.offline`` span less the insert and
    encode spans inside it, or None where it holds neither."""
    found = _spans(OFFLINE)
    if not found:
        return None
    o = found[-1]
    inner = [s for name in (INSERT, ENCODE) for s in _spans(name)
             if o.start_ns <= s.start_ns and s.end_ns <= o.end_ns]
    if not inner:
        return None
    return (o.end_ns - o.start_ns - sum(s.end_ns - s.start_ns for s in inner)) / 1e9
