"""idle_unattributed_share: of the traced stretch's device-idle time (the
gaps between the device operations of the trace), the share in % during
which no thread of the program was inside a span that names its work
(any span but ``wire.wait``, ``client.exchange`` and ``server.exchange``,
less the ``wire.wait`` spans inside it)."""

from psi_bench.program_spans import overlap_ns, spans, working
from psi_bench.trace import gaps_ns


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    found = spans(run)
    if found is None:
        return None
    gaps = gaps_ns([(op[2], op[3]) for op in t.ops], t.start_ns, t.stop_ns)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    return 100.0 * (idle - overlap_ns(working(found), gaps)) / idle
