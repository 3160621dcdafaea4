"""device_idle_share: the share of the traced stretch in which no kernel,
copy or fill ran on the device, in %."""

from psi_bench.trace import union_ns


def read(run):
    t = run.trace
    if t is None or not t.ops or t.stop_ns <= t.start_ns:
        return None
    busy = union_ns([(op[2], op[3]) for op in t.ops], t.start_ns, t.stop_ns)
    return 100.0 * (1 - busy / (t.stop_ns - t.start_ns))
