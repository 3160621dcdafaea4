"""server_kernels_per_set: the number of the server step's kernels that
are neither K1 nor K2 (the launches of the plain-PyTorch glue), a set of
the traced stretch."""

from psi_bench.trace import in_spans, is_k1, is_k2


def read(run):
    t = run.trace
    if t is None or not t.sets:
        return None
    n = sum(1 for op in in_spans(t.ops, t.spans, "server_step")
            if op[0] == "kernel" and not is_k1(op[1]) and not is_k2(op[1]))
    return n / t.sets if n else None
