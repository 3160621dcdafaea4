"""server_glue_ms: device time of the kernels in the server's steps that
are neither K1 (csrc/ntt.cu) nor K2 (csrc/pie_ip.cu): the scheme's
plain-PyTorch int64 glue, in ms a set of the traced stretch."""

from psi_bench.trace import in_spans, is_k1, is_k2


def read(run):
    t = run.trace
    if t is None or not t.sets:
        return None
    ops = [op for op in in_spans(t.ops, t.spans, "server_step")
           if op[0] == "kernel" and not is_k1(op[1]) and not is_k2(op[1])]
    return sum(e - s for _, _, s, e in ops) / 1e6 / t.sets if ops else None
