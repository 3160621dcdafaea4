"""k1_ms: device time of K1 (csrc/ntt.cu, every forward and inverse NTT
kernel, the server's and the client's), in ms a set of the traced
stretch."""

from psi_bench.trace import is_k1


def read(run):
    t = run.trace
    if t is None or not t.sets:
        return None
    ns = sum(e - s for kind, name, s, e in t.ops if kind == "kernel" and is_k1(name))
    return ns / 1e6 / t.sets if ns else None
