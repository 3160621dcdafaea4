"""k2_roofline: K2's (csrc/pie_ip.cu) share of its roofline, in %: the
least time of its launches at the cell's shape (``trace.k2_bound_s``,
bytes at 3.35 TB/s or products at the FMA pipe's rate, whichever is
longer) over their device time in the traced stretch. Every launch on the
main path sums all P positions of one set."""

from psi_bench.trace import is_k2, k2_bound_s


def read(run):
    t = run.trace
    if t is None:
        return None
    k2 = [e - s for kind, name, s, e in t.ops if kind == "kernel" and is_k2(name)]
    if not k2 or sum(k2) <= 0:
        return None
    sh = run.shape
    bound = k2_bound_s(sh["H"], sh["D"], sh["P"], sh["L"], sh["N"])
    return 100.0 * bound * len(k2) / (sum(k2) / 1e9)
