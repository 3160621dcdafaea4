"""server_mul_relin_ms: device ms a set between the timing events of the
program's ``scheme.mul_relin`` spans (each cross-hash multiply and
relinearisation of the server's combine: BFV's rescaled HPS, flat BGV's
tensor product and key switch), over the traced stretch."""

from psi_bench.program_spans import device_ms_per_set


def read(run):
    return device_ms_per_set(run, "scheme.mul_relin")
