"""client_extract_ms: host ms a set in the program's ``client.extract``
spans (the client's items picked out by the zero mask), over the traced
stretch."""

from psi_bench.program_spans import host_ms_per_set


def read(run):
    return host_ms_per_set(run, "client.extract")
