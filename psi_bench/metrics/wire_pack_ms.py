"""wire_pack_ms: host ms a set, both parties, in the program's ``wire.pack``
spans (a tensor to its wire frame and onto the channel: the download to
pageable memory, the framing, the write), over the traced stretch."""

from psi_bench.program_spans import host_ms_per_set


def read(run):
    return host_ms_per_set(run, "wire.pack")
