"""wire_unpack_ms: host ms a set, both parties, in the program's
``wire.unpack`` spans (a frame off the channel, unframed and uploaded),
less the ``wire.wait`` spans inside them (the read blocked on the peer),
over the traced stretch."""

from psi_bench.program_spans import host_ms_per_set


def read(run):
    return host_ms_per_set(run, "wire.unpack", minus_waits=True)
