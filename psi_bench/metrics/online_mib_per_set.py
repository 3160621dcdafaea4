"""online_mib_per_set: bytes that crossed the channel in the window, both
directions, each frame with the 8-byte length prefix a TCP channel adds,
counted by the harness at the client's end (``exchange.Session``), in MiB
a set."""


def read(run):
    return run.wire_bytes / run.sets_done / 2**20 if run.sets_done else None
