"""client_decrypt_ms: the client's decrypt of the result to its zero mask
(the port's ``result_zero_mask``: on the device for BFV, on the host for
BGV), host clock between two synchronises, in ms a set of the traced
stretch."""


def read(run):
    t = run.trace
    if t is None or not t.sets:
        return None
    ns = sum(e - s for name, s, e in t.spans if name == "client_decrypt")
    return ns / 1e6 / t.sets if ns else None
