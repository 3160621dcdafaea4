"""server_step_ms: the server's own ``online_computation_us`` (the PIE's
step, from the index ciphertexts on the device to the result, ending in
a synchronise) summed over the traced stretch, in ms a set."""


def read(run):
    t = run.trace
    if t is None or not t.server_us or not t.sets:
        return None
    return sum(us for _, us in t.server_us) / 1e3 / t.sets
