"""build_host_s: seconds of the program's last ``server.offline`` span (the
server's whole offline phase) less the ``build.insert`` and
``build.encode`` spans inside it: what the build leaves on the host."""

from psi_bench.build_spans import host_s


def read(run):
    return host_s()
