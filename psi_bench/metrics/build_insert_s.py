"""build_insert_s: seconds of the program's last ``build.insert`` span, the
server's nested cuckoo insert on its device (between two synchronises)."""

from psi_bench.build_spans import INSERT, last_s


def read(run):
    return last_s(INSERT)
