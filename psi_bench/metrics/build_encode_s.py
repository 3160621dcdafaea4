"""build_encode_s: seconds of the program's last ``build.encode`` span, the
server's packed table and masks built on its device from the nested table
(the depth shuffle, the mask fold, the packed encode, K1; between two
synchronises)."""

from psi_bench.build_spans import ENCODE, last_s


def read(run):
    return last_s(ENCODE)
