"""Summarize the reference-schema measurement CSVs into per-configuration lines.

Counterpart of ``benchmarks/summarize_eval.py``, with the same output:

    python -m nested_hashing_psi_tpu_torch.benchmarks.summarize_eval [DIR]

DIR is any directory (default ``eval_results_torch/`` at the repository's
root); nothing is written.

Reads the reference-schema measurement files
(MClient_CS_{c}_SS_{s}_P_{proto}_T_{t}_{date}.csv with
{Setup,Offline,Online}{Time,BytesIn,BytesOut} rows per run, and the matching
MServer files with Offline/OnlineComputationTime) and prints one line per
(protocol, serverSetSize, clientSetSize): run count, median phase seconds,
median server compute, wire bytes.
"""

from __future__ import annotations

import glob
import os
import re
import statistics
import sys
from collections import defaultdict

from nested_hashing_psi_tpu_torch.benchmarks.timing import EVAL_DIR


def parse(path):
    runs = []
    cur = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        k, v = line.strip().split(",")
        if k in cur:  # file appends one block per run
            runs.append(cur)
            cur = {}
        cur[k] = int(v)
    if cur:
        runs.append(cur)
    return runs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else EVAL_DIR
    rows = defaultdict(lambda: {"client": [], "server": []})
    for path in glob.glob(os.path.join(directory, "M*.csv")):
        mm = re.match(
            r"M(Client|Server)_CS_(\d+)_SS_(\d+)_P_(.+)_T_(\d+)_([\d-]+)\.csv",
            os.path.basename(path),
        )
        if not mm:
            continue
        side, cs, ss, proto, thr, date = mm.groups()
        # the reference names the two sides differently for the ElGamal
        # protocols (MClient Simple{curve} vs MServer SimpleElGamal-{curve})
        proto = proto.replace("ElGamal-", "")
        key = (proto, int(ss), int(cs), int(thr))
        rows[key][side.lower()].append(path)

    def med(vals):
        return statistics.median(vals) if vals else float("nan")

    print(f"{'protocol':<22} {'server':>10} {'client':>7} {'T':>2} {'runs':>4} "
          f"{'setup_s':>8} {'offl_s':>8} {'onl_s':>8} {'srv_offl':>9} "
          f"{'srv_onl':>8} {'up_MB':>7} {'down_MB':>8}")
    for key in sorted(rows):
        proto, ss, cs, thr = key
        cl = sum((parse(p) for p in rows[key]["client"]), [])
        sv = sum((parse(p) for p in rows[key]["server"]), [])
        if not cl:
            continue
        setup = med([r["SetupTime"] / 1e6 for r in cl if "SetupTime" in r])
        offl = med([r["OfflineTime"] / 1e6 for r in cl if "OfflineTime" in r])
        onl = med([r["OnlineTime"] / 1e6 for r in cl if "OnlineTime" in r])
        so = med([r["OfflineComputationTime"] / 1e6 for r in sv
                  if "OfflineComputationTime" in r])
        sn = med([r["OnlineComputationTime"] / 1e6 for r in sv
                  if "OnlineComputationTime" in r])
        up = med([r.get("OnlineBytesOut", 0) / 1e6 for r in cl])
        dn = med([r.get("OnlineBytesIn", 0) / 1e6 for r in cl])
        print(f"{proto:<22} {ss:>10} {cs:>7} {thr:>2} {len(cl):>4} "
              f"{setup:>8.1f} {offl:>8.1f} {onl:>8.1f} {so:>9.1f} "
              f"{sn:>8.1f} {up:>7.1f} {dn:>8.1f}")


if __name__ == "__main__":
    main()
