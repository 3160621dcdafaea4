#!/usr/bin/env python3
"""The 2^16 x 32 ElGamal row through the port's CLI, as two processes over
localhost TCP.

    python3 elgamal_row.py [--out build/elgamal_row]

Runs ``python -m nested_hashing_psi_tpu_torch server`` and ``... client``
for SimpleElGamal and then PrecompElGamal (``-P``) with ``-p`` (the
reference's CSV export, written under ``--out``) at the reference sweep's
2HF equal-block geometry: ``-B 128 -S 65536 -C 32 -I 16 -e 502 -E 12 -b 12
-k 2 -K 2 --nThreads 2 --curve P-256 --device cuda`` (``-e`` is the 2^20
row's 8022 scaled to the 2^16 server set). Both parties must run the native
EC library and the client must print "Set matches!". Prints the client
process's wall time, the client's Setup/Offline/Online time and bytes, the
server's offline and online compute time (its CSV), the host CPU's model
and the card's name and power limit. The ElGamal parties compute on the
host in both packages: every time here is a host time.
"""

from __future__ import annotations

import argparse
import csv
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import host_cpu  # noqa: E402
from nested_hashing_psi_tpu_torch.benchmarks.card import card_line  # noqa: E402
ROW = ["-B", "128", "-S", "65536", "-C", "32", "-I", "16", "-e", "502", "-E", "12", "-b",
       "12", "-k", "2", "-K", "2", "--nThreads", "2", "--curve", "P-256", "--device", "cuda",
       "-p"]
NATIVE = "EC group law: native (P-256)"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read_csv(path: str) -> dict[str, int]:
    with open(path) as f:
        return {row[0]: int(row[1]) for row in csv.reader(f) if row}


def run_row(protocol: str, out: str) -> dict:
    flags = ROW + ["--port", str(free_port())] + (["-P"] if protocol == "precomp" else [])
    d = os.path.join(out, protocol)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "nested_hashing_psi_tpu_torch"]
    t0 = time.perf_counter()
    server = subprocess.Popen(cmd + ["server"] + flags, cwd=d, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = subprocess.run(cmd + ["client"] + flags, cwd=d, env=env, capture_output=True,
                                text=True, timeout=1800)
        client_s = time.perf_counter() - t0
        server_out = server.communicate(timeout=300)[0]
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    if (client.returncode != 0 or "Set matches!" not in client.stdout
            or server.returncode != 0 or NATIVE not in client.stdout or NATIVE not in server_out):
        raise SystemExit(f"elgamal_row: {protocol} did not verify on the native EC library "
                         f"(client rc {client.returncode}, server rc {server.returncode}):\n"
                         f"{client.stdout[-2000:]}{client.stderr[-2000:]}{server_out[-2000:]}")
    files = sorted(os.listdir(d))
    c = read_csv(os.path.join(d, next(f for f in files if f.startswith("MClient"))))
    s = read_csv(os.path.join(d, next(f for f in files if f.startswith("MServer"))))
    return {"protocol": protocol, "flags": " ".join(flags), "client_wall_s": client_s,
            "client_csv": c, "server_csv": s}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "elgamal_row"))
    a = ap.parse_args(argv)
    print(f"[elgamal_row] host CPU: {host_cpu()} | card: {card_line()} | host timings: the "
          "ElGamal parties compute on the host", flush=True)
    rows = []
    for protocol in ("simple", "precomp"):
        r = run_row(protocol, a.out)
        c, s = r["client_csv"], r["server_csv"]
        print(f"[elgamal_row] {protocol}: {r['flags']} | Set matches! | client process "
              f"wall {r['client_wall_s']:.3f} s | {NATIVE} (both parties) | client setup "
              f"{c['SetupTime'] / 1e6:.3f} s, offline {c['OfflineTime'] / 1e6:.3f} s, online "
              f"{c['OnlineTime'] / 1e6:.3f} s; bytes out setup {c['SetupBytesOut']}, offline "
              f"{c['OfflineBytesOut']}, online {c['OnlineBytesOut']}, online in "
              f"{c['OnlineBytesIn']} | server offline compute "
              f"{s['OfflineComputationTime'] / 1e6:.3f} s, online compute (sum over its "
              f"jobs) {s['OnlineComputationTime'] / 1e6:.3f} s", flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
