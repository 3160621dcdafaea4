"""Sweep runner: replays parameter rows through the port's in-process runner.

Counterpart of ``benchmarks/run_eval.py`` (the reference's runEval1.py,
which launches ServerMain + ClientMain pairs per row): each row runs both
parties in this process over a loopback channel
(``protocol.runner.run_in_process``) on ``--device``, and the reference's
CSV measurements land in ``--outdir`` under the reference's file names.

    python -m nested_hashing_psi_tpu_torch.benchmarks.run_eval --params ROWS.tsv \\
        --rows 0:6 --bitSize 16 --runs 3 --protocol batched [--device cuda]

``--params`` is a tab-separated file with a header row naming at least
serverSetSize, clientSetSize, intersectionSetSize, eachSimpleTableSize,
eachCuckooTableSize, nSimpleHF and maxPP (the reference's
Performance-Evaluation/Parameters1.txt has this form; it is not part of
this repository, so there is no default). ``--outdir`` defaults to
``eval_results_torch/`` at the repository's root. ``NHPSI_RING_DIM`` and
``NHPSI_NUM_LIMBS`` override the ring and limbs, as in the CLI.
"""

from __future__ import annotations

import argparse
import csv
import os

from nested_hashing_psi_tpu_torch.benchmarks.timing import EVAL_DIR
from nested_hashing_psi_tpu_torch.cli import env_overrides
from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", required=True, help="tab-separated parameter rows")
    ap.add_argument("--rows", default="0:6", help="row slice start:stop")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--bitSize", type=int, default=16)
    ap.add_argument(
        "--protocol",
        choices=["batched", "simple", "elgamal", "precomp"],
        default="batched",
        help="batched/simple FHE or simple/precomp ElGamal "
        "(the reference's -F/--batched/--precomp dispatch)",
    )
    ap.add_argument("--bgv", action="store_true")
    ap.add_argument("--curve", default="P-256")
    ap.add_argument("--outdir", default=EVAL_DIR)
    ap.add_argument("--nThreads", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """-> [(row, ok)] for every run."""
    args = parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    start, stop = (int(v) for v in args.rows.split(":"))
    with open(args.params) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))[start:stop]

    done = []
    for row in rows:
        psi = env_overrides(PSIParams(
            server_set_size=int(row["serverSetSize"]),
            client_set_size=int(row["clientSetSize"]),
            intersection_set_size=int(row["intersectionSetSize"]),
            bit_size=args.bitSize,
            fhe=args.protocol in ("batched", "simple"),
            batched=args.protocol == "batched",
            precomp=args.protocol == "precomp",
            bgv=args.bgv,
            curve_name=args.curve,
            number_of_threads=args.nThreads,
            export_performance=True,
        ))
        ht = HashTableParams(
            each_simple_table_size=int(row["eachSimpleTableSize"]),
            each_cuckoo_table_size=int(row["eachCuckooTableSize"]),
            n_simple_hash_functions=int(row["nSimpleHF"]),
            n_cuckoo_hash_functions=2,
            max_items_per_position=int(row["maxPP"]),
        )
        if args.protocol == "batched" and ht.batch_slots > psi.ring_dim:
            print(f"skip row (batch {ht.batch_slots} > ring {psi.ring_dim}): {row}")
            continue
        print(f"run {dict(row)} x{args.runs} on {args.device}", flush=True)
        for _ in range(args.runs):
            client, server, ok = run_in_process(psi, ht, export_dir=args.outdir,
                                                device=args.device)
            m = client.measurements
            print(
                f"  [{'OK' if ok else 'MISMATCH'}] setup {m['Setup'].duration_us/1e6:.2f}s  "
                f"offline {m['Offline'].duration_us/1e6:.2f}s  "
                f"online {m['Online'].duration_us/1e6:.2f}s  "
                f"(server online compute {server.online_computation_us/1e3:.1f}ms)",
                flush=True,
            )
            done.append((dict(row), ok))
    return done


if __name__ == "__main__":
    main()
