"""End-to-end PSI through the port: the BASELINE.json north-star
configuration (a 2^24-item server set against a 2^12-item client set,
batched FHE, bit-exact intersection) by default, both parties in one
process on one device, and the server's offline artifact saved and resumed.

Counterpart of ``benchmarks/bench_e2e_psi.py`` with its flags and result
lines, plus ``--device`` (default cuda, which raises without a GPU; cpu runs
the plain versions) and ``--resultOut``. ``NHPSI_RING_DIM`` and
``NHPSI_NUM_LIMBS`` override the ring and limbs, as in the CLI.

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi \\
        [--server-log2 24] [--client-log2 12] [--checkpoint ART [--saveOnly]]
    python -m ...bench_e2e_psi --checkpoint ART --buildOnly   # offline only
    python -m ...bench_e2e_psi --resume ART [--resultOut R.npy]  # fresh process

The artifact is the v3 checkpoint (``utils.checkpoint``) and ``ART.client.npz``
beside it holds the client's query, secret key, cuckoo table and expected
intersection, with the JAX bench's keys and dtypes, so each package's
``--resume`` reads the other's files. Unlike the JAX bench, sizes are read
from the files written (``save_batched_pie`` writes exactly the path given),
``--buildOnly`` raises the server's exception rather than the client's
ConnectionError it causes, and one function writes the sidecar.
``--perf`` writes the reference's CSVs to ``eval_results_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.cli import env_overrides
from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.convert import from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, SecretKey
from nested_hashing_psi_tpu_torch.ops import ntt_cuda, pie_kernels
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEClientOps
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import result_zero_mask
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel
from nested_hashing_psi_tpu_torch.protocol.runner import (
    default_data,
    make_protocol_pair,
    run_in_process,
    run_parties,
)
from nested_hashing_psi_tpu_torch.utils.checkpoint import load_batched_pie, save_batched_pie
from nested_hashing_psi_tpu_torch.utils.device import resolve_device, synchronize

PERF_DIR = "eval_results_torch"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--server-log2", type=int, default=24)
    ap.add_argument("--client-log2", type=int, default=12)
    ap.add_argument("--bitSize", type=int, default=32)
    ap.add_argument("--bgv", action="store_true")
    ap.add_argument("--streamChunks", type=int, default=1)
    ap.add_argument("--checkpoint", default=None,
                    help="path: save the server's offline artifact (and its client sidecar) "
                    "after the run, resume a PIE from the file alone and check one online "
                    "query bit for bit")
    ap.add_argument("--simpleSize", type=int, default=0,
                    help="override eachSimpleTableSize (exact Parameters1.txt rows)")
    ap.add_argument("--inner", type=int, default=0, help="override maxPP = eachCuckooTableSize")
    ap.add_argument("--intersection", type=int, default=0)
    ap.add_argument("--perf", action="store_true",
                    help=f"export reference-schema measurement CSVs to {PERF_DIR}/")
    ap.add_argument("--buildOnly", action="store_true",
                    help="with --checkpoint: run only the Setup and Offline phases (table "
                    "build, encode, the client's query), save the artifact and sidecar and "
                    "exit; a fresh-process --resume answers and verifies the query")
    ap.add_argument("--saveOnly", action="store_true",
                    help="with --checkpoint: write the artifact and sidecar and skip the "
                    "same-process resume")
    ap.add_argument("--resume", default=None,
                    help="fresh-process resume: load the PIE from this checkpoint and its "
                    ".client.npz sidecar, answer the query and verify the intersection")
    ap.add_argument("--resultOut", default=None,
                    help="with --resume: write the result ciphertext (uint32 .npy) here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both parties (default cuda)")
    return ap.parse_args(argv)


def geometry(server_n: int, client_n: int, simple_size: int = 0,
             inner: int = 0) -> tuple[int, int]:
    """(eachSimpleTableSize, inner size): the client's 2 simple tables at
    slack 2.2, the server's inner tables square with ~1.2 slack over the
    placements per outer cell (the JAX bench's derivation)."""
    simple_size = simple_size or int(client_n * 2.2 / 2)
    if not inner:
        per_cell = 2 * server_n / (2 * simple_size)  # placements per cell
        inner = 1
        while 2 * inner * inner < per_cell * 1.2:
            inner += 1
    return simple_size, inner


def make_params(args) -> tuple[PSIParams, HashTableParams]:
    server_n, client_n = 1 << args.server_log2, 1 << args.client_log2
    simple_size, inner = geometry(server_n, client_n, args.simpleSize, args.inner)
    psi = env_overrides(PSIParams(
        server_set_size=server_n,
        client_set_size=client_n,
        intersection_set_size=args.intersection or client_n // 2,
        bit_size=args.bitSize,
        fhe=True,
        batched=True,
        bgv=args.bgv,
        stream_chunks=args.streamChunks,
        verbose=True,
        export_performance=args.perf,
    ))
    ht = HashTableParams(
        each_simple_table_size=simple_size,
        each_cuckoo_table_size=inner,
        n_simple_hash_functions=2,
        n_cuckoo_hash_functions=2,
        max_items_per_position=inner,
    )
    return psi, ht


def sidecar_path(checkpoint: str) -> str:
    return checkpoint + ".client.npz"


def write_sidecar(path: str, client) -> None:
    """The client's side of a fresh-process resume, written to exactly
    ``path``: the query ciphertexts, the secret key (residues uint32), the
    client's cuckoo table and the expected intersection."""
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            idx=to_numpy(client.idx_ct.data),
            minus=to_numpy(client.minus_ct.data),
            s_mont=to_numpy(client.sk.s_mont),
            s_ntt=to_numpy(client.sk.s_ntt),
            client_table=np.asarray(client.client_table.table),
            expected=np.asarray(client.data.get_intersection_set()),
        )


def save_artifact(checkpoint: str, server, client) -> tuple[float, int, int]:
    """Save the server's PIE and the client sidecar -> (seconds, artifact
    bytes, sidecar bytes), the sizes of the files written."""
    t0 = time.perf_counter()
    save_batched_pie(checkpoint, server.pie)
    write_sidecar(sidecar_path(checkpoint), client)
    return (time.perf_counter() - t0, os.path.getsize(checkpoint),
            os.path.getsize(sidecar_path(checkpoint)))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.resume:
        return resume_main(args, device)
    psi, ht = make_params(args)
    print(f"server 2^{args.server_log2}, client 2^{args.client_log2}, "
          f"simpleSize={ht.each_simple_table_size} (batch {ht.batch_slots}), "
          f"inner {ht.each_cuckoo_table_size}x{ht.each_cuckoo_table_size}, device {device}",
          flush=True)
    if args.buildOnly:
        return build_only_main(args, psi, ht, device)

    if args.perf:
        os.makedirs(PERF_DIR, exist_ok=True)
    t0 = time.perf_counter()
    client, server, ok = run_in_process(psi, ht, export_dir=PERF_DIR, device=device)
    total = time.perf_counter() - t0
    m = client.measurements
    print(f"RESULT: {'Set matches!' if ok else 'MISMATCH'}")
    print(f"total {total:.1f}s | setup {m['Setup'].duration_us/1e6:.1f}s | "
          f"offline {m['Offline'].duration_us/1e6:.1f}s | "
          f"online {m['Online'].duration_us/1e6:.1f}s")
    print(f"server offline compute {server.offline_computation_us/1e6:.1f}s | "
          f"server ONLINE compute {server.online_computation_us/1e3:.1f}ms")
    if client.noise_bits is not None:
        print(f"client noise margin: {client.noise_bits:.0f} bits used of "
              f"{client.ctx.params.q.bit_length()}")
    print(f"online wire: {m['Online'].bytes_out / 1e6:.1f} MB up, "
          f"{m['Online'].bytes_in / 1e6:.1f} MB down")
    if not ok:
        return 1
    if not args.checkpoint:
        return 0

    save_s, size, side = save_artifact(args.checkpoint, server, client)
    if args.saveOnly:
        print(f"checkpoint: save {save_s:.1f}s ({size} bytes, sidecar {side} bytes), "
              f"same-process re-verify skipped (--saveOnly; run --resume in a fresh process)")
        return 0
    t0 = time.perf_counter()
    resumed = load_batched_pie(args.checkpoint, device=device)  # the file alone
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1 = server.pie.run(client.idx_ct, client.minus_ct).data
    r2 = resumed.run(client.idx_ct, client.minus_ct).data
    match = torch.equal(r1, r2)
    q_s = time.perf_counter() - t0
    print(f"checkpoint: save {save_s:.1f}s ({size} bytes), self-contained load "
          f"{load_s:.1f}s, resumed online query {'bit-exact' if match else 'MISMATCH'} "
          f"({q_s:.1f}s for both runs)")
    return 0 if match else 1


def build_only_main(args, psi: PSIParams, ht: HashTableParams, device: torch.device) -> int:
    """Setup and Offline only: build the server's artifact and the client's
    query, save the checkpoint and sidecar, exit. The online query runs
    once, in the fresh-process --resume."""
    if not args.checkpoint:
        raise SystemExit("--buildOnly requires --checkpoint")
    client_cls, server_cls = make_protocol_pair("BatchedFHE")
    ch_client, ch_server = LoopbackChannel.pair()
    client = client_cls(default_data(psi), psi, ht, ch_client, device=device)
    server = server_cls(default_data(psi), psi, ht, ch_server, device=device)

    def server_phases():
        server.run_setup_phase()
        server._signal_phase_over()
        server.run_offline_phase()
        server._signal_phase_over()

    def client_phases():
        t0 = time.perf_counter()
        client.run_setup_phase()
        client._read_phase_over()
        print(f"setup done {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        client.run_offline_phase()
        client._read_phase_over()
        print(f"offline done {time.perf_counter() - t0:.1f}s (server offline compute "
              f"{server.offline_computation_us / 1e6:.3f}s)", flush=True)

    run_parties(client_phases, server_phases, ch_server)
    save_s, size, side = save_artifact(args.checkpoint, server, client)
    pie = server.pie
    print(f"checkpoint saved {save_s:.3f}s ({size} bytes = {size / 1e9:.3f} GB v3, table "
          f"{tuple(pie.table_pt.shape)} L={pie.ctx.L} host_table={pie.host_table}; client "
          f"sidecar {side} bytes) -- verify with --resume in a fresh process", flush=True)
    return 0


def resume_main(args, device: torch.device) -> int:
    """Fresh-process resume: nothing from the build process but the
    checkpoint and its sidecar."""
    t0 = time.perf_counter()
    pie = load_batched_pie(args.resume, device=device)
    synchronize(device)
    load_s = time.perf_counter() - t0
    with np.load(sidecar_path(args.resume)) as z:
        idx = Ciphertext(from_numpy(z["idx"], device), pie.ctx.default_form)
        minus = Ciphertext(from_numpy(z["minus"], device), pie.ctx.default_form)
        sk = SecretKey(from_numpy(z["s_mont"], device), from_numpy(z["s_ntt"], device))
        client_table, expected = z["client_table"], z["expected"]
    ntt_cuda.reset_launches()
    pie_kernels.reset_launches()
    t0 = time.perf_counter()
    out = pie.run(idx, minus)
    synchronize(device)
    q_s = time.perf_counter() - t0
    launched = {"ntt_fwd": ntt_cuda.launches["ntt"], "ntt_inv": ntt_cuda.launches["intt"],
                "pie_ip": pie_kernels.launches}
    t0 = time.perf_counter()
    mask, noise = result_zero_mask(pie.ctx, out, sk, pie.batch_slots, {})
    dec_s = time.perf_counter() - t0
    ops = BatchedFHEClientOps(pie.ctx, types.SimpleNamespace(table=client_table), 0, pie.H, pie.P)
    got = {tuple(r) for r in ops.extract_intersection_mask(mask).tolist()}
    ok = got == {tuple(r) for r in expected.tolist()}
    if args.resultOut:
        with open(args.resultOut, "wb") as f:
            np.save(f, to_numpy(out.data))
    noise_s = "n/a (device decrypt)" if noise is None else f"{noise:.0f} bits"
    print(f"RESUME RESULT: {'Set matches!' if ok else 'MISMATCH'} (load {load_s:.3f}s, online "
          f"query {q_s:.3f}s, decrypt {dec_s:.3f}s, noise {noise_s}, |intersection| {len(got)})")
    print(f"resume: device {device}, table {tuple(pie.table_pt.shape)} L={pie.ctx.L} "
          f"host_table={pie.host_table} mul_limbs={pie.mul_limbs} "
          f"ship_limbs={pie.ship_limbs}, result {tuple(out.data.shape)}; kernel launches "
          f"{json.dumps(launched)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
