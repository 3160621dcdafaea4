"""Protocol and hash-structure parameters.

The port's own copy of ``nested_hashing_psi_tpu.config``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Mirrors the reference's parameter surface so Performance-Evaluation sweep rows
replay verbatim: PSIParameter (reference src/Common/Parameter/PSIParameter.hpp),
HashTableParameter (HashTableParameter.hpp) and the CLI defaults
(reference src/Common/Parameter/CLI.cpp:47-73).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass


@dataclass(frozen=True)
class PSIParams:
    server_set_size: int = 400
    client_set_size: int = 2
    intersection_set_size: int = 2
    hash_seed: int = 987654321
    item_seed: int = 123456789
    ip: str = "127.0.0.1"
    port: int = 8000
    verbose: bool = False
    export_performance: bool = False
    number_of_threads: int = 1
    precomp: bool = False
    fhe: bool = False
    bit_size: int = 32
    curve_name: str = "P-256"
    bgv: bool = False
    batched: bool = False
    # Framework extensions (not in the reference CLI): FHE ring dimension
    # override (16384 in the reference, smaller in tests), optional limb
    # count override for the RNS modulus (None = noise-budget heuristic),
    # and online-upload streaming: >1 splits the batched index matrix into
    # chunks so the server overlaps receive with compute (the reference's
    # SimpleFHEPSIServer.cpp:128-153 overlap, generalized).
    # num_queries > 1 ships Q independent query transactions in ONE online
    # exchange; the server answers them in one batched device dispatch
    # (BatchedFHEPIE.run_many) -- the production-serving throughput path.
    ring_dim: int = 16384
    num_limbs: int | None = None
    stream_chunks: int = 1
    num_queries: int = 1


@dataclass(frozen=True)
class HashTableParams:
    each_simple_table_size: int = 4
    each_cuckoo_table_size: int = 10
    server_stash_size: int = 0
    n_simple_hash_functions: int = 2
    n_cuckoo_hash_functions: int = 2
    simple_multi_table: bool = True   # reference: !combinedSimpleTable
    cuckoo_multi_table: bool = True   # reference: !combinedCuckooTable
    max_items_per_position: int = 10  # aka bin size / maxPP

    @property
    def batch_slots(self) -> int:
        """Client cuckoo slots carried per ciphertext in the batched protocol."""
        return self.n_simple_hash_functions * self.each_simple_table_size


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags matching the reference's boost::program_options surface."""
    ap = argparse.ArgumentParser(description="nested-hashing PSI (PyTorch + CUDA)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-p", "--perf", action="store_true", help="Export performance measures")
    ap.add_argument("-P", "--precomp", action="store_true", help="Use precomputation")
    ap.add_argument("-F", "--fhe", action="store_true", help="Use FHE")
    ap.add_argument("-t", "--nThreads", type=int, default=1)
    ap.add_argument("-s", "--combinedSimpleTable", action="store_true")
    ap.add_argument("-c", "--combinedCuckooTable", action="store_true")
    ap.add_argument("-S", "--serverSetSize", type=int, default=400)
    ap.add_argument("-C", "--clientSetSize", type=int, default=2)
    ap.add_argument("-I", "--intersectionSetSize", type=int, default=2)
    ap.add_argument("-e", "--eachSimpleTableSize", type=int, default=4)
    ap.add_argument("-E", "--eachCuckooTableSize", type=int, default=10)
    ap.add_argument("--stash", type=int, default=0)
    ap.add_argument("-k", "--nSimpleHF", type=int, default=2)
    ap.add_argument("-K", "--nCuckooHF", type=int, default=2)
    ap.add_argument("-b", "--maxPP", type=int, default=10)
    ap.add_argument("-B", "--bitSize", type=int, default=32)
    ap.add_argument("--seed", type=int, default=987654321, help="hashSeed")
    ap.add_argument("--itemSeed", type=int, default=123456789)
    ap.add_argument("--ip", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--curve", type=str, default="P-256")
    ap.add_argument("--bgv", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--ringDim", type=int, default=16384)
    ap.add_argument("--numLimbs", type=int, default=None)
    ap.add_argument(
        "--streamChunks", type=int, default=1,
        help="split the online index upload into N chunks (overlaps server "
        "receive with compute)",
    )
    ap.add_argument(
        "--queries", type=int, default=1,
        help="batched-FHE: ship N query transactions in one online exchange; "
        "the server answers them in one batched device dispatch",
    )
    return ap


def params_from_args(args: argparse.Namespace) -> tuple[PSIParams, HashTableParams]:
    psi = PSIParams(
        server_set_size=args.serverSetSize,
        client_set_size=args.clientSetSize,
        intersection_set_size=args.intersectionSetSize,
        hash_seed=args.seed,
        item_seed=args.itemSeed,
        ip=args.ip,
        port=args.port,
        verbose=args.verbose,
        export_performance=args.perf,
        number_of_threads=args.nThreads,
        precomp=args.precomp,
        fhe=args.fhe,
        bit_size=args.bitSize,
        curve_name=args.curve,
        bgv=args.bgv,
        batched=args.batched,
        ring_dim=args.ringDim,
        num_limbs=args.numLimbs,
        stream_chunks=args.streamChunks,
        num_queries=args.queries,
    )
    ht = HashTableParams(
        each_simple_table_size=args.eachSimpleTableSize,
        each_cuckoo_table_size=args.eachCuckooTableSize,
        server_stash_size=args.stash,
        n_simple_hash_functions=args.nSimpleHF,
        n_cuckoo_hash_functions=args.nCuckooHF,
        simple_multi_table=not args.combinedSimpleTable,
        cuckoo_multi_table=not args.combinedCuckooTable,
        max_items_per_position=args.maxPP,
    )
    return psi, ht
