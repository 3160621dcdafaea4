"""Command-line entry points of the port (PyTorch + CUDA), the counterpart of
``nested_hashing_psi_tpu.cli`` with the same flags plus ``--device``:

    python -m nested_hashing_psi_tpu_torch server -F --batched [--bgv] [flags]
    python -m nested_hashing_psi_tpu_torch client -F --batched [--bgv] [flags]

(``python -m nested_hashing_psi_tpu_torch.cli`` is the same entry point.)

``--device`` defaults to ``cuda`` and fails when no GPU is present; pass
``--device cpu`` to run on the CPU. BatchedFHE (``-F --batched``) and
SimpleFHE (``-F``) are ported, each under BFV or ``--bgv``; the ElGamal
protocols (no ``-F``) raise NotImplementedError. As in the JAX package,
``NHPSI_RING_DIM`` and ``NHPSI_NUM_LIMBS`` in the environment override the
ring dimension and the limb count after the flags are parsed.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from nested_hashing_psi_tpu_torch.config import build_arg_parser, params_from_args
from nested_hashing_psi_tpu_torch.protocol.runner import run_client_tcp, run_server_tcp


def parse_args(argv):
    """Flags (and the NHPSI_RING_DIM / NHPSI_NUM_LIMBS overrides) ->
    (PSIParams, HashTableParams, device)."""
    ap = build_arg_parser()
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device both phases compute on (default cuda)")
    args = ap.parse_args(argv)
    psi, ht = params_from_args(args)
    if os.environ.get("NHPSI_RING_DIM"):
        psi = dataclasses.replace(psi, ring_dim=int(os.environ["NHPSI_RING_DIM"]))
    if os.environ.get("NHPSI_NUM_LIMBS"):
        psi = dataclasses.replace(psi, num_limbs=int(os.environ["NHPSI_NUM_LIMBS"]))
    return psi, ht, args.device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("server", "client"):
        print("usage: cli.py {server|client} [flags]", file=sys.stderr)
        return 2
    role = argv.pop(0)
    psi, ht, device = parse_args(argv)
    if role == "server":
        run_server_tcp(psi, ht, device=device)
        return 0
    _, ok = run_client_tcp(psi, ht, device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
