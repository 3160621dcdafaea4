"""Command-line entry points of the port (PyTorch + CUDA), the counterpart of
``nested_hashing_psi_tpu.cli`` with the same flags plus ``--device``:

    python -m nested_hashing_psi_tpu_torch.cli server -F --batched [--bgv] [flags]
    python -m nested_hashing_psi_tpu_torch.cli client -F --batched [--bgv] [flags]

``--device`` defaults to ``cuda`` and fails when no GPU is present; pass
``--device cpu`` to run on the CPU. BatchedFHE (``-F --batched``) and
SimpleFHE (``-F``) are ported, each under BFV or ``--bgv``; the ElGamal
protocols (no ``-F``) raise NotImplementedError.
"""

from __future__ import annotations

import sys

from nested_hashing_psi_tpu_torch.config import build_arg_parser, params_from_args
from nested_hashing_psi_tpu_torch.protocol.runner import run_client_tcp, run_server_tcp


def parse_args(argv):
    """Flags -> (PSIParams, HashTableParams, device)."""
    ap = build_arg_parser()
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device both phases compute on (default cuda)")
    args = ap.parse_args(argv)
    psi, ht = params_from_args(args)
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
