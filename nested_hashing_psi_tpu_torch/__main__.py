"""``python -m nested_hashing_psi_tpu_torch {server|client} [flags]``: the
port's command line (``cli.main``)."""

import sys

from nested_hashing_psi_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
