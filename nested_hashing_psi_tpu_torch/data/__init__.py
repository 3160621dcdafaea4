"""Deterministic PSI input-set generation (reference: src/Common/DataInput/*)."""

from nested_hashing_psi_tpu_torch.data.input import (  # noqa: F401
    DataInputHandler,
    FixedDataInput,
    RandomDataInput,
)
