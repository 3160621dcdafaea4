"""Hashing layer: vectorized tabulation hashing, blocked/batched cuckoo tables
and the nested (hierarchical) structure as dense arrays."""

from nested_hashing_psi_tpu_torch.hashing.tabulation import TabulationHashing  # noqa: F401
from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooHashTable, CuckooFailure  # noqa: F401
from nested_hashing_psi_tpu_torch.hashing.hierarchical import HierarchicalCuckooHashTable  # noqa: F401
