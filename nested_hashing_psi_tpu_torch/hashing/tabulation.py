"""Vectorized seeded tabulation hashing.

The port's own copy of ``nested_hashing_psi_tpu.hashing.tabulation``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Capability parity with the reference's TabulationHashing
(reference src/Common/Hashing/TabulationHashing.cpp:16-54): one object
provides `n_hash_functions` independent 64-bit hash functions over <=128-bit
items, via t=16 lookup tables of 2^r (r=8) random uint64 entries each.

Array-first redesign: the reference hashes one biginteger at a time in a scalar
loop; here whole item sets are hashed in one shot as numpy gathers over a
(nHf, 16, 256) table -- the same op is expressible as a tensor gather for
on-device hashing when table building moves to the device.

Items are represented throughout the framework as (n, 2) uint64 arrays
[lo, hi] (little-endian 64-bit words of the <=128-bit value).
"""

from __future__ import annotations

import numpy as np


def items_from_ints(values, dtype=np.uint64) -> np.ndarray:
    """List of python ints (< 2**128) -> (n, 2) uint64 [lo, hi]."""
    out = np.zeros((len(values), 2), dtype=np.uint64)
    for i, v in enumerate(values):
        v = int(v)
        out[i, 0] = v & 0xFFFFFFFFFFFFFFFF
        out[i, 1] = v >> 64
    return out


def items_to_ints(items: np.ndarray) -> list[int]:
    return [int(lo) | (int(hi) << 64) for lo, hi in items.astype(object)]


class TabulationHashing:
    T_PARAM = 16  # byte chunks
    R_PARAM = 8   # bits per chunk

    def __init__(self, seed: int = 342797434736, n_hash_functions: int = 3):
        self.n_hash_functions = n_hash_functions
        # Philox: counter-based, stable across numpy versions/platforms, so
        # client and server derive identical tables from the shared hash seed.
        rng = np.random.Generator(np.random.Philox(key=seed))
        self.table = rng.integers(
            0, 2**64, size=(n_hash_functions, self.T_PARAM, 256), dtype=np.uint64
        )

    def _bytes(self, items: np.ndarray) -> np.ndarray:
        """(n, 2) uint64 -> (n, 16) uint8 chunk indices (little-endian).

        Zero-copy reinterpretation of the item words on little-endian hosts
        (x86/ARM); the shift-and-mask fallback was 80% of the 2^22 offline
        build (benchmarks/profile_build.py, round 4)."""
        items = np.atleast_2d(items)
        if items.dtype == np.uint64 and items.dtype.byteorder in ("=", "<"):
            import sys

            if sys.byteorder == "little":
                return np.ascontiguousarray(items).view(np.uint8).reshape(
                    len(items), 16
                )
        lo, hi = items[:, 0], items[:, 1]
        cols = [
            ((lo >> np.uint64(8 * i)) & np.uint64(0xFF)) for i in range(8)
        ] + [((hi >> np.uint64(8 * i)) & np.uint64(0xFF)) for i in range(8)]
        return np.stack(cols, axis=1).astype(np.int64)

    def hash(self, items: np.ndarray, hf_ind: int) -> np.ndarray:
        """Vectorized: (n, 2) items -> (n,) uint64 hashes for hash fn hf_ind."""
        chunks = self._bytes(items)  # (n, 16)
        vals = self.table[hf_ind, np.arange(self.T_PARAM)[None, :], chunks]
        return np.bitwise_xor.reduce(vals, axis=1)

    def hash_all(self, items: np.ndarray) -> np.ndarray:
        """(n, 2) items -> (nHf, n) uint64 hashes for every hash function."""
        chunks = self._bytes(items)  # (n, 16)
        # fancy-index broadcasting: result (nHf, n, 16)
        vals = self.table[
            np.arange(self.n_hash_functions)[:, None, None],
            np.arange(self.T_PARAM)[None, None, :],
            chunks[None, :, :],
        ]
        return np.bitwise_xor.reduce(vals, axis=2)

    def hash_index(self, items: np.ndarray, hf_ind: int, table_size: int) -> np.ndarray:
        """Hash -> bin index mod table_size (reference HashUtils.cpp:34-37)."""
        return (self.hash(items, hf_ind) % np.uint64(table_size)).astype(np.int64)
