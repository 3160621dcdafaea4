"""The benchmark's input sets, made from the run's seed (NumPy only).

The logic of the port's ``data/input.py`` ``RandomDataInput`` (Philox
streams; items uniform in [2, 2^bits), 0 and 1 rejected; client-only items
rejected where they collide with the server's set), copied here so that a
change to the program cannot change the yardstick, and extended:

- the server's set holds ``server_size`` distinct items (a repeated draw is
  dropped and drawn again: PSI is over sets);
- a pool of client sets, set ``i`` drawn from the stream keyed by
  ``(seed, i + 1)``: ``common`` items picked from the server's set without
  repeats, the rest drawn outside it, all in a shuffled order.

Every seed gives the same sizes; only the items differ. Items are (n, 2)
uint64 rows (low word, high word), the program's item layout.
"""

from __future__ import annotations

import numpy as np

SERVER_SEED_DIFF = (1 << 32) + (1 << 16) + 1  # RandomDataInput's server stream offset
_WORD = 1 << 64


def _draw(rng: np.random.Generator, count: int, bit_size: int) -> np.ndarray:
    """(count,) uint64 items uniform in [2, 2^bit_size), bit_size <= 64."""
    if not 2 <= bit_size <= 64:
        raise ValueError(f"bit_size {bit_size} outside [2, 64]")
    out = np.zeros(0, np.uint64)
    while len(out) < count:
        draw = rng.integers(0, 2**64, size=count - len(out) + 8, dtype=np.uint64)
        if bit_size < 64:
            draw &= np.uint64((1 << bit_size) - 1)
        out = np.concatenate([out, draw[draw > 1][: count - len(out)]])
    return out


def _rows(lo: np.ndarray) -> np.ndarray:
    return np.stack([lo, np.zeros_like(lo)], axis=1)


def server_set(seed: int, size: int, bit_size: int) -> np.ndarray:
    """(size, 2) distinct items, from the server's Philox stream."""
    rng = np.random.Generator(np.random.Philox(key=(seed + SERVER_SEED_DIFF) % _WORD))
    items = np.zeros(0, np.uint64)
    while len(items) < size:
        items = np.concatenate([items, _draw(rng, size - len(items), bit_size)])
        _, first = np.unique(items, return_index=True)
        items = items[np.sort(first)]
    return _rows(items)


def client_set(seed: int, index: int, server: np.ndarray, size: int, common: int,
               bit_size: int) -> np.ndarray:
    """(size, 2) distinct items, ``common`` of them in ``server``."""
    if not 0 <= common <= size:
        raise ValueError(f"{common} common items of a {size}-item set")
    rng = np.random.Generator(np.random.Philox(key=(seed % _WORD) + (index + 1) * _WORD))
    shared = server[rng.choice(len(server), size=common, replace=False), 0]
    taken = np.sort(server[:, 0])
    only = np.zeros(0, np.uint64)
    while len(only) < size - common:
        cand = _draw(rng, size - common - len(only), bit_size)
        pos = np.minimum(np.searchsorted(taken, cand), len(taken) - 1)
        cand = cand[taken[pos] != cand]
        _, first = np.unique(np.concatenate([only, cand]), return_index=True)
        only = np.concatenate([only, cand])[np.sort(first)]
    items = np.concatenate([shared, only])
    return _rows(items[rng.permutation(size)])


def client_pool(seed: int, server: np.ndarray, pool: int, size: int, common: int,
                bit_size: int) -> list[np.ndarray]:
    return [client_set(seed, i, server, size, common, bit_size) for i in range(pool)]
