"""The plain reference: each client set's intersection with the server's
set, worked out again from the generated sets alone (NumPy only; imports
nothing of the program).

``judge`` compares what the program served with it, set by set: a served
item that is not in the intersection, or an item of the intersection that
was not served, is one wrong item.
"""

from __future__ import annotations

import numpy as np


def _keys(items: np.ndarray) -> np.ndarray:
    """(n, 2) uint64 rows -> (n,) byte strings that sort and compare as rows."""
    return np.ascontiguousarray(items, dtype=np.uint64).view(np.dtype((np.void, 16))).ravel()


def intersection(server: np.ndarray, client: np.ndarray) -> np.ndarray:
    """The client's items that the server holds, as (k, 2) rows."""
    return client[np.isin(_keys(client), _keys(server))]


def wrong_items(served: np.ndarray, expected: np.ndarray) -> int:
    """Size of the symmetric difference of two item sets; a row served twice
    counts once more."""
    got, want = _keys(served), _keys(expected)
    repeats = len(got) - len(np.unique(got))
    return int(len(np.setxor1d(got, want)) + repeats)


def judge(server: np.ndarray, pool: list[np.ndarray],
          answers: list[tuple[int, np.ndarray]]) -> list[int]:
    """Wrong items of each answer (pool index, served items), in order."""
    expected = {}
    out = []
    for i, served in answers:
        if i not in expected:
            expected[i] = intersection(server, pool[i])
        out.append(wrong_items(served, expected[i]))
    return out
