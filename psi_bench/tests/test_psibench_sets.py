"""The generator and the reference (NumPy only, no program)."""

import subprocess
import sys

import numpy as np
import pytest

from psi_bench import reference, sets
from psi_bench.tests.tiny import REPO

SEEDS = [0, 7, 2**31 + 5, 2**33 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_sets_are_distinct_and_share_exactly(seed):
    server = sets.server_set(seed, 4096, 32)
    assert server.shape == (4096, 2) and server.dtype == np.uint64
    assert len(np.unique(server[:, 0])) == 4096 and (server[:, 1] == 0).all()
    assert (server[:, 0] > 1).all() and (server[:, 0] < 2**32).all()
    pool = sets.client_pool(seed, server, 5, 64, 32, 32)
    for client in pool:
        assert client.shape == (64, 2) and len(np.unique(client[:, 0])) == 64
        assert len(reference.intersection(server, client)) == 32
    assert len({c.tobytes() for c in pool}) == 5


def test_same_seed_same_sets_other_seed_other_sets():
    a = sets.server_set(2**32 + 9, 1024, 32)
    b = sets.server_set(2**32 + 9, 1024, 32)
    c = sets.server_set(2**32 + 10, 1024, 32)
    assert (a == b).all() and not (a == c).all()
    pa = sets.client_pool(2**32 + 9, a, 2, 16, 8, 32)
    pb = sets.client_pool(2**32 + 9, a, 2, 16, 8, 32)
    assert all((x == y).all() for x, y in zip(pa, pb))


@pytest.mark.parametrize("bits", [16, 20])
def test_small_item_widths_still_give_distinct_sets(bits):
    server = sets.server_set(3, 2000, bits)
    client = sets.client_set(3, 0, server, 100, 40, bits)
    assert len(np.unique(server[:, 0])) == 2000
    assert len(reference.intersection(server, client)) == 40


def test_reference_intersection_matches_a_python_set():
    server = sets.server_set(11, 3000, 32)
    client = sets.client_set(11, 2, server, 200, 77, 32)
    want = {tuple(r) for r in client.tolist()} & {tuple(r) for r in server.tolist()}
    got = {tuple(r) for r in reference.intersection(server, client).tolist()}
    assert got == want and len(got) == 77


def test_wrong_items_counts_misses_extras_and_repeats():
    server = sets.server_set(5, 500, 32)
    client = sets.client_set(5, 0, server, 40, 20, 32)
    want = reference.intersection(server, client)
    assert reference.wrong_items(want, want) == 0
    assert reference.wrong_items(want[1:], want) == 1
    extra = np.concatenate([want, client[~np.isin(client[:, 0], want[:, 0])][:2]])
    assert reference.wrong_items(extra, want) == 2
    assert reference.wrong_items(np.concatenate([want, want[:1]]), want) == 1
    assert reference.judge(server, [client], [(0, want), (0, want[:-3])]) == [0, 3]


def test_reference_and_generator_load_no_program():
    code = ("import sys; import psi_bench.reference, psi_bench.sets; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'nested_hashing_psi_tpu', 'nested_hashing_psi_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 0, p.stdout + p.stderr
