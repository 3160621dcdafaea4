"""Deterministic input-set generators with a prescribed intersection.

The port's own copy of ``nested_hashing_psi_tpu.data.input``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Capability parity with the reference's DataInputHandler family
(reference src/Common/DataInput/RandomDataInput.cpp:31-67,
FixedDataInput.cpp:27-29). Contract: client and server processes construct
the generator independently from the same (item_seed, sizes, bit_size) and
derive consistent sets -- the server set, the client set, and an intersection
of exactly `intersection_set_size` common elements -- without communicating.

Two PRG streams (the reference's mtClient / mtServer twisters with seed
offset 2^32 + 2^16 + 1) are reproduced with Philox counter streams:
 - stream B (seed + SERVER_SEED_DIFF): server items; its first
   `intersection_set_size` draws are the intersection, which the client
   appends to its own set.
 - stream A (seed): client-only items.

Divergences from the reference (both deliberate hardening, noted per
SURVEY.md's "generator contract"):
 - Values 0 and 1 are rejected during sampling (0 is the table dummy, 1 the
   dummy minus-element; the reference's `isNotAllowed` is written but never
   called -- a latent bug for small bit sizes).
 - Client-only items are rejected if they collide with the server set, so the
   realized intersection always has exactly the requested size (the reference
   only guarantees this w.h.p. for large bit sizes). Both parties can apply
   the same rejection because both can regenerate stream B.
"""

from __future__ import annotations

import numpy as np

SERVER_SEED_DIFF = (1 << 32) + (1 << 16) + 1


class DataInputHandler:
    def get_client_set(self) -> np.ndarray:
        raise NotImplementedError

    def get_server_set(self) -> np.ndarray:
        raise NotImplementedError

    def get_intersection_set(self) -> np.ndarray:
        raise NotImplementedError


def _random_items(rng: np.random.Generator, count: int, bit_size: int) -> np.ndarray:
    """(count, 2) uint64 items uniform in [2, 2**bit_size); rejects 0 and 1."""
    out = np.zeros((0, 2), dtype=np.uint64)
    while len(out) < count:
        need = count - len(out)
        draw = rng.integers(0, 2**64, size=(need + 8, 2), dtype=np.uint64)
        if bit_size <= 64:
            draw[:, 1] = 0
            if bit_size < 64:
                draw[:, 0] &= np.uint64((1 << bit_size) - 1)
        elif bit_size < 128:
            draw[:, 1] &= np.uint64((1 << (bit_size - 64)) - 1)
        ok = ~((draw[:, 1] == 0) & (draw[:, 0] <= 1))
        out = np.concatenate([out, draw[ok][:need]])
    return out[:count]


class RandomDataInput(DataInputHandler):
    def __init__(
        self,
        server_set_size: int,
        client_set_size: int,
        intersection_set_size: int,
        set_generation_seed: int,
        bit_size: int,
    ):
        assert client_set_size <= server_set_size
        assert intersection_set_size <= client_set_size
        assert bit_size > np.log2(
            max(2, client_set_size + server_set_size - intersection_set_size)
        )
        self.bit_size = bit_size
        self.sizes = (server_set_size, client_set_size, intersection_set_size)
        self.seed = set_generation_seed
        self._client = None
        self._server = None
        self._intersection = None

    def _generate(self):
        server_n, client_n, inter_n = self.sizes
        rng_server = np.random.Generator(
            np.random.Philox(key=(self.seed + SERVER_SEED_DIFF) % 2**64)
        )
        rng_client = np.random.Generator(np.random.Philox(key=self.seed))

        server = _random_items(rng_server, server_n, self.bit_size)
        self._server = server
        self._intersection = server[:inter_n].copy()

        # Client-only items: reject collisions with the server set.
        server_keys = set(map(tuple, server.tolist()))
        only_client_n = client_n - inter_n
        chunks = []
        have = 0
        while have < only_client_n:
            cand = _random_items(rng_client, only_client_n - have, self.bit_size)
            keep = np.array(
                [tuple(r) not in server_keys for r in cand.tolist()], dtype=bool
            )
            cand = cand[keep]
            chunks.append(cand)
            have += len(cand)
        only_client = (
            np.concatenate(chunks) if chunks else np.zeros((0, 2), np.uint64)
        )
        self._client = np.concatenate([only_client, self._intersection])

    def get_client_set(self) -> np.ndarray:
        if self._client is None:
            self._generate()
        return self._client

    def get_server_set(self) -> np.ndarray:
        if self._server is None:
            self._generate()
        return self._server

    def get_intersection_set(self) -> np.ndarray:
        if self._intersection is None:
            self._generate()
        return self._intersection


class FixedDataInput(DataInputHandler):
    """Iota-based debuggable sets (reference: FixedDataInput.cpp:27-29)."""

    N_DUMMY = 2  # skip 0 (table dummy) and 1 (dummy minus-element)

    def __init__(
        self,
        server_set_size: int,
        client_set_size: int,
        intersection_set_size: int,
        bit_size: int = 32,
    ):
        assert client_set_size <= server_set_size
        assert intersection_set_size <= client_set_size
        d = self.N_DUMMY
        client = np.arange(d, client_set_size + d, dtype=np.uint64)
        start = client_set_size + d - intersection_set_size
        inter = np.arange(start, start + intersection_set_size, dtype=np.uint64)
        server = np.arange(start, start + server_set_size, dtype=np.uint64)
        self._client = np.stack([client, np.zeros_like(client)], axis=1)
        self._inter = np.stack([inter, np.zeros_like(inter)], axis=1)
        self._server = np.stack([server, np.zeros_like(server)], axis=1)

    def get_client_set(self) -> np.ndarray:
        return self._client

    def get_server_set(self) -> np.ndarray:
        return self._server

    def get_intersection_set(self) -> np.ndarray:
        return self._inter
