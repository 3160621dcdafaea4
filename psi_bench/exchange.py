"""The system under test: the port's BatchedFHE client and server.

Both parties run as the port's runner runs them (``protocol/runner.py``
``run_parties``): the server in a thread of its own, the two joined by a
``LoopbackChannel``, over which every frame crosses as the bytes TCP would
carry. ``Session`` drives their phases by hand so that a window can hold
many online exchanges against one offline build:

- set-up: both parties' ``run_setup_phase`` (keys, relin key, hash
  functions), then the server's ``run_offline_phase`` (the host cuckoo
  insert and the packed table on the device), timed alone;
- the pool: each client set goes through the client's own
  ``run_offline_phase`` on a fresh copy of its empty cuckoo table, and the
  state that phase leaves (``client_ops``, ``idx_ct``, ``minus_ct``) is kept
  as the set's prepared query;
- ``ask_one``: one set, through both parties' ``run_online_phase``;
- ``ask_many``: several sets in the program's multi-query frame, minus
  ``(Q, 2, L, N)`` and index ``(Q, H, P, 2, L, N)``, which the server serves
  through its ``run_online_phase`` (``_run_online_many``, ``run_many``); the
  client's side of that transaction is written here with the port's
  framing, and decrypted with the port's ``result_zero_mask``, because the
  program's own client repeats one set Q times.

``spans`` receives ``(name, start_ns, end_ns)`` by ``time.time_ns``: for
every server step ``server_wire_in`` (from its first request frame read to
its last: the client's framing, the queue, the server's unframing) and
``server_step`` (from there to its result frames written: uploads, the
PIE, the download) and, with ``time_decrypt``, every client decrypt
(``client_decrypt``: ``result_zero_mask`` between two synchronises);
``server_us`` receives ``(start_ns, us)``, the server's own
``online_computation_us`` of every step. ``wire_bytes`` counts, at the
client's end, every frame of the online phase that crosses the channel in
either direction, with the 8-byte length prefix a TCP channel adds to each.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.convert import ciphertext_from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.data.input import DataInputHandler
from nested_hashing_psi_tpu_torch.protocol import batched_fhe
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel

_RESULT_ZERO_MASK = batched_fhe.result_zero_mask
LENGTH_PREFIX = 8  # bytes a TCP channel sends ahead of every frame


class _Sets(DataInputHandler):
    def __init__(self, server: np.ndarray, client: np.ndarray):
        self._server, self._client = server, client

    def get_server_set(self) -> np.ndarray:
        return self._server

    def get_client_set(self) -> np.ndarray:
        return self._client

    def get_intersection_set(self) -> np.ndarray:
        return np.zeros((0, 2), np.uint64)  # the benchmark's reference judges


def params(config: dict, **program) -> tuple[PSIParams, HashTableParams]:
    """The program's parameters for a configuration file, with the CLI's
    hash and cuckoo-walk seeds (public parameters of the protocol, the same
    in every run). ``program`` replaces ``PSIParams`` fields (the control:
    ``bit_size=16``)."""
    psi = PSIParams(
        server_set_size=config["server_set_size"],
        client_set_size=config["client_set_size"],
        intersection_set_size=0,
        fhe=True, batched=True, bgv=config["scheme"] == "bgv",
        bit_size=config["bit_size"], ring_dim=config["ring_dim"],
        num_limbs=config.get("num_limbs"),
    )
    ht = HashTableParams(
        each_simple_table_size=config["each_simple_table_size"],
        each_cuckoo_table_size=config["each_cuckoo_table_size"],
        n_simple_hash_functions=config["n_simple_hash_functions"],
        n_cuckoo_hash_functions=config["n_cuckoo_hash_functions"],
        max_items_per_position=config["max_items_per_position"],
    )
    return dataclasses.replace(psi, **program), ht


@dataclass
class Query:
    ops: object     # BatchedFHEClientOps of the set's own cuckoo table
    idx: object     # index ciphertexts (H, P, 2, L, N)
    minus: object   # minus ciphertext (2, L, N)


class Session:
    def __init__(self, config: dict, server_items: np.ndarray, device,
                 time_decrypt: bool = False, program: dict | None = None):
        psi, ht = params(config, **(program or {}))
        self.ch_client, self.ch_server = LoopbackChannel.pair()
        data = _Sets(server_items, server_items[:0])
        self.client = batched_fhe.BatchedFHEPSIClient(data, psi, ht, self.ch_client, device=device)
        self.server = batched_fhe.BatchedFHEPSIServer(data, psi, ht, self.ch_server, device=device)
        self.spans: list[tuple[str, int, int]] = []
        self.server_us: list[tuple[int, int]] = []
        self.time_decrypt = time_decrypt
        self.queries: list[Query] = []
        self.offline_s = None
        self.wire_bytes = 0
        self.gave_up = False
        self._error: BaseException | None = None
        self._closing = False
        self._first_read = self._last_read = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        write, read = self.ch_client.write_msg, self.ch_client.read_msg

        def counted_write(payload) -> None:
            self.wire_bytes += len(payload) + LENGTH_PREFIX
            write(payload)

        def counted_read() -> bytes:
            msg = read()
            self.wire_bytes += len(msg) + LENGTH_PREFIX
            return msg

        self.ch_client.write_msg, self.ch_client.read_msg = counted_write, counted_read

    # -- server thread -------------------------------------------------------
    def _serve(self) -> None:
        s = self.server
        try:
            s.run_setup_phase()
            s._signal_phase_over()
            begin = time.perf_counter()
            s.run_offline_phase()  # ends in a synchronise
            self.offline_s = time.perf_counter() - begin
            s._signal_phase_over()
            read = self.ch_server.read_msg

            def timed_read():
                msg = read()
                self._last_read = time.time_ns()
                if self._first_read is None:
                    self._first_read = self._last_read
                return msg

            self.ch_server.read_msg = timed_read
            while True:
                self._first_read = None
                s.run_online_phase()
                self.spans.append(("server_wire_in", self._first_read, self._last_read))
                self.spans.append(("server_step", self._last_read, time.time_ns()))
                self.server_us.append((self._last_read, s.online_computation_us))
        except ConnectionError:
            if not self._closing:
                self._error = self._error or RuntimeError("server channel failed")
        except BaseException as e:  # handed to the client side
            self._error = e
            self.ch_server.poison()

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError("the server failed") from self._error

    def _read_phase_over(self) -> None:
        try:
            self.client._read_phase_over()
        except ConnectionError:
            self._check()
            raise

    # -- client side ---------------------------------------------------------
    def open(self, pool: list[np.ndarray]) -> None:
        """Set both parties up, build the server's table, prepare the pool."""
        c = self.client
        # the client's own run_online_phase calls the module's function
        batched_fhe.result_zero_mask = self._zero_mask
        self._thread.start()
        c.run_setup_phase()
        self._read_phase_over()   # the server's set-up
        self._read_phase_over()   # the server's offline build
        empty = c.client_table
        for items in pool:
            c.client_table = copy.copy(empty)
            c.client_set = items
            c.run_offline_phase()  # ends in a synchronise
            self.queries.append(Query(c.client_ops, c.idx_ct, c.minus_ct))

    def ask_one(self, q: int) -> np.ndarray:
        c, query = self.client, self.queries[q]
        c.client_ops, c.idx_ct, c.minus_ct = query.ops, query.idx, query.minus
        try:
            c.run_online_phase()
        except ConnectionError:
            self._check()
            raise
        return c.intersection_calculated

    def ask_many(self, qs: list[int]) -> list[np.ndarray]:
        c, ch = self.client, self.ch_client
        try:
            ch.write_tensor(to_numpy(torch.stack([self.queries[q].minus.data for q in qs])))
            ch.write_tensor(to_numpy(torch.stack([self.queries[q].idx.data for q in qs])))
            meta = ch.read_tensor()
            result = ciphertext_from_numpy(ch.read_tensor(), c.device,
                                           "bgv" if int(meta[0]) else "bfv", int(meta[1]))
        except ConnectionError:
            self._check()
            raise
        mask, _ = self._zero_mask(c.ctx, result, c.sk, c.ht.batch_slots, c._decryptors)
        return [self.queries[q].ops.extract_intersection_mask(m) for q, m in zip(qs, mask)]

    def _zero_mask(self, *args):
        """The port's ``result_zero_mask``, with its span in ``spans``."""
        if not self.time_decrypt:
            return _RESULT_ZERO_MASK(*args)
        sync = self.client.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        begin = time.time_ns()
        out = _RESULT_ZERO_MASK(*args)
        if sync:
            torch.cuda.synchronize()
        self.spans.append(("client_decrypt", begin, time.time_ns()))
        return out

    def reset_wire(self) -> None:
        self.wire_bytes = 0

    def give_up(self) -> None:
        """Stop waiting for the answer in flight: the client's next read
        raises ConnectionError."""
        self.gave_up = True
        self.ch_server.poison()

    def shape(self) -> dict:
        pie, ctx = self.server.pie, self.server.ctx
        return {"H": pie.H, "D": pie.D, "P": pie.P, "L": ctx.L, "N": ctx.n,
                "scheme": ctx.params.scheme, "mul_limbs": pie.mul_limbs,
                "ship_limbs": pie.ship_limbs, "leveled": pie.leveled}

    def close(self) -> None:
        """Stop the server's loop and wait for its thread."""
        self._closing = True
        self.ch_client.poison()
        self._thread.join(timeout=600)
        batched_fhe.result_zero_mask = _RESULT_ZERO_MASK
        if self._thread.is_alive():
            raise RuntimeError("the server thread did not stop")
        self._check()
