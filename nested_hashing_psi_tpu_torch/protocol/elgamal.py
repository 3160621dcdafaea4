"""ElGamal PSI protocols (Simple + Precomp).

The port's own copy of ``nested_hashing_psi_tpu.protocol.elgamal``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_elgamal.py holds it against the original.

Capability parity with the reference's ElGamal track
(reference src/{Client,Server}/ElGamal/*): lifted EC-ElGamal PIEs over
the nested structure, client-side decrypts-to-zero checks, and the
precomputation variant that ships encrypted *random* bit matrices during
setup, exponentiates them offline, and sends only plain xor-correction
bitvectors online.

Host-side by design in both packages (SURVEY section 2.2): every party
accepts ``device`` as the FHE parties do, and does all its work on the
host; no GPU kernel runs on this path.
Wire differences: ciphertext batches are concatenated fixed-width point
encodings in one message per logical unit instead of per-ciphertext strings.
"""

from __future__ import annotations

import time

import numpy as np

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.crypto.ec import ec_group
from nested_hashing_psi_tpu_torch.crypto.elgamal import AddHomElGamal, ElGamalCiphertext
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.pie.elgamal import ElGamalPIE, PrecompElGamalPIE
from nested_hashing_psi_tpu_torch.protocol.base import PSIClientBase, PSIServerBase
from nested_hashing_psi_tpu_torch.protocol.channel import Channel
from nested_hashing_psi_tpu_torch.utils.device import resolve_device


def _item_int(item) -> int:
    return int(item[0]) | (int(item[1]) << 64)


class _ElGamalClientBase(PSIClientBase):
    def __init__(self, data, params: PSIParams, ht: HashTableParams, channel: Channel,
                 device="cuda", **kw):
        name = self.PROTOCOL + params.curve_name
        super().__init__(data, params, channel, name, **kw)
        self.ht = ht
        self.device = resolve_device(device)  # as the FHE parties do; the work stays on the host

    def _setup_common(self) -> None:
        p, ht = self.params, self.ht
        self.enc = AddHomElGamal(ec_group(p.curve_name))
        self.result_size = (
            ht.max_items_per_position * ht.n_cuckoo_hash_functions
            + ht.server_stash_size
        )
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        self.client_table = CuckooHashTable(
            self.hasher,
            each_table_size=ht.each_simple_table_size,
            n_hash_functions=ht.n_simple_hash_functions,
            starting_hash_id=0,
            max_stash_size=0,
            multi_table=ht.simple_multi_table,
            max_items_per_position=1,
            seed=p.item_seed ^ 0xE1,
        )
        pk, _ = self.enc.keygen()
        self.channel.write_msg(self.enc.point_to_bytes(pk))

    def _slot_items(self) -> np.ndarray:
        return self.client_table.table[:, 0, :, :].reshape(-1, 2)

    def _encrypt_minus_elements(self) -> list[ElGamalCiphertext]:
        msgs = []
        for item in self._slot_items():
            v = _item_int(item)
            msgs.append(-v if v != 0 else 1)
        return self.enc.encrypt_batch(msgs)

    def _one_hot_positions(self, item) -> list[int]:
        """Inner-hash index per cuckoo hf (dummy uses element 0, like the
        reference's generateIndexMatrix on an empty slot)."""
        ht = self.ht
        return [
            int(
                self.hasher.hash_index(
                    np.asarray(item)[None, :],
                    ht.n_simple_hash_functions + h,
                    ht.each_cuckoo_table_size,
                )[0]
            )
            for h in range(ht.n_cuckoo_hash_functions)
        ]

    def _send_cts(self, cts: list[ElGamalCiphertext]) -> None:
        self.channel.write_msg(b"".join(self.enc.ct_to_bytes(c) for c in cts))

    def _recv_cts(self, count: int) -> list[ElGamalCiphertext]:
        from nested_hashing_psi_tpu_torch.protocol.channel import WireFormatError

        data = self.channel.read_msg()
        k = 2 * (self.enc.group.nbytes + 1)
        if len(data) != count * k:
            raise WireFormatError(
                f"ciphertext batch of {len(data)} bytes, expected "
                f"{count} x {k}"
            )
        return self.enc.cts_from_bytes(data, count)

    def _receive_and_extract(self) -> None:
        items = self._slot_items()
        found_items = []
        for item in items:
            cts = self._recv_cts(self.result_size)
            v = _item_int(item)
            if v == 0:
                continue
            if any(self.enc.decrypts_to_zero_batch(cts)):
                found_items.append((int(item[0]), int(item[1])))
        self.intersection_calculated = np.array(
            found_items, dtype=np.uint64
        ).reshape(-1, 2)


class _ElGamalServerBase(PSIServerBase):
    def __init__(self, data, params: PSIParams, ht: HashTableParams, channel: Channel,
                 device="cuda", **kw):
        name = self.PROTOCOL + "ElGamal-" + params.curve_name
        super().__init__(data, params, channel, name, **kw)
        self.ht = ht
        self.device = resolve_device(device)  # as the FHE parties do; the work stays on the host

    def _setup_common(self) -> None:
        p, ht = self.params, self.ht
        self.enc = AddHomElGamal(ec_group(p.curve_name))
        self.enc.set_public_key(self.enc.point_from_bytes(self.channel.read_msg()))
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        self.server_table = HierarchicalCuckooHashTable.from_params(
            self.hasher, ht, seed=p.item_seed ^ 0xE2
        )
        self.n_pies = self.server_table.n_simple_tables * ht.each_simple_table_size

    def _pie_cell(self, pie_index: int):
        """(table values (n_tables, bins, positions), stash ints) per cell."""
        s = pie_index // self.ht.each_simple_table_size
        o = pie_index % self.ht.each_simple_table_size
        cell = self.server_table.table[s, o]  # (n_tables, bins, positions, 2)
        vals = cell[..., 0].astype(object) + (cell[..., 1].astype(object) << 64)
        stash = [
            int(lo) | (int(hi) << 64)
            for lo, hi in self.server_table.stash[s, o].astype(object)
        ]
        return vals, stash

    def _send_cts(self, cts: list[ElGamalCiphertext]) -> None:
        self.channel.write_msg(b"".join(self.enc.ct_to_bytes(c) for c in cts))

    def _recv_cts(self, count: int) -> list[ElGamalCiphertext]:
        from nested_hashing_psi_tpu_torch.protocol.channel import WireFormatError

        data = self.channel.read_msg()
        k = 2 * (self.enc.group.nbytes + 1)
        if len(data) != count * k:
            raise WireFormatError(
                f"ciphertext batch of {len(data)} bytes, expected "
                f"{count} x {k}"
            )
        return self.enc.cts_from_bytes(data, count)

    def _run_pies_threaded(self, recv_inputs, job):
        """Online-phase engine honoring --nThreads (the reference runs PIE
        collections on boost::thread pools, ElGamalPSIServer.hpp:62-80).

        recv_inputs(pie) -> args reads one PIE's wire input (serial: wire
        order is the protocol); job(pie, *args) -> results runs its EC
        compute, submitted to a worker pool as its input arrives -- compute
        overlaps the remaining receives. Safe because each PIE owns its
        randomness (SystemRandom) and the native EC batch calls release the
        GIL (pure compute, ctypes). Returns (ordered results, compute_us):
        compute_us is the SUM of per-job compute durations measured inside
        the worker, identically in both modes, so exported
        OnlineComputationTime numbers are comparable across --nThreads
        settings (wall-clock of the overlapped section is what the Online
        phase time already captures)."""
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        durations_ns: list[int] = []

        def timed_job(pie, *args):
            begin = _time.monotonic_ns()
            out = job(pie, *args)
            durations_ns.append(_time.monotonic_ns() - begin)  # GIL-atomic
            return out

        n_threads = max(1, min(self.params.number_of_threads, self.n_pies))
        if n_threads == 1:
            results = [timed_job(pie, *recv_inputs(pie)) for pie in self.pies]
        else:
            with ThreadPoolExecutor(max_workers=n_threads) as ex:
                futures = [
                    ex.submit(timed_job, pie, *recv_inputs(pie))
                    for pie in self.pies
                ]
                results = [f.result() for f in futures]
        return results, sum(durations_ns) // 1000


# ---------------------------------------------------------------------------
# Simple (baseline) protocol
# ---------------------------------------------------------------------------

class SimpleElGamalPSIClient(_ElGamalClientBase):
    PROTOCOL = "Simple"

    def run_setup_phase(self) -> None:
        self._setup_common()

    def run_offline_phase(self) -> None:
        ht = self.ht
        self.client_table.insert_all(self.client_set)
        self.minus_cts = self._encrypt_minus_elements()
        H, P = ht.n_cuckoo_hash_functions, ht.each_cuckoo_table_size
        msgs = []
        for item in self._slot_items():
            pos = self._one_hot_positions(item)
            for h in range(H):
                msgs += [1 if j == pos[h] else 0 for j in range(P)]
        cts = self.enc.encrypt_batch(msgs)  # one batch for every one-hot bit
        self.index_matrices = [
            [
                cts[(i * H + h) * P : (i * H + h + 1) * P]
                for h in range(H)
            ]
            for i in range(len(self._slot_items()))
        ]

    def run_online_phase(self) -> None:
        for mats, minus in zip(self.index_matrices, self.minus_cts):
            self._send_cts([c for row in mats for c in row])
            self._send_cts([minus])
        self._receive_and_extract()


class SimpleElGamalPSIServer(_ElGamalServerBase):
    PROTOCOL = "Simple"

    def run_setup_phase(self) -> None:
        self._setup_common()

    def run_offline_phase(self) -> None:
        begin = time.monotonic_ns()
        self.server_table.insert_all(self.server_set)
        self.pies = []
        for i in range(self.n_pies):
            vals, stash = self._pie_cell(i)
            self.pies.append(
                ElGamalPIE(
                    self.enc,
                    vals,
                    stash,
                    self.ht.cuckoo_multi_table,
                    self.ht.n_cuckoo_hash_functions,
                )
            )
        self.offline_computation_us = (time.monotonic_ns() - begin) // 1000

    def run_online_phase(self) -> None:
        ht = self.ht
        per_pos = ht.n_cuckoo_hash_functions * ht.each_cuckoo_table_size

        def recv_inputs(pie):
            flat = self._recv_cts(per_pos)
            minus = self._recv_cts(1)[0]
            return flat, minus

        def job(pie, flat, minus):
            pie.index_matrix = [
                flat[h * ht.each_cuckoo_table_size : (h + 1) * ht.each_cuckoo_table_size]
                for h in range(ht.n_cuckoo_hash_functions)
            ]
            pie.minus_elem = minus
            return pie.run()

        all_results, compute_us = self._run_pies_threaded(recv_inputs, job)
        for res in all_results:
            self._send_cts(res)
        self.online_computation_us = compute_us
        if self.params.export_performance:
            self.export_measurements()


# ---------------------------------------------------------------------------
# Precomputation protocol
# ---------------------------------------------------------------------------

class PrecompElGamalPSIClient(_ElGamalClientBase):
    PROTOCOL = "Precomp"

    def run_setup_phase(self) -> None:
        self._setup_common()
        ht = self.ht
        n_pos = self.client_table.n_tables * ht.each_simple_table_size
        bits_per_pos = ht.n_cuckoo_hash_functions * ht.each_cuckoo_table_size
        # The bit matrix must be unpredictable to the SERVER: the online
        # correction vector is bits ^ one-hot(index), so any server-derivable
        # stream leaks the client's positions. The reference draws a fresh
        # client-private AES key (PrecompElGamalPSIClient.cpp:21-24); we do
        # the same (AES-CTR keyed from OS entropy, never shared).
        import secrets

        from nested_hashing_psi_tpu_torch.utils.prg import AesCtrPrg

        self._prg = AesCtrPrg(secrets.token_bytes(16))
        self.random_bits = (
            self._prg.get_bits(n_pos * bits_per_pos)
            .reshape(n_pos, bits_per_pos)
            .astype(np.uint8)
        )
        all_cts = self.enc.encrypt_batch(
            [int(b) for b in self.random_bits.reshape(-1)]
        )
        for pos in range(n_pos):
            self._send_cts(all_cts[pos * bits_per_pos : (pos + 1) * bits_per_pos])

    def run_offline_phase(self) -> None:
        self.client_table.insert_all(self.client_set)
        self.minus_cts = self._encrypt_minus_elements()

    def run_online_phase(self) -> None:
        ht = self.ht
        for i, (item, minus) in enumerate(zip(self._slot_items(), self.minus_cts)):
            bits = self.random_bits[i].copy()
            pos = self._one_hot_positions(item)
            for h in range(ht.n_cuckoo_hash_functions):
                bits[h * ht.each_cuckoo_table_size + pos[h]] ^= 1
            self.channel.write_msg(bits.tobytes())
            self._send_cts([minus])
        self._receive_and_extract()


class PrecompElGamalPSIServer(_ElGamalServerBase):
    PROTOCOL = "Precomp"

    def run_setup_phase(self) -> None:
        self._setup_common()
        ht = self.ht
        per_pos = ht.n_cuckoo_hash_functions * ht.each_cuckoo_table_size
        self.index_matrices = [self._recv_cts(per_pos) for _ in range(self.n_pies)]

    def run_offline_phase(self) -> None:
        ht = self.ht
        begin = time.monotonic_ns()
        self.server_table.insert_all(self.server_set)
        self.pies = []
        for i in range(self.n_pies):
            vals, stash = self._pie_cell(i)
            pie = PrecompElGamalPIE(
                self.enc,
                vals,
                stash,
                ht.cuckoo_multi_table,
                ht.n_cuckoo_hash_functions,
            )
            flat = self.index_matrices[i]
            pie.index_matrix = [
                flat[h * ht.each_cuckoo_table_size : (h + 1) * ht.each_cuckoo_table_size]
                for h in range(ht.n_cuckoo_hash_functions)
            ]
            pie.precomp()
            self.pies.append(pie)
        self.offline_computation_us = (time.monotonic_ns() - begin) // 1000

    def run_online_phase(self) -> None:
        def recv_inputs(pie):
            bits = np.frombuffer(self.channel.read_msg(), dtype=np.uint8)
            minus = self._recv_cts(1)[0]
            return bits, minus

        def job(pie, bits, minus):
            pie.minus_elem = minus
            return pie.run(bits)

        all_results, compute_us = self._run_pies_threaded(recv_inputs, job)
        for res in all_results:
            self._send_cts(res)
        self.online_computation_us = compute_us
        if self.params.export_performance:
            self.export_measurements()
