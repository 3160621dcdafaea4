"""Batched FHE PSI protocol: the headline client/server pair (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.protocol.batched_fhe`` with the same
phases and the same wire frames (scheme-params vector, relin key, minus and
index ciphertexts, result meta + result ciphertexts, all uint32 tensors), so
a port party can talk to a JAX party. Each party computes on an explicit
``device``; "cuda" raises when no GPU is present. On a GPU the client
decrypts on the device straight to the zero mask, BFV and ``--bgv`` results
alike, in one launch of the decrypt kernel (``fhe.device_decrypt``; the JAX
package's on-chip branch takes BFV only); on the CPU it decrypts on the
host. ``--bgv`` runs the leveled PIE when t fits the device's
mod-t arithmetic (16-bit items) and the flat product otherwise.
``--streamChunks`` sends the index ciphertexts in chunks that the server
position-sums as they arrive, and a packed table above 5 GB stays in host
memory (``BatchedFHEPIE(host_table=True)``). The server builds its nested
cuckoo table and its packed table on its own device. Constructing either
party sets the process's host allocator to keep the frames' freed memory
mapped (``utils.host_heap``).

Each party's online phase is a span on ``utils.profiling.TRACER``
(``client.exchange``, ``server.exchange``, numbered by the party's own
count of online phases), holding its frames (``wire.pack``,
``wire.unpack``, ``convert.send``/``receive``), the server's step
(``server.step``, the lines ``online_computation_us`` times) and the
client's decrypt (``client.decrypt``) and extraction (``client.extract``).
The server's offline phase is ``server.offline``, holding ``build.insert``
and ``build.encode``: recorded always, each timed between two synchronises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.hashing.device_build import insert_hierarchical
from nested_hashing_psi_tpu_torch.protocol.base import PSIClientBase, PSIServerBase
from nested_hashing_psi_tpu_torch.protocol.channel import Channel
from nested_hashing_psi_tpu_torch.convert import receive, send
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, RelinKey
from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
from nested_hashing_psi_tpu_torch.fhe.params import (
    SchemeParams,
    bfv_batched_client_limbs,
    default_num_limbs,
    leveled_default,
    plaintext_modulus_for_bit_size,
    validate_wire_scheme_params,
)
from nested_hashing_psi_tpu_torch.pie.batched_fhe import (
    BatchedFHEClientOps,
    BatchedFHEPIE,
)
from nested_hashing_psi_tpu_torch.utils.device import resolve_device, synchronize
from nested_hashing_psi_tpu_torch.utils.host_heap import keep_freed_host_memory
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER, synced_span

PROTOCOL_NAME = "BatchedFHE"
HOST_TABLE_BYTES = 5 << 30  # above this the reference keeps the table on the host


def _scheme_params(psi: PSIParams, ht: HashTableParams) -> SchemeParams:
    t = plaintext_modulus_for_bit_size(psi.bit_size)
    scheme = "bgv" if psi.bgv else "bfv"  # the reference's default is BFV
    if scheme == "bfv":
        auto = bfv_batched_client_limbs(
            t.bit_length(),
            ht.each_cuckoo_table_size,
            ht.n_cuckoo_hash_functions,
            ring_dim=psi.ring_dim,
        )
    else:
        # the server builds its PIE leveled under the same predicate
        auto = default_num_limbs(
            t.bit_length(),
            ht.n_cuckoo_hash_functions - 1,
            ht.each_cuckoo_table_size,
            scheme,
            leveled=leveled_default(scheme, t, ht.n_cuckoo_hash_functions),
            ring_dim=psi.ring_dim,
        )
    sp = SchemeParams(
        ring_dim=psi.ring_dim,
        plaintext_modulus=t,
        num_limbs=psi.num_limbs or auto,
        scheme=scheme,
    )
    sp.validate_security()
    return sp


def result_zero_mask(ctx, result: Ciphertext, sk, length: int,
                     decryptors: dict) -> tuple[np.ndarray, float | None]:
    """A result's per-slot zero mask (..., length), decrypted in the
    context of its limb count: on a GPU on the device, BFV and BGV forms
    alike (``DeviceDecryptor``, kept in ``decryptors`` by (form, limb
    count); no noise estimate), on the CPU on the host.
    -> (mask, noise bits or None). Span ``client.decrypt``, holding
    ``decrypt.device`` (the device decrypt and its mask's download) or the
    host decrypt's spans (``BGVContext.decrypt``).

    The one place a client picks its decrypt: the BatchedFHE and SimpleFHE
    clients both call it through this module's global, which
    ``psi_bench/exchange.py`` replaces to time the decrypt."""
    with TRACER.span("client.decrypt"):
        n_limbs = result.data.shape[-2]
        dctx = ctx.context_for_limbs(n_limbs)
        dsk = ctx.shrink_key_to(sk, n_limbs)
        if ctx.device.type == "cuda":
            key = (result.form, n_limbs)
            if key not in decryptors:
                decryptors[key] = DeviceDecryptor(dctx, result.form)
            with TRACER.span("decrypt.device", device=ctx.device):
                mask = decryptors[key].zero_mask(result.data, dsk.s_mont, length)
                return mask.cpu().numpy(), None
        slots, noise = dctx.decrypt(result, dsk, length=length)
        return np.asarray(slots, dtype=object) == 0, noise


class BatchedFHEPSIClient(PSIClientBase):
    exchanges = 0  # online phases run: the ordinal of their spans

    def __init__(self, data, params: PSIParams, ht: HashTableParams,
                 channel: Channel, device="cuda", **kw):
        super().__init__(data, params, channel, PROTOCOL_NAME, **kw)
        self.ht = ht
        self.device = resolve_device(device)
        keep_freed_host_memory()
        self._decryptors: dict[tuple[str, int], DeviceDecryptor] = {}

    def run_setup_phase(self) -> None:
        p, ht = self.params, self.ht
        if ht.batch_slots > p.ring_dim:
            raise ValueError(
                f"batch slots {ht.batch_slots} exceed ring dim {p.ring_dim}"
            )
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        self.ctx = make_context(_scheme_params(p, ht), seed=None, device=self.device)
        self.sk, self.pk = self.ctx.keygen()
        self.rlk = self.ctx.relin_keygen(self.sk)
        self.client_table = CuckooHashTable(
            self.hasher,
            each_table_size=ht.each_simple_table_size,
            n_hash_functions=ht.n_simple_hash_functions,
            starting_hash_id=0,
            max_stash_size=0,
            multi_table=ht.simple_multi_table,
            max_items_per_position=1,
            seed=p.item_seed ^ 0x5EED,
        )
        sp = self.ctx.params
        send(self.channel, np.array([sp.ring_dim, sp.plaintext_modulus, sp.num_limbs,
                                     1 if sp.scheme == "bgv" else 0], np.uint64))
        send(self.channel, self.rlk.b_mont)
        send(self.channel, self.rlk.a_mont)

    def run_offline_phase(self) -> None:
        self.client_table.insert_all(self.client_set)
        self.client_ops = BatchedFHEClientOps(
            self.ctx,
            self.client_table,
            self.ht.n_simple_hash_functions,
            self.ht.n_cuckoo_hash_functions,
            self.ht.each_cuckoo_table_size,
        )
        self.idx_ct, self.minus_ct = self.client_ops.encrypt_query(self.sk)
        synchronize(self.device)  # the offline phase owns this cost

    def _effective_chunks(self) -> int:
        """Largest divisor of the inner position count <= the requested
        stream_chunks (the server sums equal-width chunks)."""
        P = self.ht.each_cuckoo_table_size
        n = max(1, min(self.params.stream_chunks, P))
        while P % n:
            n -= 1
        return n

    def _read_and_decrypt(self) -> np.ndarray:
        """Read the result frames and decrypt them to the per-slot zero mask
        (``result_zero_mask``); on the device decrypt, noise_bits only with
        --verbose, which adds the host decrypt."""
        meta = receive(self.channel)
        result = Ciphertext(receive(self.channel, self.device),
                            "bgv" if int(meta[0]) else "bfv", int(meta[1]))
        length = self.ht.batch_slots
        mask, self.noise_bits = result_zero_mask(self.ctx, result, self.sk, length,
                                                 self._decryptors)
        if self.noise_bits is None and self.params.verbose:
            _, self.noise_bits = self.ctx.decrypt(result, self.sk, length=length)
        return mask

    def run_online_phase(self) -> None:
        self.exchanges += 1
        with TRACER.span("client.exchange", exchange=self.exchanges):
            if self.params.num_queries > 1:
                return self._run_online_many(self.params.num_queries)
            send(self.channel, self.minus_ct.data)
            n_chunks = self._effective_chunks()
            send(self.channel, np.array([n_chunks], np.uint64))
            w = self.ht.each_cuckoo_table_size // n_chunks
            for c in range(n_chunks):
                send(self.channel, self.idx_ct.data[:, c * w : (c + 1) * w])
            mask = self._read_and_decrypt()
            with TRACER.span("client.extract"):
                self.intersection_calculated = self.client_ops.extract_intersection_mask(mask)

    def _run_online_many(self, Q: int) -> None:
        """Q query sets in ONE exchange (--queries Q); the client checks that
        every query's zero mask agrees before extracting."""
        send(self.channel, torch.stack([self.minus_ct.data] * Q))
        send(self.channel, torch.stack([self.idx_ct.data] * Q))
        per_q = self._read_and_decrypt().any(axis=1)  # (Q, D, batch) -> (Q, batch)
        if not (per_q == per_q[0]).all():
            raise ValueError("multi-query results disagree across the batch")
        with TRACER.span("client.extract"):
            self.intersection_calculated = self.client_ops.extract_intersection_mask(
                per_q[0]
            )


class BatchedFHEPSIServer(PSIServerBase):
    exchanges = 0  # online phases run: the ordinal of their spans

    def __init__(self, data, params: PSIParams, ht: HashTableParams,
                 channel: Channel, device="cuda", **kw):
        super().__init__(data, params, channel, PROTOCOL_NAME, **kw)
        self.ht = ht
        self.device = resolve_device(device)
        keep_freed_host_memory()

    def run_setup_phase(self) -> None:
        p, ht = self.params, self.ht
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        meta = receive(self.channel)
        if meta.shape != (4,):
            raise ValueError(f"malformed scheme-params frame {meta.shape}")
        ring_dim, t, limbs, is_bgv = (int(v) for v in meta)
        # client-supplied parameters are untrusted: bound them first
        sp = validate_wire_scheme_params(
            ring_dim, t, limbs, "bgv" if is_bgv else "bfv"
        )
        self.ctx = make_context(sp, seed=None, device=self.device)
        self.rlk = RelinKey(b_mont=receive(self.channel, self.device),
                            a_mont=receive(self.channel, self.device))
        self.server_table = HierarchicalCuckooHashTable.from_params(
            self.hasher, ht, seed=p.item_seed ^ 0x7A11
        )

    def run_offline_phase(self) -> None:
        """The server's build on its own device: the nested cuckoo table
        (``hashing.device_build``, span ``build.insert``), then the packed
        table and masks (``BatchedFHEPIE``, span ``build.encode``), all in
        span ``server.offline``, whose host time is
        ``offline_computation_us``."""
        with synced_span("server.offline", self.device) as span:
            insert_hierarchical(self.server_table, self.server_set, self.device)
            ht, ctx = self.ht, self.ctx
            table_bytes = (
                ht.n_cuckoo_hash_functions * ht.max_items_per_position
                * ht.each_cuckoo_table_size * ctx.L * ctx.n * 4
            )
            self.pie = BatchedFHEPIE(
                ctx, self.server_table, self.rlk,
                leveled=leveled_default(ctx.params.scheme, ctx.t, ht.n_cuckoo_hash_functions),
                host_table=table_bytes > HOST_TABLE_BYTES,
            )
        self.offline_computation_us = span.duration_us

    def run_online_phase(self) -> None:
        self.exchanges += 1
        with TRACER.span("server.exchange", exchange=self.exchanges):
            minus = receive(self.channel, self.device)
            if minus.ndim == 4:  # (Q, 2, L, N): multi-query transaction
                return self._run_online_many(minus)
            n_chunks = int(receive(self.channel)[0])
            P = self.ht.each_cuckoo_table_size
            if not (1 <= n_chunks <= P and P % n_chunks == 0):
                raise ValueError(
                    f"invalid stream chunk count {n_chunks} from client "
                    f"(must divide the inner position count {P})"
                )
            if n_chunks == 1:
                idx = receive(self.channel, self.device)
            begin = time.monotonic_ns()
            with TRACER.span("server.step"):
                if n_chunks == 1:
                    result = self.pie(idx, minus)
                else:
                    # each chunk's position sum is enqueued as it arrives, so
                    # the device works while the next chunk is read off the wire
                    w = P // n_chunks
                    chunks = ((c * w, receive(self.channel, self.device, non_blocking=True))
                              for c in range(n_chunks))
                    result = self.pie.run_streamed(chunks,
                                                   Ciphertext(minus, self.ctx.default_form))
                synchronize(self.device)
            self.online_computation_us = (time.monotonic_ns() - begin) // 1000
            send(self.channel, np.array([1 if result.form == "bgv" else 0, result.scale],
                                        np.uint64))
            send(self.channel, result.data)
            if self.params.export_performance:
                self.export_measurements()

    def _run_online_many(self, minus_b: torch.Tensor) -> None:
        """Serve a (Q, ...) multi-query transaction."""
        Q = minus_b.shape[0]
        if not (2 <= Q <= 1024):
            raise ValueError(f"multi-query batch size {Q} outside [2, 1024]")
        idx_b = receive(self.channel, self.device)
        if idx_b.ndim != 6 or idx_b.shape[0] != Q:
            raise ValueError(
                f"multi-query index tensor shape {tuple(idx_b.shape)} does not "
                f"match batch size {Q}"
            )
        begin = time.monotonic_ns()
        with TRACER.span("server.step"):
            out = self.pie.run_many(idx_b, minus_b)
            synchronize(self.device)
        self.online_computation_us = (time.monotonic_ns() - begin) // 1000
        # the JAX server's frame: the native form and scale 1, even where a
        # leveled result carries prod q_l^-1 mod t (ROADMAP Queue 3)
        is_bgv = 1 if self.ctx.default_form == "bgv" else 0
        send(self.channel, np.array([is_bgv, 1], np.uint64))
        send(self.channel, out)
        if self.params.export_performance:
            self.export_measurements()
