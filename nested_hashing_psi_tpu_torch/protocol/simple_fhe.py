"""Simple (per-position) FHE PSI protocol (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.protocol.simple_fhe`` with the same
phases and wire frames (scheme-params vector, Galois elements, the stacked
Galois keys, index ciphertexts, result ciphertexts), so a port party can talk
to a JAX party. Per client cuckoo position the client sends nCuckooHF index
ciphertexts (one-hot inner-hash index || -elem); the server answers with
nCuckooHF masked merged ciphertexts whose first maxPP slots hold the per-bin
randomized differences, a zero slot marking a hit. All positions travel and
batch as one dense tensor (``pie.simple_fhe.SimpleFHEPIE``).

Each party computes on an explicit ``device``; "cuda" raises when no GPU is
present. The client decrypts the result in bounded chunks, each through
``protocol.batched_fhe.result_zero_mask``, the one place a client picks its
decrypt: on a GPU on the device straight to the zero mask, BFV and BGV
results alike; on the CPU on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.convert import from_numpy, receive, send
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, RelinKey
from nested_hashing_psi_tpu_torch.fhe.params import (
    SchemeParams,
    default_num_limbs,
    plaintext_modulus_for_bit_size,
    validate_wire_scheme_params,
)
from nested_hashing_psi_tpu_torch.hashing import (
    CuckooHashTable,
    HierarchicalCuckooHashTable,
    TabulationHashing,
)
from nested_hashing_psi_tpu_torch.pie.simple_fhe import SimpleFHEClientOps, SimpleFHEPIE
from nested_hashing_psi_tpu_torch.protocol import batched_fhe
from nested_hashing_psi_tpu_torch.protocol.base import PSIClientBase, PSIServerBase
from nested_hashing_psi_tpu_torch.protocol.channel import Channel
from nested_hashing_psi_tpu_torch.utils.device import resolve_device, synchronize

PROTOCOL_NAME = "SimpleFHE"
DECRYPT_CHUNK_BYTES = 1 << 29  # phase rows decrypted at a time


def _scheme_params(psi: PSIParams, ht: HashTableParams) -> SchemeParams:
    t = plaintext_modulus_for_bit_size(psi.bit_size)
    scheme = "bgv" if psi.bgv else "bfv"
    # no ct x ct; eval_sum models the rotation ladder's key-switch noise
    limbs = psi.num_limbs or default_num_limbs(
        t.bit_length(), 0, ht.each_cuckoo_table_size + 1, scheme,
        eval_sum=True, ring_dim=psi.ring_dim,
    )
    sp = SchemeParams(
        ring_dim=psi.ring_dim, plaintext_modulus=t, num_limbs=limbs, scheme=scheme
    )
    sp.validate_security()
    return sp


class SimpleFHEPSIClient(PSIClientBase):
    def __init__(self, data, params: PSIParams, ht: HashTableParams,
                 channel: Channel, device="cuda", **kw):
        super().__init__(data, params, channel, PROTOCOL_NAME, **kw)
        self.ht = ht
        self.device = resolve_device(device)
        self._decryptors: dict = {}  # result_zero_mask's, by (form, limbs)

    def run_setup_phase(self) -> None:
        p, ht = self.params, self.ht
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        self.ctx = make_context(_scheme_params(p, ht), seed=None, device=self.device)
        self.sk, self.pk = self.ctx.keygen()
        els = self.ctx.sum_ladder_elements()
        self.gks = self.ctx.galois_keygen(self.sk, els)
        self.client_table = CuckooHashTable(
            self.hasher,
            each_table_size=ht.each_simple_table_size,
            n_hash_functions=ht.n_simple_hash_functions,
            starting_hash_id=0,
            max_stash_size=0,
            multi_table=ht.simple_multi_table,
            max_items_per_position=1,
            seed=p.item_seed ^ 0x51E,
        )
        sp = self.ctx.params
        send(self.channel, np.array([sp.ring_dim, sp.plaintext_modulus, sp.num_limbs,
                                     1 if sp.scheme == "bgv" else 0], np.uint64))
        send(self.channel, np.array(els, np.int64))
        send(self.channel, torch.stack([self.gks[k].b_mont for k in els]))
        send(self.channel, torch.stack([self.gks[k].a_mont for k in els]))

    def run_offline_phase(self) -> None:
        self.client_table.insert_all(self.client_set)
        self.client_ops = SimpleFHEClientOps(
            self.ctx,
            self.client_table,
            self.ht.n_simple_hash_functions,
            self.ht.n_cuckoo_hash_functions,
            self.ht.each_cuckoo_table_size,
            self.ht.max_items_per_position,
        )
        self.idx_ct = self.client_ops.encrypt_query(self.sk)
        synchronize(self.device)  # the offline phase owns this cost

    def run_online_phase(self) -> None:
        send(self.channel, self.idx_ct.data)
        ctx, maxpp = self.ctx, self.ht.max_items_per_position
        data = receive(self.channel, self.device)
        flat = data.reshape(-1, 2, ctx.L, ctx.n)
        # decrypt in bounded chunks: the whole (nPies*H)-row stack's
        # transients would sit beside the server's table on a shared card
        chunk = max(1, DECRYPT_CHUNK_BYTES // (2 * ctx.L * ctx.n * 4))
        masks, noise = [], []
        for s in range(0, flat.shape[0], chunk):
            mask, bits = batched_fhe.result_zero_mask(
                ctx, Ciphertext(flat[s : s + chunk], ctx.default_form, 1), self.sk, maxpp,
                self._decryptors)
            masks.append(mask)
            noise.append(bits)
        # the device decrypt estimates no noise
        self.noise_bits = None if None in noise else max(0.0, *noise)
        shape = (data.shape[0], self.ht.n_cuckoo_hash_functions, maxpp)
        self.intersection_calculated = self.client_ops.extract_intersection_mask(
            np.concatenate(masks, axis=0).reshape(shape)
        )


class SimpleFHEPSIServer(PSIServerBase):
    def __init__(self, data, params: PSIParams, ht: HashTableParams,
                 channel: Channel, device="cuda", **kw):
        super().__init__(data, params, channel, PROTOCOL_NAME, **kw)
        self.ht = ht
        self.device = resolve_device(device)

    def run_setup_phase(self) -> None:
        p, ht = self.params, self.ht
        self.hasher = TabulationHashing(
            p.hash_seed, ht.n_simple_hash_functions + ht.n_cuckoo_hash_functions
        )
        meta = self.channel.read_tensor()
        if meta.shape != (4,):
            raise ValueError(f"malformed scheme-params frame {meta.shape}")
        ring_dim, t, limbs, is_bgv = (int(v) for v in meta)
        # peer-supplied parameters are untrusted: bound them first
        sp = validate_wire_scheme_params(ring_dim, t, limbs, "bgv" if is_bgv else "bfv")
        self.ctx = make_context(sp, seed=None, device=self.device)
        els = [int(k) for k in self.channel.read_tensor()]
        b, a = self.channel.read_tensor(), self.channel.read_tensor()
        want = (len(els), sp.num_limbs, sp.num_limbs, sp.ring_dim)
        if b.shape != want or a.shape != want:
            raise ValueError(f"Galois key frames {b.shape}/{a.shape}, expected {want}")
        b, a = from_numpy(b, self.device), from_numpy(a, self.device)
        self.gks = {k: RelinKey(b_mont=b[i], a_mont=a[i]) for i, k in enumerate(els)}
        self.server_table = HierarchicalCuckooHashTable.from_params(
            self.hasher, ht, seed=p.item_seed ^ 0x7A12
        )

    def run_offline_phase(self) -> None:
        begin = time.monotonic_ns()
        self.server_table.insert_all(self.server_set)
        self.pie = SimpleFHEPIE(self.ctx, self.server_table, self.gks)
        synchronize(self.device)
        self.offline_computation_us = (time.monotonic_ns() - begin) // 1000

    def run_online_phase(self) -> None:
        idx = Ciphertext(receive(self.channel, self.device), self.ctx.default_form)
        begin = time.monotonic_ns()
        result = self.pie.run(idx)
        synchronize(self.device)
        self.online_computation_us = (time.monotonic_ns() - begin) // 1000
        send(self.channel, result.data)
        if self.params.export_performance:
            self.export_measurements()
