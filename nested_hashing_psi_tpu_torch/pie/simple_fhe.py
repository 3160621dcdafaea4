"""Single-position FHE PIE, batched across all outer-table positions (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.pie.simple_fhe``. For one inner
cuckoo table, per inner hash function h and bin b the server computes the
slot sum of the one-hot index ciphertext against the bin's items plus the
trailing -elem term (EvalInnerProduct), merges the per-bin results into one
ciphertext (slot b = bin b's value) and multiplies by a random mask. Bin
order is shuffled per (pie, hash function) and the hash functions' output
order per pie, to hide which hash and bin matched.

Every (outer table, outer position) inner table is one "pie"; all of them
batch into one tensor pipeline, inputs (nPies, H, 2, L, N) against the table
(nPies, H, B, L, N), run in pie chunks that bound the device working set.
EvalSum is the rotation ladder (log2(n/2) automorphisms and one
conjugation, each a Galois key switch whose transforms are K1) over the
whole (chunk, H, B) block; the merge needs no rotation, since the slot sum
leaves the inner product in every slot and the one-hot selector e_b places
bin b's value in slot b. The ct x pt products are plain Montgomery
products, as in the JAX package (K2 is not on this path).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext, RelinKey, SecretKey
from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooHashTable
from nested_hashing_psi_tpu_torch.hashing.hierarchical import HierarchicalCuckooHashTable
from nested_hashing_psi_tpu_torch.ops.modmath import modsum, mont_mul
from nested_hashing_psi_tpu_torch.pie.batched_fhe import _zero_slots


class SimpleFHEPIE(nn.Module):
    """Batched engine over every (outer table, outer position) inner table.
    ``table_pt``, ``sel_pt``, ``mask_pt``, ``hf_perm`` and the Galois keys
    (``gk_b``, ``gk_a``, stacked in ``gk_elements`` order) are buffers; a
    packed table above ``HOST_TABLE_BYTES`` stays in host memory (pinned on
    a GPU) and ``run`` uploads it chunk by chunk."""

    HOST_TABLE_BYTES = 6 << 30
    # device-memory budget for one chunk's working set: the EvalSum ladder's
    # gadget decompose fans the (chunk, H, B, 2, L, N) block out by ~L digit
    # planes, so the budget counts L + 2 copies of it
    CHUNK_BYTES = 1 << 30

    def __init__(
        self,
        ctx: BGVContext,
        hct: HierarchicalCuckooHashTable,
        galois_keys: dict[int, RelinKey],
        mask_seed: int | None = None,
    ):
        super().__init__()
        if hct.server_stash_size != 0:
            raise ValueError("FHE PIE does not support a stash")
        self.ctx = ctx
        self.H = hct.n_cuckoo_hash_functions
        self.B = hct.max_items_per_position       # bins per hash fn
        self.P = hct.each_cuckoo_table_size       # row length
        if self.P + 1 > ctx.n:
            raise ValueError("inner table row does not fit in ring slots")
        self.gk_elements = [int(k) for k in galois_keys]
        self.register_buffer("gk_b", torch.stack([galois_keys[k].b_mont for k in self.gk_elements]))
        self.register_buffer("gk_a", torch.stack([galois_keys[k].a_mont for k in self.gk_elements]))

        # numpy Philox draws in the JAX package's order: the same mask_seed
        # gives its bin permutation, masks and hash-function permutation
        rng = np.random.Generator(
            np.random.Philox(
                key=np.random.SeedSequence().entropy if mask_seed is None else mask_seed
            )
        )
        table = hct.table  # (S, O, H, B, P, 2)
        S, O = table.shape[0], table.shape[1]
        self.n_pies = S * O
        if table[..., 1].any():
            raise ValueError("FHE paths support items below 64 bits only")
        vals = table[..., 0].reshape(self.n_pies, self.H, self.B, self.P)
        # permVec2: shuffle bin order per (pie, hf)
        self.bin_perm = np.argsort(rng.random((self.n_pies, self.H, self.B)), axis=-1)
        vals = np.take_along_axis(vals, self.bin_perm[..., None], axis=2)
        # rows (nPies, H, B, P+1) with a trailing 1 for the -elem slot
        rows = np.concatenate(
            [vals.astype(object), np.ones((self.n_pies, self.H, self.B, 1), object)],
            axis=-1,
        )
        flat = rows.reshape(-1, self.P + 1)
        self.host_table = flat.shape[0] * ctx.L * ctx.n * 4 > self.HOST_TABLE_BYTES
        if self.host_table:
            pt = torch.empty((flat.shape[0], ctx.L, ctx.n), dtype=torch.int32,
                             pin_memory=ctx.device.type == "cuda")
        slabs = []
        for s0 in range(0, flat.shape[0], 2048):  # bounded encode slabs
            part = ctx.make_plaintext_mont(flat[s0 : s0 + 2048])
            if self.host_table:
                pt[s0 : s0 + len(part)] = part.cpu()
            else:
                slabs.append(part)
        if not self.host_table:
            pt = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=0)
        self.register_buffer("table_pt", pt.reshape(self.n_pies, self.H, self.B, ctx.L, ctx.n))

        # one-hot slot selectors e_b (merge masks) and per-(pie, hf) random
        # masks over the first B slots
        eye = np.eye(self.B, dtype=np.int64)
        self.register_buffer("sel_pt", ctx.make_plaintext_mont(eye.astype(object)))
        mask_vals = rng.integers(1, ctx.t, size=(self.n_pies, self.H, self.B))
        self.register_buffer("mask_pt", ctx.make_plaintext_mont(
            mask_vals.reshape(-1, self.B).astype(object)
        ).reshape(self.n_pies, self.H, ctx.L, ctx.n))
        # permutationVector: shuffle hash-fn output order per pie
        self.register_buffer("hf_perm", torch.from_numpy(
            np.argsort(rng.random((self.n_pies, self.H)), axis=-1)
        ).to(ctx.device))

    @property
    def gks(self) -> dict[int, RelinKey]:
        return {k: RelinKey(b_mont=self.gk_b[i], a_mont=self.gk_a[i])
                for i, k in enumerate(self.gk_elements)}

    def _pie_chunk(self) -> int:
        per_pie = self.H * self.B * 2 * self.ctx.L * self.ctx.n * 4 * (self.ctx.L + 2)
        return max(1, min(self.n_pies, self.CHUNK_BYTES // per_pie))

    def run(self, index_cts: Ciphertext, pie_chunk: int | None = None) -> Ciphertext:
        """index_cts: (nPies, H, 2, L, N) -> results (nPies, H, 2, L, N)
        (hash-fn axis shuffled per pie; slot b of a result = bin b).

        Runs in pie chunks of one shape (the last one zero-padded): at the
        reference's sweep geometries the all-positions working set exceeds
        device memory."""
        c = self._pie_chunk() if pie_chunk is None else max(1, min(pie_chunk, self.n_pies))
        dev = self.ctx.device
        if c >= self.n_pies and not self.host_table:
            return self._run_impl(index_cts.data, self.table_pt, self.mask_pt, self.hf_perm)
        outs = []
        for s in range(0, self.n_pies, c):
            e = min(s + c, self.n_pies)
            pad = c - (e - s)

            def slc(a):
                part = a[s:e].to(dev, non_blocking=True)
                if pad:
                    part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
                return part

            out = self._run_impl(
                slc(index_cts.data), slc(self.table_pt), slc(self.mask_pt), slc(self.hf_perm)
            )
            outs.append(out.data[: e - s])
        return Ciphertext(torch.cat(outs, dim=0), out.form, out.scale)

    def _run_impl(self, idx, table_pt, mask_pt, hf_perm) -> Ciphertext:
        return answer_pies(self.ctx, self.gks, self.sel_pt, idx, table_pt, mask_pt, hf_perm)


def answer_pies(ctx: BGVContext, gks: dict[int, RelinKey], sel_pt, idx, table_pt, mask_pt,
                hf_perm) -> Ciphertext:
    """The online step on one block of pies: idx (c, H, 2, L, N) against
    table_pt (c, H, B, L, N), mask_pt (c, H, L, N) and hf_perm (c, H)."""
    prod = mont_mul(idx[:, :, None], table_pt[:, :, :, None], ctx.p, ctx.pinv)  # (c, H, B, 2, L, N)
    summed = ctx.eval_sum_all_slots(Ciphertext(prod, ctx.default_form), gks).data
    sel = mont_mul(summed, sel_pt[:, None], ctx.p, ctx.pinv)
    merged = modsum(sel, ctx.p, axis=2)                  # (c, H, 2, L, N)
    masked = mont_mul(merged, mask_pt[:, :, None], ctx.p, ctx.pinv)
    order = hf_perm[:, :, None, None, None].expand(masked.shape)
    return Ciphertext(torch.gather(masked, 1, order), ctx.default_form)


class SimpleFHEClientOps:
    """Client-side index construction and result extraction (reference
    SimpleFHEPSIClient.cpp:105-160, 242-266)."""

    # bound the encryption transients: each chunk of rows stays ~0.5 GB of
    # device working set beside the server's table on a shared card
    ENC_CHUNK_BYTES = 1 << 29

    def __init__(
        self,
        ctx: BGVContext,
        client_table: CuckooHashTable,
        n_simple_hf: int,
        n_cuckoo_hf: int,
        each_cuckoo_table_size: int,
        max_pp: int,
    ):
        self.ctx = ctx
        self.client_table = client_table
        self.n_simple_hf = n_simple_hf
        self.H = n_cuckoo_hf
        self.P = each_cuckoo_table_size
        self.max_pp = max_pp

    def _slot_items(self) -> np.ndarray:
        return self.client_table.table[:, 0, :, :].reshape(-1, 2)

    def build_index_vectors(self) -> np.ndarray:
        """-> (nPies, H, P+1) plain index vectors: one-hot(hash pos) || -elem;
        dummy positions get an all-zero index and -1 (elem treated as 1)."""
        items = self._slot_items()
        occupied = (items != 0).any(axis=1)
        out = np.zeros((len(items), self.H, self.P + 1), dtype=object)
        out[:, :, self.P] = -1
        hasher = self.client_table.hasher
        occ_idx = np.nonzero(occupied)[0]
        occ_items = items[occupied]
        vals = occ_items[:, 0].astype(object) + (occ_items[:, 1].astype(object) << 64)
        for h in range(self.H):
            pos = hasher.hash_index(occ_items, self.n_simple_hf + h, self.P)
            for row, p_, v in zip(occ_idx, pos, vals):
                out[row, h, p_] = 1
                out[row, h, self.P] = -int(v)
        return out

    def encrypt_query(self, sk: SecretKey) -> Ciphertext:
        """-> index ciphertexts (nPies, H, 2, L, N), encrypted in bounded
        chunks of rows."""
        vec = self.build_index_vectors()
        n_pies = vec.shape[0]
        rows = vec.reshape(n_pies * self.H, self.P + 1)
        per_row = 2 * self.ctx.L * self.ctx.n * 4
        chunk = max(1, min(len(rows), self.ENC_CHUNK_BYTES // per_row))
        parts = [
            self.ctx.encrypt_sk(self.ctx.make_plaintext_rns(rows[s : s + chunk]), sk).data
            for s in range(0, len(rows), chunk)
        ]
        data = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        return Ciphertext(
            data.reshape(n_pies, self.H, 2, self.ctx.L, self.ctx.n), self.ctx.default_form
        )

    def extract_intersection(self, result_slots: np.ndarray) -> np.ndarray:
        """result_slots: (nPies, H, max_pp) decrypted bin values. A client
        position matches iff any (hf, bin) is 0."""
        return self.extract_intersection_mask(_zero_slots(result_slots))

    def extract_intersection_mask(self, zero_mask: np.ndarray) -> np.ndarray:
        """Same extraction from a (nPies, H, max_pp) zero mask (the
        on-device decrypt's artifact)."""
        matched = np.asarray(zero_mask, dtype=bool).any(axis=(1, 2))
        items = self._slot_items()
        occupied = (items != 0).any(axis=1)
        return items[matched & occupied]
