"""Batched FHE PIE: the flagship private-indexed-equality engine (PyTorch).

Counterpart of ``nested_hashing_psi_tpu.pie.batched_fhe``. For every server
bin depth d the server computes, per inner hash function h,

    ip[h] = sum_pos Enc(idx[h][pos]) * pt(table[h][d][pos][slot])  + Enc(-elem)

multiplies across hash functions (zero iff any hash matched) with the
per-depth random masks folded into hash 0's table plaintexts. Slot c of any
depth decrypting to 0 means the client's item in cuckoo slot c is in the
intersection.

The position sum is K2 (``ops.pie_kernels``); every transform is K1. The
cross-hash product takes one of three pipelines, as in the JAX package: the
rescaled BFV pipeline (``mul_limbs < L``: HPS + relin on a smaller basis,
the result shipped on ``ship_limbs``), the flat product on the full basis
(BGV tensor product or BFV HPS, then relin), or the leveled BGV chain
(``leveled=True``: one limb dropped by ``mod_switch`` before each
multiplication, the result shipped on L - (H-1) limbs). The streamed upload
(``run_streamed``) and the host-resident table (``host_table=True``,
``_run_host_table``) run every pipeline.

Spans on ``utils.profiling.TRACER``, each with the device's time:
``pie.position_sum`` (every K2 call), ``pie.combine`` and inside it
``scheme.mul_relin`` (every cross-hash multiply and relinearisation), and,
recorded always, ``build.encode`` (the packed table's build).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from nested_hashing_psi_tpu_torch.hashing.cuckoo import CuckooHashTable
from nested_hashing_psi_tpu_torch.hashing.hierarchical import HierarchicalCuckooHashTable
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, Ciphertext, RelinKey, SecretKey
from nested_hashing_psi_tpu_torch.fhe.device_encode import DeviceEncoder
from nested_hashing_psi_tpu_torch.fhe.params import bfv_mul_limbs, bfv_ship_limbs
from nested_hashing_psi_tpu_torch.ops.modmath import add_mod, mont_mul
from nested_hashing_psi_tpu_torch.ops.pie_kernels import indexed_inner_product
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER, synced_span


def _zero_slots(result_slots: np.ndarray) -> np.ndarray:
    """Vectorized slot == 0 test over decrypted values."""
    zero = np.equal(np.asarray(result_slots), 0)
    return zero if zero.dtype == bool else zero.astype(bool)


def batched_pie_forward(
    ctx: BGVContext,
    rlk: RelinKey,
    idx_data: torch.Tensor,    # (H, P, 2, L, N) index ciphertexts
    minus_data: torch.Tensor,  # (2, L, N) minus-element ciphertext
    table_pt: torch.Tensor,    # (H, D, P, L, N) packed server table (Montgomery)
    mask_pt: torch.Tensor,     # (D, L, N) per-depth masks (Montgomery)
    leveled: bool = False,
    mul_limbs: int | None = None,
    ship_limbs: int | None = None,
) -> Ciphertext:
    """The online step: position sums (K2), then combine_ip. Returns the
    result Ciphertext (D, 2, L', N) with the scheme's form and scale."""
    ip = position_sum(ctx, idx_data, table_pt)
    return combine_ip(
        ctx, rlk, ip, minus_data, mask_pt, leveled=leveled,
        mul_limbs=mul_limbs, ship_limbs=ship_limbs,
    )


def position_sum(ctx: BGVContext, idx_data, table_pt, p0: int | None = None,
                 acc: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(hash, depth) position-summed ct x pt products: (H, D, 2, L, N);
    with p0, over table positions [p0, p0 + idx_data.shape[1]), read in
    place (table_pt is any (H, D, P, L, N) view with a contiguous n axis);
    with acc, added to the running sum acc in place (K2 does the add)."""
    with TRACER.span("pie.position_sum", device=ctx.device):
        return indexed_inner_product(idx_data, table_pt, ctx.p_u32, ctx.pinv_u32, p0, acc)


def combine_ip(
    ctx: BGVContext,
    rlk: RelinKey,
    ip: torch.Tensor,          # (H, D, 2, L, N) position sums
    minus_data: torch.Tensor,  # (2, L, N)
    mask_pt: torch.Tensor,     # (D, L, N)
    leveled: bool = False,
    mul_limbs: int | None = None,
    ship_limbs: int | None = None,
) -> Ciphertext:
    """Add -elem (hash 0 takes the per-depth MASKED minus-element, the masks
    being folded into hash 0's table), then multiply across hash functions:
    on the rescaled BFV basis (mul_limbs < L; mul_limbs = 0 disables it),
    flat on the full basis, or down the leveled BGV chain."""
    with TRACER.span("pie.combine", device=ctx.device):
        H = ip.shape[0]
        minus_masked = mont_mul(
            minus_data[None], mask_pt[:, None], ctx.p, ctx.pinv
        )  # (D, 2, L, N)
        ip0 = add_mod(ip[0], minus_masked, ctx.p)
        rest = [add_mod(ip[h], minus_data[None], ctx.p) for h in range(1, H)]
        if mul_limbs and mul_limbs < ctx.L and H > 1:
            assert ctx.default_form == "bfv", "mul_limbs is the BFV rescaled path"
            acc = Ciphertext(ip0, "bfv", 1)
            cur = ctx.L
            for h in range(1, H):
                with TRACER.span("scheme.mul_relin", device=ctx.device):
                    acc = ctx.hps_mul_relin_rescaled(
                        acc,
                        Ciphertext(rest[h - 1], "bfv", 1),
                        rlk,
                        mul_limbs,
                        ship_limbs=ship_limbs if h == H - 1 else None,
                        a_limbs=cur,
                    )
                cur = mul_limbs
            return acc
        # intermediate ciphertexts carry the context's native form (bgv/bfv)
        form = ctx.default_form
        acc = Ciphertext(ip0, form, 1)
        if not leveled or H == 1:
            for h in range(1, H):
                with TRACER.span("scheme.mul_relin", device=ctx.device):
                    acc = ctx.ct_ct_mul_relin(acc, Ciphertext(rest[h - 1], form, 1), rlk)
            return acc

        assert form == "bgv", "leveled path is BGV-only"
        # chain[lvl] works over L - lvl limbs; multiplication h runs at level h
        # (both operands switched down first), the product is switched once
        # more except after the last multiplication
        chain = [ctx]
        for _ in range(H - 1):
            chain.append(chain[-1].drop_limb_context())

        def switch_to(ct, dst_lvl: int) -> Ciphertext:
            for lv in range(dst_lvl):
                ct = chain[lv].mod_switch(ct)
            return ct

        acc = switch_to(acc, 1)
        for h in range(1, H):
            op = switch_to(Ciphertext(rest[h - 1], "bgv", 1), h)
            with TRACER.span("scheme.mul_relin", device=ctx.device):
                acc = chain[h].ct_ct_mul_relin(acc, op, ctx.shrink_relin_key(rlk, chain[h].L))
            if h < H - 1:
                acc = chain[h].mod_switch(acc)
        return acc


class BatchedFHEPIE(nn.Module):
    """Server-side engine over the whole nested table. ``table_pt``,
    ``mask_pt`` and the relin key are buffers on the context's device;
    ``forward(idx, minus)`` is the online step on ciphertext data. The
    packed table is built on the context's device (``_encode``, span
    ``build.encode``) from the nested table, a host array or the device
    tensor ``hashing.device_build`` leaves.

    ``host_table=True`` keeps the packed table in host memory (pinned when
    the context is on a GPU) for tables beyond what the device should hold;
    the online step then uploads it in position slices. Its host layout is
    position-major, (P, H, D, L, N), so that every slice of positions is one
    contiguous block (an asynchronous copy of a strided slice is neither
    asynchronous nor from pinned memory); ``table_pt`` is the (H, D, P, L, N)
    view of it (``logical_table``).

    ``from_artifact`` rebuilds a runnable PIE from its offline products, as
    a checkpoint resume does (``utils.checkpoint``).

    ``leveled=True`` (BGV, t < 2^31) runs the cross-hash chain with one limb
    dropped per multiplication. ``mul_limbs`` (BFV): None takes the rescaled
    basis from the noise model, 0 disables it (the flat full-basis product);
    ``ship_limbs`` None likewise."""

    def __init__(
        self,
        ctx: BGVContext,
        hct: HierarchicalCuckooHashTable,
        rlk: RelinKey,
        mask_seed: int | None = None,
        leveled: bool = False,
        mul_limbs: int | None = None,
        ship_limbs: int | None = None,
        host_table: bool = False,
        encode_slab: int = 2048,
    ):
        super().__init__()
        if hct.server_stash_size != 0:
            raise ValueError("batched FHE PIE does not support a stash")
        if not (hct.simple_multi_table and hct.cuckoo_multi_table):
            raise ValueError("batched FHE PIE does not support combined tables")
        self._setup(
            ctx, rlk, hct.n_cuckoo_hash_functions, hct.max_items_per_position,
            hct.each_cuckoo_table_size, hct.n_simple_tables * hct.each_simple_table_size,
            leveled, mul_limbs, ship_limbs, host_table,
        )

        with synced_span("build.encode", ctx.device) as span:
            self._encode(ctx, hct.table, mask_seed, host_table, encode_slab)
            span.counts = {"rows": self.H * self.D * self.P + self.D}

    def _encode(self, ctx, table, mask_seed, host_table: bool, encode_slab: int) -> None:
        """The packed table and masks on the context's device from the
        nested table (S, O, H, D, P, 2) of uint64 words (a host array or an
        int64 tensor of any device): the depth shuffle and the masks drawn
        on the host from one Philox stream (the same ``mask_seed`` gives
        the JAX package's table bit for bit), then the permutation gather,
        the mask fold into hash 0's slots and the packed encode
        (``DeviceEncoder``) on the device, in slabs of ``encode_slab``
        rows."""
        dev = ctx.device
        rng = np.random.Generator(
            np.random.Philox(
                key=np.random.SeedSequence().entropy if mask_seed is None else mask_seed
            )
        )
        if isinstance(table, np.ndarray):
            table = torch.from_numpy(np.ascontiguousarray(table, dtype=np.uint64).view(np.int64))
        table = table.to(dev)
        # shuffle depth rows per (outer cell, inner table) to hide which
        # depth matched
        S, O = table.shape[0], table.shape[1]
        perm = np.argsort(rng.random((S, O, self.H, self.D)), axis=-1)
        if bool(table[..., 1].any()):
            raise ValueError("FHE paths support items below 64 bits only")
        perm = torch.from_numpy(perm).to(dev)[..., None].expand(*perm.shape, self.P)
        # -> slot-major rows (h, d, p) of batch = S*O slots
        slots = torch.gather(table[..., 0], 3, perm).permute(2, 3, 4, 0, 1).reshape(
            self.H * self.D * self.P, S * O)
        del perm

        # per-depth random nonzero masks, folded into hash 0's table slots
        enc = DeviceEncoder(ctx)
        mask = enc.reduce(
            torch.from_numpy(rng.integers(1, ctx.t, size=(self.D, self.batch_slots))).to(dev))
        mask_q = enc.quotient(mask)
        self.register_buffer("mask_pt", enc.plaintext_mont(mask))

        DP, rows = self.D * self.P, self.H * self.D * self.P
        if host_table:
            host = _position_major_storage(self.H, self.D, self.P, ctx)
        slabs = []
        # slabs never straddle hash 0's rows (r < D*P, masked) and the rest
        for s in [*range(0, DP, encode_slab), *range(DP, rows, encode_slab)]:
            e = min(s + encode_slab, DP if s < DP else rows)
            if s < DP:
                d = torch.arange(s, e, device=dev) // self.P
                vals = enc.fold(slots[s:e], [m[d] for m in mask], [q[d] for q in mask_q])
            else:
                vals = enc.reduce(slots[s:e])
            pt = enc.plaintext_mont(vals)
            if host_table:
                r = torch.arange(s, e)
                host[r % self.P, r // self.P] = pt.cpu()
            else:
                slabs.append(pt)
        if host_table:
            pt = _logical_view(host, self.H, self.D)
        else:
            pt = (slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=0)).reshape(
                self.H, self.D, self.P, ctx.L, ctx.n
            )
        self.register_buffer("table_pt", pt)

    def _setup(self, ctx, rlk, H, D, P, batch_slots, leveled, mul_limbs, ship_limbs,
               host_table) -> None:
        """Everything but the table and masks, shared by the build and
        ``from_artifact``: the geometry, the relin key buffers, the leveled
        chain's and the rescaled pipeline's child contexts (built before the
        first query) and the host table's copy stream."""
        self.ctx = ctx
        self.H = H
        if leveled:
            assert ctx.default_form == "bgv" and ctx.t < 2**31, (
                "leveled PIE requires BGV with t < 2^31"
            )
            assert ctx.L - (H - 1) >= 2, "not enough limbs for the chain"
            ctx.context_for_limbs(ctx.L - (H - 1))
        self.leveled = leveled
        self._setup_mul_limbs(mul_limbs, ship_limbs)
        self.D, self.P, self.batch_slots = D, P, batch_slots
        self.host_table = host_table
        self.register_buffer("rlk_b", rlk.b_mont)
        self.register_buffer("rlk_a", rlk.a_mont)
        self._copy_stream = None

    @classmethod
    def from_artifact(
        cls, ctx: BGVContext, rlk: RelinKey, table_pt: torch.Tensor, mask_pt: torch.Tensor,
        H: int, D: int, P: int, batch_slots: int, leveled: bool = False,
        mul_limbs: int | None = None, ship_limbs: int | None = None,
        host_table: bool = False,
    ) -> "BatchedFHEPIE":
        """A runnable PIE from its offline products without the hash table
        (checkpoint resume, ``utils.checkpoint``): ``table_pt`` is the
        logical (H, D, P, L, N) int32 table, ``mask_pt`` the (D, L, N)
        masks, both on any device. The table goes to the context's device,
        or with ``host_table`` into the position-major host storage
        (pinned when the context is on a GPU). ``mul_limbs`` and
        ``ship_limbs`` as in the constructor: 0 keeps the flat product."""
        pie = cls.__new__(cls)
        nn.Module.__init__(pie)
        pie._setup(ctx, rlk, H, D, P, batch_slots, leveled, mul_limbs, ship_limbs, host_table)
        if tuple(table_pt.shape) != (H, D, P, ctx.L, ctx.n):
            raise ValueError(f"table {tuple(table_pt.shape)} is not (H, D, P, L, N) = "
                             f"{(H, D, P, ctx.L, ctx.n)}")
        if host_table:
            host = _position_major_storage(H, D, P, ctx)
            host.view(P, H, D, ctx.L, ctx.n).copy_(table_pt.permute(2, 0, 1, 3, 4))
            table_pt = _logical_view(host, H, D)
        pie.register_buffer("table_pt", table_pt if host_table else table_pt.to(ctx.device))
        pie.register_buffer("mask_pt", mask_pt.to(ctx.device))
        return pie

    @property
    def rlk(self) -> RelinKey:
        return RelinKey(b_mont=self.rlk_b, a_mont=self.rlk_a)

    def _setup_mul_limbs(self, mul_limbs: int | None, ship_limbs: int | None) -> None:
        """The rescaled-mult basis (BFV): None = from the noise model
        (fhe.params), 0 = disabled. The cross-hash HPS mults + relin then run
        on mul_limbs limbs and the result ships on ship_limbs. Child
        contexts, converters and rescalers are built here, before the first
        query. Any other case (BGV, H = 1, mul_limbs >= L) leaves both None:
        the flat or leveled product."""
        ctx = self.ctx
        self.mul_limbs = self.ship_limbs = None
        if ctx.default_form != "bfv" or self.H == 1:
            return
        if mul_limbs is None:
            mul_limbs = bfv_mul_limbs(ctx.t.bit_length(), ctx.L, self.H - 1, ring_dim=ctx.n)
        if not (mul_limbs and mul_limbs < ctx.L):
            return
        self.mul_limbs = mul_limbs
        self.ship_limbs = (
            bfv_ship_limbs(ctx.t.bit_length(), mul_limbs, ring_dim=ctx.n)
            if ship_limbs is None else ship_limbs
        )
        mctx = ctx.context_for_limbs(self.mul_limbs)
        mctx.mulconv
        ctx._rescaler(self.mul_limbs)
        if self.ship_limbs < self.mul_limbs:
            ctx.context_for_limbs(self.ship_limbs)
            mctx._rescaler(self.ship_limbs)

    def forward(self, idx: torch.Tensor, minus: torch.Tensor) -> Ciphertext:
        """idx: (H, P, 2, L, N); minus: (2, L, N) -> result (D, 2, L', N)."""
        if self.host_table:
            form = self.ctx.default_form
            return self._run_host_table(Ciphertext(idx, form), Ciphertext(minus, form))
        return batched_pie_forward(
            self.ctx, self.rlk, idx, minus, self.table_pt, self.mask_pt,
            leveled=self.leveled, mul_limbs=self.mul_limbs, ship_limbs=self.ship_limbs,
        )

    def _combine(self, ip: torch.Tensor, minus_data: torch.Tensor) -> Ciphertext:
        return combine_ip(
            self.ctx, self.rlk, ip, minus_data, self.mask_pt, leveled=self.leveled,
            mul_limbs=self.mul_limbs, ship_limbs=self.ship_limbs,
        )

    def logical_table(self) -> torch.Tensor:
        """The packed table as its logical (H, D, P, L, N) tensor, the layout
        a checkpoint stores: the device buffer, or for a host-resident PIE
        the permuted view of its position-major storage (not a copy)."""
        return self.table_pt

    def _host_positions(self) -> torch.Tensor:
        """The host table as the contiguous (P, H, D, L, N) tensor it is."""
        return self.table_pt.permute(2, 0, 1, 3, 4)

    def _upload(self, p0: int, w: int) -> torch.Tensor:
        """Positions [p0, p0 + w) of the host table on the device (on the
        current stream), as the (H, D, w, L, N) view of their position-major
        (w, H, D, L, N) copy, which K2 reads in place."""
        part = self._host_positions()[p0 : p0 + w].to(self.ctx.device, non_blocking=True)
        return part.permute(1, 2, 0, 3, 4)

    def _run_host_table(
        self, index_cts: Ciphertext, minus_ct: Ciphertext,
        pos_chunk: int | None = None,
    ) -> Ciphertext:
        """Online step with the packed table in host memory: equal-width
        position slices are uploaded and position-summed (K2, reading each
        position-major slice in place and adding it to the running sum) one
        by one, then the combine stage runs on the device. On a GPU each
        upload runs on a copy stream into one of two device buffers, so
        slice k+1 crosses the bus while K2 works on slice k; events order
        each buffer's reuse. Default slice: the widest divisor of P whose
        slice stays within 2 GiB."""
        ctx, P = self.ctx, self.P
        if pos_chunk is None:
            per_pos = self.H * self.D * ctx.L * ctx.n * 4
            pos_chunk = max(1, min(P, (2 << 30) // per_pos))
        while P % pos_chunk:
            pos_chunk -= 1
        idx, w = index_cts.data, pos_chunk
        starts = range(0, P, w)
        ip = None
        if ctx.device.type != "cuda":
            for p0 in starts:
                ip = position_sum(ctx, idx[:, p0 : p0 + w], self._upload(p0, w), acc=ip)
            return self._combine(ip, minus_ct.data)
        host = self._host_positions()
        compute = torch.cuda.current_stream(ctx.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(ctx.device)
        copy = self._copy_stream
        nbuf = min(2, len(starts))
        bufs = [torch.empty_like(host[:w], device=ctx.device) for _ in range(nbuf)]
        loaded = [torch.cuda.Event() for _ in range(nbuf)]
        freed = [torch.cuda.Event() for _ in range(nbuf)]
        copy.wait_stream(compute)  # the buffers' memory may still be in use there
        for k, p0 in enumerate(starts):
            b = k % nbuf
            with torch.cuda.stream(copy):
                if k >= nbuf:
                    copy.wait_event(freed[b])  # K2 is done with slice k - 2
                bufs[b].copy_(host[p0 : p0 + w], non_blocking=True)
                loaded[b].record(copy)
            compute.wait_event(loaded[b])
            ip = position_sum(ctx, idx[:, p0 : p0 + w], bufs[b].permute(1, 2, 0, 3, 4),
                              acc=ip)
            freed[b].record(compute)  # after the K2 launch that reads bufs[b]
        return self._combine(ip, minus_ct.data)

    def run_streamed(self, chunks, minus_ct: Ciphertext) -> Ciphertext:
        """Online step over the index ciphertexts as they arrive.

        chunks: iterable of (p0, idx_chunk), idx_chunk an (H, w, 2, L, N)
        slice of the index ciphertexts starting at inner position p0 (host
        or device tensor). Each chunk's position sum (K2 over the table's
        positions [p0, p0 + w), read in place) is enqueued as it arrives and
        nothing synchronises, so the device works on chunk k while the
        caller reads chunk k+1; each chunk's K2 adds its sum to the running
        sum mod q in place, then combine_ip runs once."""
        ctx = self.ctx
        ip = None
        for p0, idx_chunk in chunks:
            idx_chunk = idx_chunk.to(ctx.device, non_blocking=True)
            if self.host_table:
                ip = position_sum(ctx, idx_chunk, self._upload(p0, idx_chunk.shape[1]), acc=ip)
            else:
                ip = position_sum(ctx, idx_chunk, self.table_pt, p0, acc=ip)
        return self._combine(ip, minus_ct.data)

    def run(self, index_cts: Ciphertext, minus_ct: Ciphertext) -> Ciphertext:
        return self(index_cts.data, minus_ct.data)

    def run_many(self, index_batch: torch.Tensor, minus_batch: torch.Tensor) -> torch.Tensor:
        """Q independent queries: index_batch (Q, H, P, 2, L, N), minus_batch
        (Q, 2, L, N) -> (Q, D, 2, L', N). One query's working set at a time;
        per-query results are identical to run()."""
        return torch.stack(
            [self(i, m).data for i, m in zip(index_batch, minus_batch)]
        )


def _position_major_storage(H: int, D: int, P: int, ctx: BGVContext) -> torch.Tensor:
    """Empty host storage of a host-resident table, position-major
    (P, H*D, L, N) int32, pinned when the context is on a GPU."""
    return torch.empty((P, H * D, ctx.L, ctx.n), dtype=torch.int32,
                       pin_memory=ctx.device.type == "cuda")


def _logical_view(host: torch.Tensor, H: int, D: int) -> torch.Tensor:
    """The (H, D, P, L, N) view of position-major host storage."""
    P, _, L, n = host.shape
    return host.view(P, H, D, L, n).permute(1, 2, 0, 3, 4)


@dataclass
class BatchedFHEClientOps:
    """Client-side batched-PIE operations: index-matrix construction and
    result extraction (reference: BatchedFHEPSIClient.cpp:107-193)."""

    ctx: BGVContext
    client_table: CuckooHashTable
    n_simple_hf: int
    n_cuckoo_hf: int
    each_cuckoo_table_size: int

    def build_index_and_minus(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (plain index matrix (H, P, batch) 0/1, minus-element (batch,));
        empty client slots contribute 0-rows and minus-element 1."""
        tab = self.client_table.table  # (n_tables, 1, simple_size, 2)
        items = tab[:, 0, :, :].reshape(-1, 2)  # (batch, 2) slot-major
        batch = items.shape[0]
        H, P = self.n_cuckoo_hf, self.each_cuckoo_table_size
        occupied = (items != 0).any(axis=1)
        minus = np.ones(batch, dtype=object)
        vals = items[:, 0].astype(object) + (items[:, 1].astype(object) << 64)
        for c in np.nonzero(occupied)[0]:
            minus[c] = -int(vals[c])
        index = np.zeros((H, P, batch), dtype=np.int64)
        hasher = self.client_table.hasher
        occ_items = items[occupied]
        occ_slots = np.nonzero(occupied)[0]
        for h in range(H):
            pos = hasher.hash_index(occ_items, self.n_simple_hf + h, P)
            index[h, pos, occ_slots] = 1
        return index, minus

    def encrypt_query(self, sk: SecretKey) -> tuple[Ciphertext, Ciphertext]:
        """-> (index ciphertexts (H, P, 2, L, N), minus ciphertext (2, L, N))."""
        index, minus = self.build_index_and_minus()
        H, P, batch = index.shape
        pt_idx = self.ctx.make_plaintext_rns(index.reshape(H * P, batch).astype(object))
        idx_ct = self.ctx.encrypt_sk(pt_idx, sk)
        idx_ct = Ciphertext(
            idx_ct.data.reshape(H, P, 2, self.ctx.L, self.ctx.n), idx_ct.form
        )
        minus_ct = self.ctx.encrypt_sk(self.ctx.make_plaintext_rns(minus), sk)
        return idx_ct, minus_ct

    def extract_intersection(self, result_slots: np.ndarray) -> np.ndarray:
        """result_slots: (D, batch) decrypted values -> (k, 2) uint64 items of
        the intersection (slot c matches iff any depth is 0)."""
        return self.extract_intersection_mask(_zero_slots(result_slots))

    def extract_intersection_mask(self, zero_mask: np.ndarray) -> np.ndarray:
        """Same extraction from a per-slot zero mask (D, batch) or (batch,)."""
        zero_mask = np.asarray(zero_mask, dtype=bool)
        matched = zero_mask.any(axis=0) if zero_mask.ndim > 1 else zero_mask
        tab = self.client_table.table[:, 0, :, :].reshape(-1, 2)
        occupied = (tab != 0).any(axis=1)
        return tab[matched[: len(tab)] & occupied]
