"""Sharding of the batched and SimpleFHE PIE online steps over ranks.

Counterpart of ``nested_hashing_psi_tpu.parallel.mesh``. The reference's
only parallelism is a thread pool on one node; the JAX package scales the
online step out over a mesh, and so does this module, over the ranks of a
``torch.distributed`` group (``parallel.multihost.Mesh``):

 - ``sharded_pie_step``: dp over bin depths x tp over RNS limbs. GSPMD
   partitions the JAX step; here the rank's program is written out: K2
   sums positions over the rank's own limbs, the limbs are gathered over
   tp, ``combine_ip`` runs on the full basis for the rank's depths and the
   rank keeps its limb slice of the result.
 - ``sp_sharded_pie_step``: the ring axis in blocks of n/D coefficients;
   every pointwise op is local and every transform of the relinearisation
   (and of BFV's HPS product) is the ring-exchange NTT.
 - ``pp_pipelined_pie_step``: positions split over a ring of k ranks; the
   depth chunks' running sums travel around the ring, each hop overlapped
   with the next chunk's position sum.
 - ``sharded_simple_pie_step``: SimpleFHE's pies split over all ranks, with
   no collective.

Each step function returns (fn, specs): ``fn`` maps this rank's shards of
the inputs to its shard of the result; ``specs`` gives each operand's and
the result's spec, for ``multihost.host_to_global`` / ``global_to_host``.
The batched steps compute on the full basis (no rescaled product), as the
JAX package's do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext, RelinKey, tensor_product
from nested_hashing_psi_tpu_torch.ops.modmath import (
    add_mod,
    cond_sub_mod,
    modsum,
    mont_mul,
    sub_mod,
)
from nested_hashing_psi_tpu_torch.ops.pie_kernels import indexed_inner_product
from nested_hashing_psi_tpu_torch.parallel import comm
from nested_hashing_psi_tpu_torch.parallel.dist_ntt import ring_ntt_local_fns
from nested_hashing_psi_tpu_torch.parallel.multihost import Mesh, global_mesh
from nested_hashing_psi_tpu_torch.pie.batched_fhe import combine_ip
from nested_hashing_psi_tpu_torch.pie.simple_fhe import answer_pies


def make_mesh(n_devices: int, tp: int | None = None, *, device="cuda") -> Mesh:
    """A (dp, tp) mesh over the group's ``n_devices`` ranks; tp = 2 when
    n_devices is even, else 1."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"need {n_devices} ranks, the group has {dist.get_world_size()}")
    if tp is None:
        tp = 2 if n_devices % 2 == 0 else 1
    return global_mesh(n_devices // tp, tp, device=device)


def pie_shardings(mesh: Mesh) -> dict:
    """Specs of the dp x tp step's operands and result. Layouts: idx
    (H,P,2,L,N), minus (2,L,N), table (H,D,P,L,N), mask (D,L,N), rlk
    (L_dig,L,N), out (D,2,L,N)."""
    return dict(
        idx=(None, None, None, "tp", None),
        minus=(None, "tp", None),
        table=(None, "dp", None, "tp", None),
        mask=("dp", "tp", None),
        rlk=(None, "tp", None),
        out=("dp", None, "tp", None),
    )


def _position_sum(idx, table, p_u32, pinv_u32, pos_chunk: int | None):
    """K2 over all positions, or in ``pos_chunk``-wide slices added to the
    running sum in place (K2's p0 / acc, as the streamed upload does)."""
    P = idx.shape[1]
    if pos_chunk is None or pos_chunk >= P:
        return indexed_inner_product(idx, table, p_u32, pinv_u32)
    if P % pos_chunk:
        raise ValueError(f"pos_chunk {pos_chunk} does not divide P = {P}")
    acc = None
    for p0 in range(0, P, pos_chunk):
        acc = indexed_inner_product(idx[:, p0 : p0 + pos_chunk], table, p_u32, pinv_u32,
                                    p0, acc)
    return acc


def _limb_block(L: int, tp: int, what: str) -> int:
    if L % tp:
        raise ValueError(f"{what}: {L} limbs do not split over tp = {tp}")
    return L // tp


def sharded_pie_step(ctx: BGVContext, mesh: Mesh, leveled: bool = False,
                     n_hash: int | None = None, pos_chunk: int | None = None):
    """The batched PIE online step over the (dp, tp) mesh. ``leveled`` must
    match the (BGV) PIE's own setting; with it pass ``n_hash`` (the result
    then has L - (n_hash - 1) limbs, which must split over tp too).

    Per query a rank sends its limbs of the position sums and of minus over
    tp; the mask and the relin key, the server's constants, are gathered on
    the first query and kept while later queries pass the same tensors
    (every rank of a tp group must pass the same ones).

    fn(idx, minus, table, mask, rlk_b, rlk_a) -> this rank's
    (D/dp, 2, L'/tp, N) block of the result."""
    sh = pie_shardings(mesh)
    tp, j = mesh.shape["tp"], mesh.index["tp"]
    Ll = _limb_block(ctx.L, tp, "the input")
    L_out = ctx.L
    if leveled:
        if n_hash is None:
            raise ValueError("leveled sharded_pie_step needs n_hash")
        L_out = ctx.L - (n_hash - 1)
        ctx.context_for_limbs(L_out)  # the drop-limb chain, before the first query
    Lo = _limb_block(L_out, tp, "the result")
    p_u32 = ctx.p_u32[j * Ll : (j + 1) * Ll].contiguous()
    pinv_u32 = ctx.pinv_u32[j * Ll : (j + 1) * Ll].contiguous()
    group = mesh.groups["tp"]
    kept = {}  # the server's constants gathered over tp: name -> (shard, version, gathered)

    def limbs(x):
        return comm.all_gather(x, x.dim() - 2, group)

    def constant(name, x):
        """``x`` gathered over tp once, and again only when a query passes
        another tensor (or this one was written to)."""
        if name not in kept or kept[name][0] is not x or kept[name][1] != x._version:
            kept[name] = (x, x._version, limbs(x))
        return kept[name][2]

    def step(idx, minus, table, mask, rlk_b, rlk_a):
        ip = _position_sum(idx, table, p_u32, pinv_u32, pos_chunk)  # (H, D/dp, 2, L/tp, N)
        rlk = RelinKey(b_mont=constant("rlk_b", rlk_b), a_mont=constant("rlk_a", rlk_a))
        ct = combine_ip(ctx, rlk, limbs(ip), limbs(minus), constant("mask", mask),
                        leveled=leveled)
        return ct.data[..., j * Lo : (j + 1) * Lo, :].contiguous()

    return step, sh


def sharded_simple_pie_step(pie, mesh: Mesh):
    """SimpleFHE's online step split over pies (outer cells) on the whole
    mesh, flattened: each rank answers the index ciphertexts of its slice
    of pies locally, in the PIE's own chunks of pies
    (``SimpleFHEPIE.CHUNK_BYTES``); no collective. The step keeps copies of
    the rank's slices of the table, masks and hash-function orders on the
    rank's device, the Galois keys and the selectors, and no reference to
    ``pie``: once the caller drops the PIE, the rank holds 1/ranks of the
    table.

    fn(idx) -> this rank's (nPies/ranks, H, 2, L, N) block of the results."""
    pies = mesh.axis_names
    i, k = mesh.coordinate(pies)
    if pie.n_pies % k:
        raise ValueError(f"{pie.n_pies} pies do not split over {k} ranks")
    c = pie.n_pies // k
    own = slice(i * c, (i + 1) * c)
    dev = mesh.device
    table, mask, hf_perm = (t[own].to(dev, copy=True)
                            for t in (pie.table_pt, pie.mask_pt, pie.hf_perm))
    ctx, gks, sel_pt, chunk = pie.ctx, pie.gks, pie.sel_pt, pie._pie_chunk()
    sh = dict(idx=(pies, None, None, None, None), table=(pies, None, None, None, None),
              mask=(pies, None, None, None), out=(pies, None, None, None, None))

    def step(idx):
        outs = [answer_pies(ctx, gks, sel_pt, idx[s : s + chunk], table[s : s + chunk],
                            mask[s : s + chunk], hf_perm[s : s + chunk]).data
                for s in range(0, c, chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return step, sh


def sp_sharded_pie_step(ctx: BGVContext, mesh: Mesh, axis: str = "sp",
                        pos_chunk: int | None = None):
    """The batched PIE online step with the ring axis sharded over ``axis``:
    every tensor keeps a block of n/D coefficients. The position sums, the
    masked minus-element, the tensor products and the gadget digits are
    local; each NTT of the relinearisation, and for BFV each of the HPS
    product's q- and aux-base transforms, is the ring-exchange NTT, as in
    the JAX package. Flat full-basis product only (no leveled mode).

    fn(idx, minus, table, mask, rlk_b, rlk_a) -> this rank's
    (D_depth, 2, L, n/D) block; its form and scale: ``sp_result_form_scale``."""
    D = mesh.shape[axis]
    group, dev = mesh.groups[axis], mesh.device
    fwd_l, inv_l = ring_ntt_local_fns(ctx.plan, group, D, dev)
    p, pinv, r2 = ctx.p, ctx.pinv, ctx.r2
    is_bfv = ctx.default_form == "bfv"
    if is_bfv:
        mc = ctx.mulconv
        fwd_aux, inv_aux = ring_ntt_local_fns(mc.plan_aux, group, D, dev)
        ta = mc.plan_aux.tensors(dev)

    def relin_local(d0, d1, d2, rb, ra):
        dk = inv_l(d2)[..., :, None, :]                     # (..., L_dig, 1, Nloc)
        big = dk > ctx.q_half[:, None, :]
        r = cond_sub_mod(dk, p[None])                       # (..., L_dig, L, Nloc)
        dig = fwd_l(torch.where(big, sub_mod(r, ctx.qk_mod_qj, p[None]), r))
        ks0 = modsum(mont_mul(dig, rb, p, pinv), p, axis=-3)
        ks1 = modsum(mont_mul(dig, ra, p, pinv), p, axis=-3)
        return add_mod(d0, ks0, p), add_mod(d1, ks1, p)

    def hps_mul_local(a, b):
        """HPS ct x ct: the base conversions are pointwise per coefficient
        (local); the q- and aux-base transforms are distributed."""
        ea = fwd_aux(mc.extend_q_to_aux(inv_l(a)))
        eb = fwd_aux(mc.extend_q_to_aux(inv_l(b)))
        d_q = tensor_product(a, b, p, pinv, r2)
        d_aux = tensor_product(ea, eb, ta["p"], ta["pinv"], ta["r2"])
        y = mc.scale_round(inv_l(d_q), inv_aux(d_aux))
        return fwd_l(mc.exact_to_q(y))                       # (..., 3, L, Nloc)

    def step(idx, minus, table, mask, rb, ra):
        H = idx.shape[0]
        ip = _position_sum(idx, table, ctx.p_u32, ctx.pinv_u32, pos_chunk)
        acc = add_mod(ip[0], mont_mul(minus[None], mask[:, None], p, pinv), p)
        for h in range(1, H):
            op = add_mod(ip[h], minus[None], p)
            d = hps_mul_local(acc, op) if is_bfv else tensor_product(acc, op, p, pinv, r2)
            k0, k1 = relin_local(d[..., 0, :, :], d[..., 1, :, :], d[..., 2, :, :], rb, ra)
            acc = torch.stack([k0, k1], dim=-3)
        return acc

    def s(nd):  # the trailing (coefficient) axis sharded
        return (None,) * (nd - 1) + (axis,)

    return step, dict(idx=s(5), minus=s(3), table=s(5), mask=s(3), rlk=s(3), out=s(4))


def pp_pipelined_pie_step(ctx: BGVContext, mesh: Mesh, axis: str = "pp",
                          leveled: bool = False, n_hash: int | None = None):
    """The batched PIE online step pipelined over a ring of k ranks: each
    holds 1/k of the positions of the table and of the index ciphertexts.
    At step s rank e sums its positions for depth chunk g = (e - s - 1) mod
    k (K2 reading that chunk of the table in place) while the running sum
    of that chunk arrives from its left neighbour; the two meet in an add.
    The hop is started before the chunk's K2 launch and waited for after
    it. After k steps rank e holds the whole position sum of depth chunk e
    and runs ``combine_ip`` on it. P % k and D % k must be 0; a rank sends
    (k - 1) * H * (D/k) * 2 * L * N * 4 bytes per query.

    fn(idx, minus, table, mask, rlk_b, rlk_a) -> this rank's (D/k, 2, L', N)
    block of the result (form and scale as ``batched_pie_forward``'s)."""
    k, e, group = mesh.shape[axis], mesh.index[axis], mesh.groups[axis]
    ring = [(i, (i + 1) % k) for i in range(k)]
    if leveled and n_hash:
        ctx.context_for_limbs(ctx.L - (n_hash - 1))  # the drop-limb chain, before the first query

    def step(idx, minus, table, mask, rb, ra):
        D = table.shape[1]
        if D % k:
            raise ValueError(f"D = {D} depths do not split over {k} ranks")
        Dl = D // k
        acc = None
        for s in range(k):
            g = (e - s - 1) % k
            tbl_g = table[:, g * Dl : (g + 1) * Dl]
            if acc is None:
                acc = indexed_inner_product(idx, tbl_g, ctx.p_u32, ctx.pinv_u32)
                continue
            hop = comm.ppermute_start(acc, ring, group)
            part = indexed_inner_product(idx, tbl_g, ctx.p_u32, ctx.pinv_u32)
            acc = add_mod(hop.wait(), part, ctx.p)
        ct = combine_ip(ctx, RelinKey(b_mont=rb, a_mont=ra), acc, minus, mask, leveled=leveled)
        return ct.data

    rep = (None, None, None)
    sh = dict(idx=(None, axis, None, None, None), minus=rep, table=(None, None, axis, None, None),
              mask=(axis, None, None), rlk=rep, out=(axis, None, None, None))
    return step, sh


def sp_result_form_scale(ctx: BGVContext, n_hash: int) -> tuple[str, int]:
    """(form, scale) of sp_sharded_pie_step's result, as batched_pie_forward
    tracks them (BFV operands multiply by HPS, which keeps the form and the
    unit message scale)."""
    return ctx.default_form, 1
