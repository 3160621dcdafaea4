"""The server's offline artifact: save a BatchedFHEPIE and resume it later,
in a fresh process, without rebuilding the nested table or re-encoding it.

Counterpart of ``nested_hashing_psi_tpu.utils.checkpoint``, in its v3 .npz
format key for key: ``version``, ``table_pt`` (the logical (H, D, P, L, N)
table, masks folded into hash 0), ``mask_pt`` (D, L, N), ``dims`` (8 x
int64: H, D, P, batch slots, leveled, mul_limbs, ship_limbs, host-resident;
-1 for a pipeline base resolved to None), ``scheme`` (4 x uint64: ring, t,
limbs, 1 for BGV) and the relinearisation key ``rlk_b``, ``rlk_a``. Residues
are stored as uint32, the JAX package's dtype (the port holds the same bits
as int32), so a file written by either package resumes in the other and
answers a query bit for bit as the PIE that wrote it.
"""

from __future__ import annotations

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.convert import relin_key_from_numpy, to_numpy
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.pie.batched_fhe import BatchedFHEPIE
from nested_hashing_psi_tpu_torch.utils.device import resolve_device

# v3: table_pt carries the per-depth masks folded into hash function 0's
# plaintexts; v2 tables are unfolded and v1 files lack the scheme and key,
# so loads reject both.
FORMAT_VERSION = 3
# A file whose dims lack the residency flag (early v3) resumes host-resident
# above this table size, the JAX package's rule (not the 5 GB build rule of
# protocol.batched_fhe.HOST_TABLE_BYTES).
HOST_RESIDENT_BYTES = 12 << 30


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 residues -> the uint32 array of the same bits. A CPU tensor is
    viewed in place (a strided view stays strided; np.savez writes it in
    chunks), a device tensor copied to the host."""
    if t.device.type == "cpu":
        return t.detach().numpy().view(np.uint32)
    return to_numpy(t)


def _i32(a: np.ndarray, key: str) -> torch.Tensor:
    """A file's uint32 residues -> int32 CPU tensor of the same bits (no copy)."""
    if a.dtype != np.uint32:
        raise ValueError(f"checkpoint array {key!r} holds {a.dtype}, not uint32 residues")
    return torch.from_numpy(a.view(np.int32))


def save_batched_pie(path: str, pie: BatchedFHEPIE) -> None:
    """Write the PIE's offline products, scheme parameters and relin key to
    exactly ``path`` (no suffix appended). Uncompressed on purpose: the
    table is NTT-domain residues, which zlib barely shrinks, and compressing
    a table of many GB costs minutes of one core each way against disk
    speed. A host-resident table is written from its logical view of the
    position-major storage, in chunks, without a contiguous copy."""
    sp = pie.ctx.params
    with open(path, "wb") as f:
        np.savez(
            f,
            version=FORMAT_VERSION,
            table_pt=_u32(pie.logical_table()),
            mask_pt=_u32(pie.mask_pt),
            dims=np.array(
                [
                    pie.H, pie.D, pie.P, pie.batch_slots, int(pie.leveled),
                    -1 if pie.mul_limbs is None else pie.mul_limbs,
                    -1 if pie.ship_limbs is None else pie.ship_limbs,
                    int(pie.host_table),
                ],
                np.int64,
            ),
            scheme=np.array(
                [sp.ring_dim, sp.plaintext_modulus, sp.num_limbs,
                 1 if sp.scheme == "bgv" else 0],
                np.uint64,
            ),
            rlk_b=_u32(pie.rlk_b),
            rlk_a=_u32(pie.rlk_a),
        )


def load_batched_pie(path: str, ctx=None, rlk=None, *, device="cuda") -> BatchedFHEPIE:
    """A runnable BatchedFHEPIE from a checkpoint written by either package.

    ``ctx`` and ``rlk`` default to the file's scheme parameters and relin
    key, so a resume needs nothing but the file; the context is then built
    on ``device``, which defaults to the GPU and raises without one
    (``device="cpu"`` runs the plain versions). A given ``ctx`` must be on
    ``device``. The table resumes device- or host-resident as saved (dims[7];
    without it, host-resident above HOST_RESIDENT_BYTES), and the rescaled
    pipeline exactly as saved: a flat PIE (mul_limbs = 0) stays flat."""
    device = resolve_device(device)
    if ctx is not None and ctx.device.type != device.type:
        raise ValueError(f"the given context is on {ctx.device}, not on {device}")
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint format version {version} "
                f"(this build reads version {FORMAT_VERSION}; v1 checkpoints "
                f"lack the embedded scheme params/relin key -- rebuild the "
                f"offline artifact with save_batched_pie)"
            )
        if ctx is None:
            ring, t, limbs, is_bgv = (int(v) for v in z["scheme"])
            ctx = make_context(
                SchemeParams(ring_dim=ring, plaintext_modulus=t, num_limbs=limbs,
                             scheme="bgv" if is_bgv else "bfv"),
                seed=None, device=device,
            )
        if rlk is None:
            rlk = relin_key_from_numpy(z["rlk_b"], z["rlk_a"], ctx.device)
        dims = [int(v) for v in z["dims"]]
        table = z["table_pt"]
        mask = z["mask_pt"]
    H, D, P, batch_slots = dims[:4]
    if len(dims) > 7:
        host_table = bool(dims[7])
    else:
        host_table = table.nbytes > HOST_RESIDENT_BYTES
    mul_limbs = ship_limbs = None
    if len(dims) > 6:
        # -1 is "resolved to None": None again for ship_limbs, 0 (the flat
        # product, not the auto pipeline) for mul_limbs
        mul_limbs = 0 if dims[5] < 0 else dims[5]
        ship_limbs = None if dims[6] < 0 else dims[6]
    return BatchedFHEPIE.from_artifact(
        ctx, rlk, _i32(table, "table_pt"), _i32(mask, "mask_pt"), H, D, P, batch_slots,
        leveled=bool(dims[4]) if len(dims) > 4 else False,
        mul_limbs=mul_limbs, ship_limbs=ship_limbs, host_table=host_table,
    )
