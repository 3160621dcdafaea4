"""State carried between the JAX package and the port, as numpy arrays.

Residues are uint32 in the JAX package and on the wire, int32 (same bits,
values in [0, p) < 2**31) in the port. These helpers move keys (secret,
relin and Galois), ciphertexts (with their form and scale) and both PIEs'
tables across in both directions, so both packages can compute on the same
keys and tables. ``send`` and ``receive`` are the one place where a tensor
becomes a wire frame and a frame a tensor, each inside its span
(``wire.pack``, ``wire.unpack``), whose ``counts["host_copies"]`` is the
number of copies of the payload the host's CPU made for the frame.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, RelinKey, SecretKey
from nested_hashing_psi_tpu_torch.protocol.channel import Channel, frame_header, tensor_from_bytes
from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

# A frame written in place starts its payload this aligned in its buffer.
_PAYLOAD_ALIGN = 16

# A received frame is a read-only view of its bytes, which ``_upload`` only
# reads through torch's copy.
warnings.filterwarnings("ignore", "The given NumPy array is not writable", UserWarning)


def from_numpy(a, device) -> torch.Tensor:
    """uint32 (or any integer array of residues < 2**31) -> int32 tensor."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype != np.uint32:
        a = a.astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _upload(a, device, non_blocking: bool) -> torch.Tensor:
    """A frame's array on ``device`` where its payload is not page-locked
    (bytes from a socket or a JAX channel); for a GPU through a page-locked
    buffer of torch's caching host allocator, which the next frame of that
    size reuses (a fresh pageable copy is mapped and faulted in every time),
    filled by torch's copy on every intra-op thread (a 72 MiB frame in 4.2
    ms against 10.5 ms for numpy's one thread on an 8-core H100 host), with
    ``non_blocking`` enqueued on the current stream without waiting."""
    device = torch.device(device)
    if device.type != "cuda":
        return from_numpy(a, device)
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    host = torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(torch.from_numpy(a.view(np.int32)))
    return host.to(device, non_blocking=non_blocking)


def _download(t: torch.Tensor) -> np.ndarray:
    """``to_numpy`` for a frame bound for a channel that takes only bytes;
    a GPU tensor through a page-locked buffer of torch's caching host
    allocator, reused as in ``_upload``."""
    if t.device.type != "cuda":
        return to_numpy(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy().view(np.uint32)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> uint32 numpy array (the wire dtype)."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def _frame_in_place(t: torch.Tensor) -> np.ndarray:
    """The frame of residue tensor ``t``, written in one buffer of torch's
    host allocator, page-locked for a GPU tensor (the caching allocator's:
    the next frame of its size reuses it once the uploads from it are
    done): the header, then the payload, 16-byte aligned behind a pad that
    stays out of the frame, copied from ``t`` in one copy into a contiguous
    int32 view (for a GPU one download, no copy by the host's CPU). ->
    the frame, a 1-D uint8 array whose ``base`` is a tensor over exactly
    its bytes."""
    header = frame_header(np.uint32, tuple(t.shape))
    pad = -len(header) % _PAYLOAD_ALIGN
    start = pad + len(header)
    buf = torch.empty(start + 4 * t.numel(), dtype=torch.uint8, pin_memory=t.is_cuda)
    frame = buf[pad:].numpy()
    frame[: len(header)] = np.frombuffer(header, np.uint8)
    buf[start:].view(torch.int32).view(t.shape).copy_(t)
    return frame


def _pinned_payload(frame, a: np.ndarray):
    """The payload of a uint32 frame that ``_frame_in_place`` wrote in
    page-locked memory, as the int32 tensor over it (its storage is the
    caching allocator's, so an upload from it holds the buffer until it is
    done); None for any other frame."""
    host = getattr(frame, "base", None)
    if not (isinstance(host, torch.Tensor) and a.dtype == np.uint32 and host.is_pinned()):
        return None
    return host[len(frame) - a.nbytes :].view(torch.int32).view(a.shape)


def send(channel, x) -> None:
    """One frame on ``channel``: a residue tensor (any device) as uint32, or
    a host array (a parameter or meta vector) as it is. A GPU tensor bound
    for one of the port's channels is written in place in page-locked
    memory and carried as it is; any other frame is joined into bytes (one
    host copy)."""
    with TRACER.span("wire.pack", nbytes=x.nbytes) as span:
        in_place = isinstance(x, torch.Tensor) and x.is_cuda and isinstance(channel, Channel)
        if in_place:
            channel.write_msg(_frame_in_place(x))
        else:
            channel.write_tensor(_download(x) if isinstance(x, torch.Tensor) else x)
        if span is not None:
            span.counts = {"host_copies": 0 if in_place else 1}


def receive(channel, device=None, non_blocking: bool = False):
    """The next frame of ``channel``: an int32 tensor on ``device`` (a GPU's
    upload waited for, or with ``non_blocking`` only enqueued), or with no
    device the host array as it came. A GPU uploads a page-locked frame's
    payload straight from it; any other payload is copied once on the host
    first."""
    with TRACER.span("wire.unpack") as span:
        if isinstance(channel, Channel):
            frame = channel.read_msg()
            a = tensor_from_bytes(frame)
        else:
            frame, a = None, channel.read_tensor()
        pinned = None
        if device is not None and torch.device(device).type == "cuda":
            pinned = _pinned_payload(frame, a)
        if device is None:
            out, copies = a, 0
        elif pinned is not None:
            out, copies = pinned.to(device, non_blocking=non_blocking), 0
        else:
            out, copies = _upload(a, device, non_blocking), 1
        if span is not None:
            span.nbytes, span.counts = a.nbytes, {"host_copies": copies}
        return out


def secret_key_from_numpy(s_mont, s_ntt, device) -> SecretKey:
    return SecretKey(s_mont=from_numpy(s_mont, device), s_ntt=from_numpy(s_ntt, device))


def secret_key_to_numpy(sk: SecretKey) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(sk.s_mont), to_numpy(sk.s_ntt)


def relin_key_from_numpy(b_mont, a_mont, device) -> RelinKey:
    return RelinKey(b_mont=from_numpy(b_mont, device), a_mont=from_numpy(a_mont, device))


def relin_key_to_numpy(rlk: RelinKey) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(rlk.b_mont), to_numpy(rlk.a_mont)


def ciphertext_from_numpy(data, device, form: str = "bfv", scale: int = 1) -> Ciphertext:
    return Ciphertext(from_numpy(data, device), form, scale)


def ciphertext_to_numpy(ct: Ciphertext) -> tuple[np.ndarray, str, int]:
    """(data, form, scale): a BGV-form ciphertext keeps its mod-t scale."""
    return to_numpy(ct.data), ct.form, int(ct.scale)


def galois_keys_from_numpy(keys: dict, device) -> dict[int, RelinKey]:
    """{Galois element: (b_mont, a_mont)} -> {element: RelinKey}."""
    return {int(k): relin_key_from_numpy(b, a, device) for k, (b, a) in keys.items()}


def galois_keys_to_numpy(gks: dict[int, RelinKey]) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    return {int(k): relin_key_to_numpy(g) for k, g in gks.items()}


def pie_tables_to_numpy(pie) -> tuple[np.ndarray, np.ndarray]:
    """(table_pt, mask_pt) of a port BatchedFHEPIE as uint32 arrays."""
    return to_numpy(pie.table_pt), to_numpy(pie.mask_pt)


def load_pie_tables(pie, table_pt, mask_pt) -> None:
    """Overwrite a port BatchedFHEPIE's packed table and masks with the given
    (e.g. the JAX package's) uint32 arrays, in place (a host-resident table
    keeps its host layout)."""
    pie.table_pt.copy_(from_numpy(table_pt, pie.table_pt.device))
    pie.mask_pt.copy_(from_numpy(mask_pt, pie.mask_pt.device))


def simple_pie_tables_to_numpy(pie) -> tuple[np.ndarray, ...]:
    """(table_pt, sel_pt, mask_pt, hf_perm) of a port SimpleFHEPIE: the
    plaintexts as uint32 arrays, the hash-function permutation as int64."""
    return (to_numpy(pie.table_pt), to_numpy(pie.sel_pt), to_numpy(pie.mask_pt),
            pie.hf_perm.cpu().numpy())


def load_simple_pie_tables(pie, table_pt, sel_pt, mask_pt, hf_perm) -> None:
    """Overwrite a port SimpleFHEPIE's tables with the given (e.g. the JAX
    package's) arrays, in place."""
    for buf, arr in ((pie.table_pt, table_pt), (pie.sel_pt, sel_pt), (pie.mask_pt, mask_pt)):
        buf.copy_(from_numpy(arr, buf.device))
    pie.hf_perm.copy_(torch.from_numpy(np.asarray(hf_perm, np.int64)))
