"""Party-to-party transport.

The port's own copy of ``nested_hashing_psi_tpu.protocol.channel``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Replaces libscapi's CommPartyTCPSynced (length-prefixed synchronized TCP with
byte counters; reference usage src/Server/PSIServer.hpp:31-49).
Two implementations:
 - TCPChannel: blocking sockets, 8-byte little-endian length prefix, join
   retries like the reference's channel->join(500, 5000000).
 - LoopbackChannel: in-process queue pair so client+server can run in two
   threads of one test process (the reference needs two OS processes).

Tensor serialization is a minimal versioned framing of numpy buffers --
ciphertexts are uint32 limb tensors, so one message = one dense array. A
message is ``bytes`` or a 1-D uint8 numpy array holding the same bytes (a
frame written in place, ``convert.send``), which ``LoopbackChannel``
carries by reference and ``TCPChannel`` writes as it is.

A read's span ``wire.wait`` (``utils.profiling.TRACER``) holds the time it
blocks for the peer: the loopback queue's ``get``, or a TCP read until the
length prefix is in.
"""

from __future__ import annotations

import queue
import socket
import struct
import time

import numpy as np

from nested_hashing_psi_tpu_torch.utils.profiling import TRACER

_MAGIC = b"NHP1"

# The wire carries exactly these element types (ciphertext limb tensors,
# parameter/meta vectors, compressed EC point bytes). Anything else from the
# peer is rejected -- np.dtype() on an arbitrary wire string is an attack
# surface (object dtypes, huge itemsizes).
_ALLOWED_DTYPES = ("<u4", "<u8", "<i8", "|u1")
_MAX_NDIM = 8
# Default hard ceiling on a single message. The largest legitimate frame is
# a whole-query index-ciphertext upload (~1.5 GB at the Parameters1.txt
# 2^28 x 4096 geometry with 48-bit items); 2 GiB bounds the allocation an
# untrusted length prefix can force while clearing every real frame.
# Channels accept a per-instance override (max_msg_bytes=) for exotic sizes.
MAX_MSG_BYTES = 1 << 31


class WireFormatError(ValueError):
    """Malformed or out-of-policy data from the peer (never an assert: the
    wire is untrusted input and must fail loudly under python -O too)."""


def frame_header(dtype, shape) -> bytes:
    """The header of the frame of an array of ``dtype`` and ``shape``: the
    magic, the dtype string with its length, the rank and the dims; the
    payload follows it. ``tensor_to_bytes`` and a frame written in place
    (``convert.send``) both write it."""
    dt = np.dtype(dtype).str.encode()
    return struct.pack(f"<4sB{len(dt)}sB{len(shape)}q", _MAGIC, len(dt), dt, len(shape), *shape)


def tensor_to_bytes(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    header = frame_header(arr.dtype, arr.shape)
    return b"".join((header, arr.reshape(-1).view(np.uint8)))  # one copy of the payload


def _is_frame(msg) -> bool:
    """A message the port's channels carry: bytes, or a 1-D uint8 array."""
    return isinstance(msg, bytes) or (
        isinstance(msg, np.ndarray) and msg.dtype == np.uint8 and msg.ndim == 1)


def tensor_from_bytes(buf) -> np.ndarray:
    """The array a frame holds, a view of ``buf`` (``bytes`` or a 1-D uint8
    array)."""
    if len(buf) < 6:
        raise WireFormatError(f"tensor frame too short ({len(buf)} bytes)")
    magic, dt_len = struct.unpack_from("<4sB", buf, 0)
    if magic != _MAGIC:
        raise WireFormatError(f"bad tensor frame magic {magic!r}")
    off = 5
    if len(buf) < off + dt_len + 1:
        raise WireFormatError("truncated tensor frame header")
    dt = bytes(buf[off : off + dt_len]).decode("ascii", errors="replace")
    if dt not in _ALLOWED_DTYPES:
        raise WireFormatError(f"disallowed wire dtype {dt!r}")
    off += dt_len
    (ndim,) = struct.unpack_from("<B", buf, off)
    if ndim > _MAX_NDIM:
        raise WireFormatError(f"tensor rank {ndim} exceeds limit {_MAX_NDIM}")
    off += 1
    if len(buf) < off + 8 * ndim:
        raise WireFormatError("truncated tensor frame shape")
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    if any(s < 0 for s in shape):
        raise WireFormatError(f"negative dimension in wire shape {shape}")
    off += 8 * ndim
    dtype = np.dtype(dt)
    count = 1
    for s in shape:
        count *= s
    if len(buf) - off != count * dtype.itemsize:
        raise WireFormatError(
            f"tensor payload size {len(buf) - off} does not match shape "
            f"{shape} of {dt}"
        )
    return np.frombuffer(buf, dtype=dtype, offset=off, count=count).reshape(shape)


class Channel:
    """Length-prefixed message channel with byte counters."""

    def __init__(self):
        self.bytes_in = 0
        self.bytes_out = 0

    def write_msg(self, payload) -> None:
        """Send one message: ``bytes`` or a 1-D uint8 array."""
        raise NotImplementedError

    def read_msg(self):
        raise NotImplementedError

    def write_tensor(self, arr) -> None:
        """Accepts numpy arrays or CPU tensors (the serialization boundary;
        the port sends device tensors through ``convert.send``)."""
        self.write_msg(tensor_to_bytes(np.asarray(arr)))

    def read_tensor(self) -> np.ndarray:
        return tensor_from_bytes(self.read_msg())

    def reset_counters(self) -> None:
        self.bytes_in = 0
        self.bytes_out = 0

    def close(self) -> None:
        pass


class _Poison:
    """Sentinel a failing party injects so its peer's blocking reads raise
    instead of waiting forever (a server-side exception must not deadlock an
    in-process client)."""


_POISON = _Poison()


class LoopbackChannel(Channel):
    """In-process channel: every frame crosses as the bytes TCP would carry,
    a frame written in place by reference (its buffer is the peer's once
    written). (The JAX package's option to pass device arrays by reference
    has no caller in the port and is left out.)"""

    def __init__(self, inbox: "queue.Queue", outbox: "queue.Queue"):
        super().__init__()
        self._inbox = inbox
        self._outbox = outbox

    @classmethod
    def pair(cls) -> tuple["LoopbackChannel", "LoopbackChannel"]:
        a: queue.Queue = queue.Queue()
        b: queue.Queue = queue.Queue()
        return cls(a, b), cls(b, a)

    def write_msg(self, payload) -> None:
        self.bytes_out += len(payload) + 8
        self._outbox.put(payload if isinstance(payload, np.ndarray) else bytes(payload))

    def poison(self) -> None:
        """Unblock the peer: its next read raises ConnectionError."""
        self._outbox.put(_POISON)

    def read_msg(self):
        with TRACER.span("wire.wait"):
            msg = self._inbox.get()
        if msg is _POISON:
            raise ConnectionError("peer failed (poisoned loopback channel)")
        if not _is_frame(msg):
            raise WireFormatError("unexpected in-process message type")
        self.bytes_in += len(msg) + 8
        return msg


class TCPChannel(Channel):
    """Blocking TCP with 8-byte length prefix.

    The reference's connection topology (PSIServer.hpp:31-38): server binds
    port+1 and connects to the client's port; here simply: server listens on
    `port`, client connects with retries.
    """

    def __init__(self, sock: socket.socket, max_msg_bytes: int = MAX_MSG_BYTES):
        super().__init__()
        self.max_msg_bytes = max_msg_bytes
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # blocking like the reference's synchronized channel: phases may
        # legitimately compute for minutes between messages
        self._sock.settimeout(None)

    @classmethod
    def listen(cls, ip: str, port: int, timeout: float = 600.0) -> "TCPChannel":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((ip, port))
        srv.listen(1)
        srv.settimeout(timeout)
        conn, _ = srv.accept()
        srv.close()
        return cls(conn)

    @classmethod
    def connect(
        cls, ip: str, port: int, retry_ms: int = 500, max_retries: int = 1200
    ) -> "TCPChannel":
        for _ in range(max_retries):
            try:
                s = socket.create_connection((ip, port), timeout=10)
                return cls(s)
            except OSError:
                time.sleep(retry_ms / 1000.0)
        raise ConnectionError(f"could not connect to {ip}:{port}")

    def write_msg(self, payload) -> None:
        # the prefix, then the message as it is: no joined copy of the payload
        self._sock.sendall(struct.pack("<Q", len(payload)))
        self._sock.sendall(payload)
        self.bytes_out += 8 + len(payload)

    def read_msg(self) -> bytes:
        with TRACER.span("wire.wait"):
            size_buf = self._read_exact(8)
        (size,) = struct.unpack("<Q", size_buf)
        if size > self.max_msg_bytes:
            # the length prefix is untrusted: never allocate from it blindly
            raise WireFormatError(
                f"message length {size} exceeds limit {self.max_msg_bytes}"
            )
        payload = self._read_exact(size)
        self.bytes_in += 8 + size
        return payload

    def _read_exact(self, count: int) -> bytes:
        chunks = []
        got = 0
        while got < count:
            chunk = self._sock.recv(min(count - got, 1 << 20))
            if not chunk:
                raise ConnectionError("channel closed")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
