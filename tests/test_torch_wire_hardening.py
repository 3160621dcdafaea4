"""Untrusted-wire hardening of the port: the counterpart of
``tests/test_wire_hardening.py``, test for test, on
``nested_hashing_psi_tpu_torch.protocol.channel`` and ``fhe.params``.
Malformed frames and hostile parameters are rejected with raised errors
(never asserts), allocations are bounded, and the HEStd_128 bound is
enforced for every tabled ring dimension.

``test_rejections_equal_the_jax_package`` then holds each hostile frame and
each rejected parameter tuple below against both packages: the same
exception class and the same message.
"""

import re
import socket
import struct

import numpy as np
import pytest

from nested_hashing_psi_tpu.fhe import params as j_params
from nested_hashing_psi_tpu.protocol import channel as j_channel
from nested_hashing_psi_tpu_torch.fhe import params as t_params
from nested_hashing_psi_tpu_torch.fhe.params import (
    MAX_LOG_Q_128,
    SchemeParams,
    validate_wire_scheme_params,
)
from nested_hashing_psi_tpu_torch.protocol import channel as t_channel
from nested_hashing_psi_tpu_torch.protocol.channel import (
    MAX_MSG_BYTES,
    TCPChannel,
    WireFormatError,
    tensor_from_bytes,
    tensor_to_bytes,
)

T_PROD = (1 << 32) + (1 << 20) + (1 << 19) + 1


def _header(dt: bytes = b"<u4") -> bytes:
    return struct.pack("<4sB", b"NHP1", len(dt)) + dt


def _bad_magic() -> bytes:
    buf = bytearray(tensor_to_bytes(np.zeros(3, np.uint32)))
    buf[:4] = b"EVIL"
    return bytes(buf)


def _dtype_frame(dt: bytes) -> bytes:
    return _header(dt) + struct.pack("<B", 1) + struct.pack("<q", 1) + b"\x00" * 8


_GOOD = tensor_to_bytes(np.zeros(4, np.uint32))

# (frame, match): every hostile frame of tests/test_wire_hardening.py
HOSTILE_FRAMES = {
    "bad_magic": (_bad_magic(), "magic"),
    "dtype_object": (_dtype_frame(b"|O8"), "dtype"),
    "dtype_float64": (_dtype_frame(b"<f8"), "dtype"),
    "dtype_uint16": (_dtype_frame(b"<u2"), "dtype"),
    "payload_long": (_GOOD + b"\x00\x00", "payload"),
    "payload_short": (_GOOD[:-2], "payload"),
    "negative_dim": (_header() + struct.pack("<B", 1) + struct.pack("<q", -4), "negative"),
    "absurd_rank": (_header() + struct.pack("<B", 200) + b"\x00" * 1600, "rank"),
    "short_frame": (b"NH", None),  # any WireFormatError
}

# (ring, t, limbs, scheme, match): the rejected peer-supplied parameters
WIRE_REJECTIONS = [
    (12345, 65537, 4, "bfv", "ring"),          # non-power-of-two
    (1 << 20, 65537, 4, "bfv", "ring"),        # unsupported size
    (16384, 65537, 100, "bfv", "limb"),        # resource exhaustion
    (16384, 65537, 0, "bfv", "limb"),
    (16384, 65536, 4, "bfv", "NTT-friendly"),  # t-1 not divisible by 2n
    (16384, 1 << 55, 4, "bfv", "range"),       # oversized t
    (16384, 65537, 4, "ckks", "scheme"),
]


def _too_many_limbs(ring: int) -> int:
    return MAX_LOG_Q_128[ring] // 31 + 2


def test_tensor_roundtrip_ok():
    for arr in (
        np.arange(12, dtype=np.uint32).reshape(3, 4),
        np.array([1, 2], np.uint64),
        np.array([-5], np.int64),
        np.frombuffer(b"\x01\x02", dtype=np.uint8),
    ):
        out = tensor_from_bytes(tensor_to_bytes(arr))
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype


def test_bad_magic_rejected():
    with pytest.raises(WireFormatError, match="magic"):
        tensor_from_bytes(_bad_magic())


def test_disallowed_dtype_rejected():
    for dt in (b"|O8", b"<f8", b"<u2"):
        with pytest.raises(WireFormatError, match="dtype"):
            tensor_from_bytes(_dtype_frame(dt))


def test_payload_size_mismatch_rejected():
    with pytest.raises(WireFormatError, match="payload"):
        tensor_from_bytes(_GOOD + b"\x00\x00")
    with pytest.raises(WireFormatError, match="payload"):
        tensor_from_bytes(_GOOD[:-2])


def test_hostile_shape_rejected():
    for key in ("negative_dim", "absurd_rank", "short_frame"):
        frame, match = HOSTILE_FRAMES[key]
        with pytest.raises(WireFormatError, match=match):
            tensor_from_bytes(frame)


def _oversized_prefix_read(channel_mod):
    """Read one message whose length prefix exceeds MAX_MSG_BYTES through
    ``channel_mod``'s TCPChannel on a localhost connection."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    a = socket.create_connection(("127.0.0.1", port), timeout=5)
    b, _ = srv.accept()
    srv.close()
    try:
        ch = channel_mod.TCPChannel(b)
        a.sendall(struct.pack("<Q", channel_mod.MAX_MSG_BYTES + 1))
        ch.read_msg()
    finally:
        a.close()
        b.close()


def test_tcp_oversized_length_prefix_rejected():
    assert t_channel.TCPChannel is TCPChannel and t_channel.MAX_MSG_BYTES == MAX_MSG_BYTES
    with pytest.raises(WireFormatError, match="length"):
        _oversized_prefix_read(t_channel)


def test_wire_scheme_params_accepts_production():
    sp = validate_wire_scheme_params(16384, T_PROD, 7, "bfv")
    assert sp.ring_dim == 16384 and sp.num_limbs == 7


@pytest.mark.parametrize("ring,t,limbs,scheme,match", WIRE_REJECTIONS)
def test_wire_scheme_params_rejections(ring, t, limbs, scheme, match):
    with pytest.raises(ValueError, match=match):
        validate_wire_scheme_params(ring, t, limbs, scheme)


def test_hestd_enforced_for_all_tabled_ring_dims():
    """An oversized limb count refuses to run at every tabled ring dim."""
    for ring in MAX_LOG_Q_128:
        too_many = _too_many_limbs(ring)
        if ring >= 1024:
            with pytest.raises(ValueError, match="128-bit"):
                validate_wire_scheme_params(ring, 65537, too_many, "bgv")
        sp = SchemeParams(ring_dim=ring, plaintext_modulus=65537, num_limbs=too_many)
        with pytest.raises(ValueError, match="128-bit"):
            sp.validate_security()
        sp.validate_security(allow_insecure=True)  # explicit escape only


def _raised(fn) -> BaseException:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what the test compares
        return e
    raise AssertionError("no exception")


def _cases():
    for key, (frame, match) in HOSTILE_FRAMES.items():
        yield pytest.param(lambda m, f=frame: m[0].tensor_from_bytes(f), match, id=key)
    yield pytest.param(lambda m: _oversized_prefix_read(m[0]), "length", id="tcp_length_prefix")
    for ring, t, limbs, scheme, match in WIRE_REJECTIONS:
        yield pytest.param(lambda m, args=(ring, t, limbs, scheme):
                           m[1].validate_wire_scheme_params(*args), match,
                           id=f"wire_{ring}_{t}_{limbs}_{scheme}")
    for ring in MAX_LOG_Q_128:
        yield pytest.param(lambda m, r=ring: m[1].validate_wire_scheme_params(
            r, 65537, _too_many_limbs(r), "bgv"), "128-bit", id=f"hestd_wire_{ring}")
        yield pytest.param(lambda m, r=ring: m[1].SchemeParams(
            ring_dim=r, plaintext_modulus=65537, num_limbs=_too_many_limbs(r)
        ).validate_security(), "128-bit", id=f"hestd_security_{ring}")


@pytest.mark.parametrize("call,match", _cases())
def test_rejections_equal_the_jax_package(call, match):
    port = _raised(lambda: call((t_channel, t_params)))
    jax_side = _raised(lambda: call((j_channel, j_params)))
    assert type(port).__name__ == type(jax_side).__name__
    assert type(port).__mro__[1].__name__ == type(jax_side).__mro__[1].__name__
    assert str(port) == str(jax_side)
    for e in (port, jax_side):
        assert isinstance(e, ValueError)
        assert match is None or re.search(match, str(e)), (match, str(e))
