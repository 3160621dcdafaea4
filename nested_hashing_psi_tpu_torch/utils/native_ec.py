"""ctypes loader + converters for the native EC backend (native/nhpsi_ec.cpp).

The port's own copy of ``nested_hashing_psi_tpu.utils.native_ec``, with the
same names and behaviour: the port imports nothing of the JAX package.
The source stays the repository's; g++ builds it into
``build/nhpsi_torch/`` (ignored by git), apart from the JAX package's
in-place build, through a temporary file and a rename
(``utils.native.build_and_load``).

Pure-Python fallback lives in crypto/ec.py; a missing toolchain degrades
performance, not capability. All batch calls take/return affine points as
(x, y) int tuples or None (infinity), matching EcGroup's representation
exactly -- the native backend implements the same group law, so results are
identical point-for-point.

Limb width is per-curve (4 for <=256-bit fields, 6 for P-384, 9 for P-521,
matching the reference's full prime-curve dispatch,
ElGamalPSIServer.hpp:32-46); every call passes n_limbs first and the wire
arrays are (n, 2*NL) / (n, NL) uint64.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from nested_hashing_psi_tpu_torch.utils.native import build_and_load

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "nhpsi_ec.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "nhpsi_torch", "libnhpsi_ec.so")

_lock = threading.Lock()
_lib = None
_tried = False

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = build_and_load(_SRC, _SO)
            lib.ec_mul_batch2.restype = ctypes.c_int
            lib.ec_mul_batch2.argtypes = [
                ctypes.c_int, _U64P, _U64P, ctypes.c_int, _U64P, _U8P, _U64P,
                ctypes.c_int64, _U64P, _U8P,
            ]
            lib.ec_multi_mul_batch2.restype = ctypes.c_int
            lib.ec_multi_mul_batch2.argtypes = [
                ctypes.c_int, _U64P, _U64P, ctypes.c_int64, ctypes.c_int64,
                _U64P, _U8P, _U64P, _U64P, _U8P,
            ]
            lib.ec_sum_batch2.restype = ctypes.c_int
            lib.ec_sum_batch2.argtypes = [
                ctypes.c_int, _U64P, _U64P, ctypes.c_int64, ctypes.c_int64,
                _U64P, _U8P, _U64P, _U8P,
            ]
            lib.ec_decompress_batch2.restype = ctypes.c_int
            lib.ec_decompress_batch2.argtypes = [
                ctypes.c_int, _U64P, _U64P, _U64P, _U64P, _U64P, _U8P,
                ctypes.c_int64, _U64P, _U8P,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _p8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def limbs_for(p: int) -> int | None:
    bits = p.bit_length()
    if bits <= 256:
        return 4
    if bits <= 384:
        return 6
    if bits <= 576:
        return 9
    return None


class NativeEc:
    """Per-curve handle (caches the p/a limb arrays + limb width)."""

    def __init__(self, p: int, a: int):
        self.p_int = p
        self.nl = limbs_for(p)
        assert self.nl is not None
        self.p_arr = self._limbs(p)
        self.a_arr = self._limbs(a % p)

    def _limbs(self, v: int) -> np.ndarray:
        return np.frombuffer(
            int(v).to_bytes(8 * self.nl, "little"), dtype=np.uint64
        ).copy()

    def _points_to_arrays(self, points) -> tuple[np.ndarray, np.ndarray]:
        nl = self.nl
        n = len(points)
        xy = np.zeros((n, 2 * nl), np.uint64)
        inf = np.zeros(n, np.uint8)
        for i, pt in enumerate(points):
            if pt is None:
                inf[i] = 1
            else:
                xy[i, :nl] = self._limbs(pt[0])
                xy[i, nl:] = self._limbs(pt[1])
        return xy, inf

    def _scalars_to_array(self, scalars) -> np.ndarray:
        out = np.zeros((len(scalars), self.nl), np.uint64)
        for i, s in enumerate(scalars):
            out[i] = self._limbs(s)
        return out

    def _arrays_to_points(self, xy: np.ndarray, inf: np.ndarray) -> list:
        nl = self.nl
        out = []
        for i in range(len(inf)):
            if inf[i]:
                out.append(None)
            else:
                b = xy[i].tobytes()
                out.append(
                    (
                        int.from_bytes(b[: 8 * nl], "little"),
                        int.from_bytes(b[8 * nl :], "little"),
                    )
                )
        return out

    def decompress_batch(self, b: int, xs: np.ndarray, parities: np.ndarray):
        """SEC1 decompression, p = 3 (mod 4) curves only: xs (n, NL) uint64
        little-endian limbs -> (ys (n, NL) limbs, ok (n,) uint8)."""
        assert self.p_int % 4 == 3
        lib = get_lib()
        assert lib is not None
        n = len(xs)
        b_arr = self._limbs(b % self.p_int)
        e_arr = self._limbs((self.p_int + 1) // 4)
        ys = np.zeros((n, self.nl), np.uint64)
        ok = np.zeros(n, np.uint8)
        xs = np.ascontiguousarray(xs, np.uint64)
        par = np.ascontiguousarray(parities, np.uint8)
        lib.ec_decompress_batch2(
            self.nl, _p(self.p_arr), _p(self.a_arr), _p(b_arr), _p(e_arr),
            _p(xs), _p8(par), n, _p(ys), _p8(ok),
        )
        return ys, ok

    def mul_batch(self, bases, scalars, shared: bool) -> list:
        """[k*B] for (B, k) pairs; shared=True uses bases[0] for all with one
        shared window table. Scalars must be reduced mod the group order."""
        lib = get_lib()
        assert lib is not None
        n = len(scalars)
        bxy, binf = self._points_to_arrays(bases if not shared else bases[:1])
        s = self._scalars_to_array(scalars)
        oxy = np.zeros((n, 2 * self.nl), np.uint64)
        oinf = np.zeros(n, np.uint8)
        lib.ec_mul_batch2(
            self.nl, _p(self.p_arr), _p(self.a_arr), 1 if shared else 0,
            _p(bxy), _p8(binf), _p(s), n, _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)

    def multi_mul_groups(self, points, scalars, n_groups: int, k: int) -> list:
        """n_groups simultaneous multi-exps of k (point, scalar) pairs each
        (flat lists of length n_groups*k)."""
        lib = get_lib()
        assert lib is not None
        pxy, pinf = self._points_to_arrays(points)
        s = self._scalars_to_array(scalars)
        oxy = np.zeros((n_groups, 2 * self.nl), np.uint64)
        oinf = np.zeros(n_groups, np.uint8)
        lib.ec_multi_mul_batch2(
            self.nl, _p(self.p_arr), _p(self.a_arr), n_groups, k,
            _p(pxy), _p8(pinf), _p(s), _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)

    def sum_groups(self, points, n_groups: int, k: int) -> list:
        """n_groups sums of k points each (flat list of length n_groups*k)."""
        lib = get_lib()
        assert lib is not None
        pxy, pinf = self._points_to_arrays(points)
        oxy = np.zeros((n_groups, 2 * self.nl), np.uint64)
        oinf = np.zeros(n_groups, np.uint8)
        lib.ec_sum_batch2(
            self.nl, _p(self.p_arr), _p(self.a_arr), n_groups, k,
            _p(pxy), _p8(pinf), _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)


def for_curve(p: int, a: int) -> NativeEc | None:
    """Native handle for an odd prime field (<= 576 bits), or None."""
    if limbs_for(p) is None or p % 2 == 0 or get_lib() is None:
        return None
    return NativeEc(p, a)
