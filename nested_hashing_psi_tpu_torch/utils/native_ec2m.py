"""ctypes loader + converters for the binary-field EC backend
(native/nhpsi_ec2m.cpp, PCLMUL carry-less multiply).

The port's own copy of ``nested_hashing_psi_tpu.utils.native_ec2m``, with the
same names and behaviour: the port imports nothing of the JAX package.
The source stays the repository's; g++ builds it into
``build/nhpsi_torch/`` (ignored by git), apart from the JAX package's
in-place build, through a temporary file and a rename
(``utils.native.build_and_load``).

Same contract as utils.native_ec: pure-Python fallback in crypto/ec2m.py;
all batch calls take/return affine (x, y) int tuples / None, identical
point-for-point to the Python group law."""

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
_SRC = os.path.join(_REPO_ROOT, "native", "nhpsi_ec2m.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "nhpsi_torch", "libnhpsi_ec2m.so")

_lock = threading.Lock()
_lib = None
_tried = False

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = build_and_load(_SRC, _SO)
            head = [ctypes.c_int, _I64P, ctypes.c_int, ctypes.c_int, _U64P, _U64P]
            lib.ec2m_mul_batch.restype = ctypes.c_int
            lib.ec2m_mul_batch.argtypes = head + [
                ctypes.c_int, _U64P, _U8P, _U64P, ctypes.c_int64, _U64P, _U8P,
            ]
            lib.ec2m_multi_mul_batch.restype = ctypes.c_int
            lib.ec2m_multi_mul_batch.argtypes = head + [
                ctypes.c_int64, ctypes.c_int64, _U64P, _U8P, _U64P, _U64P, _U8P,
            ]
            lib.ec2m_sum_batch.restype = ctypes.c_int
            lib.ec2m_sum_batch.argtypes = head + [
                ctypes.c_int64, ctypes.c_int64, _U64P, _U8P, _U64P, _U8P,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def _p(a):
    return a.ctypes.data_as(_U64P)


def _p8(a):
    return a.ctypes.data_as(_U8P)


class NativeEc2m:
    """Per-curve handle for GF(2^m) batch calls."""

    def __init__(self, m: int, red_exps, a: int, b: int):
        self.m = m
        self.nw = (m + 63) // 64  # field elements are < 2^m
        assert self.nw <= 9  # C backend bound (MAXW)
        self.red = np.array(sorted(red_exps, reverse=True), np.int64)
        self.a_arr = self._limbs(a)
        self.b_arr = self._limbs(b)

    def _limbs(self, v: int) -> np.ndarray:
        return np.frombuffer(
            int(v).to_bytes(8 * self.nw, "little"), dtype=np.uint64
        ).copy()

    def _head(self):
        return (
            self.m, self.red.ctypes.data_as(_I64P), len(self.red), self.nw,
            _p(self.a_arr), _p(self.b_arr),
        )

    def _points_to_arrays(self, points):
        n = len(points)
        xy = np.zeros((n, 2 * self.nw), np.uint64)
        inf = np.zeros(n, np.uint8)
        for i, pt in enumerate(points):
            if pt is None:
                inf[i] = 1
            else:
                xy[i, : self.nw] = self._limbs(pt[0])
                xy[i, self.nw :] = self._limbs(pt[1])
        return xy, inf

    def _scalars_to_array(self, scalars):
        out = np.zeros((len(scalars), self.nw), np.uint64)
        for i, s in enumerate(scalars):
            out[i] = self._limbs(s)
        return out

    def _arrays_to_points(self, xy, inf):
        nw = self.nw
        out = []
        for i in range(len(inf)):
            if inf[i]:
                out.append(None)
            else:
                b = xy[i].tobytes()
                out.append(
                    (
                        int.from_bytes(b[: 8 * nw], "little"),
                        int.from_bytes(b[8 * nw :], "little"),
                    )
                )
        return out

    def mul_batch(self, bases, scalars, shared: bool) -> list:
        lib = get_lib()
        n = len(scalars)
        bxy, binf = self._points_to_arrays(bases if not shared else bases[:1])
        s = self._scalars_to_array(scalars)
        oxy = np.zeros((n, 2 * self.nw), np.uint64)
        oinf = np.zeros(n, np.uint8)
        lib.ec2m_mul_batch(
            *self._head(), 1 if shared else 0, _p(bxy), _p8(binf), _p(s), n,
            _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)

    def multi_mul_groups(self, points, scalars, n_groups: int, k: int) -> list:
        lib = get_lib()
        pxy, pinf = self._points_to_arrays(points)
        s = self._scalars_to_array(scalars)
        oxy = np.zeros((n_groups, 2 * self.nw), np.uint64)
        oinf = np.zeros(n_groups, np.uint8)
        lib.ec2m_multi_mul_batch(
            *self._head(), n_groups, k, _p(pxy), _p8(pinf), _p(s),
            _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)

    def sum_groups(self, points, n_groups: int, k: int) -> list:
        lib = get_lib()
        pxy, pinf = self._points_to_arrays(points)
        oxy = np.zeros((n_groups, 2 * self.nw), np.uint64)
        oinf = np.zeros(n_groups, np.uint8)
        lib.ec2m_sum_batch(
            *self._head(), n_groups, k, _p(pxy), _p8(pinf), _p(oxy), _p8(oinf),
        )
        return self._arrays_to_points(oxy, oinf)


def for_curve(m: int, red_exps, a: int, b: int) -> NativeEc2m | None:
    if (m + 63) // 64 > 9 or get_lib() is None:
        return None
    return NativeEc2m(m, red_exps, a, b)
