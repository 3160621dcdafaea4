"""ctypes loader/builder for the native host kernels (native/nhpsi_native.cpp).

The port's own copy of ``nested_hashing_psi_tpu.utils.native``'s entry
points (``ntt_mod_t``, ``phase_to_mt``, ``cuckoo_insert_seq``), with the
same behaviour: the port imports nothing of the JAX package. The
source is the repository's ``native/nhpsi_native.cpp``; it is compiled with
g++ on first use into ``build/nhpsi_torch/`` (ignored by git), apart from
the JAX package's build, and every caller has a pure-Python fallback, so a
missing toolchain degrades performance, not capability. The built file's
name carries a hash of the source, the compiler command and the host CPU,
so a library built on another host (``-march=native``) is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "nhpsi_native.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "nhpsi_torch", "libnhpsi_native.so")

_lock = threading.Lock()
_lib = None
_tried = False

_U64P = ctypes.POINTER(ctypes.c_uint64)


_CXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]


def _host_cpu() -> str:
    """The host CPU's model and feature flags (``/proc/cpuinfo``'s first
    processor), or what ``platform`` knows where that file is missing."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read().split("\n\n")[0]
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = ("vendor_id", "cpu family", "model", "model name", "flags", "Features",
            "CPU implementer", "CPU part")
    return "\n".join(line for line in info.splitlines()
                     if line.split(":")[0].strip() in keep)


def built_path(src: str, so: str) -> str:
    """``so`` with a hash of ``src``'s bytes, the compiler command and the
    host CPU before its suffix: ``build/.../libx.so`` -> ``.../libx.<hash>.so``."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX).encode())
    h.update(_host_cpu().encode())
    stem, ext = os.path.splitext(so)
    return f"{stem}.{h.hexdigest()[:16]}{ext}"


def build_and_load(src: str, so: str) -> ctypes.CDLL:
    """Compile ``src`` with g++ into ``built_path(src, so)`` unless that
    file exists, then load it. The build writes a temporary file and
    renames it into place, so concurrent builds (test workers, processes)
    never load half a file. Raises OSError or CalledProcessError when it
    cannot."""
    target = built_path(src, so)
    if not os.path.exists(target):
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(_CXX + [src, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, target)  # atomic
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(target)


def get_lib():
    """Returns the loaded library or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = build_and_load(_SRC, _SO)
            lib.ntt_mod_t.restype = ctypes.c_int
            lib.ntt_mod_t.argtypes = [
                _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int,
            ]
            lib.cuckoo_insert_seq.restype = ctypes.c_int64
            lib.cuckoo_insert_seq.argtypes = [
                _U64P, ctypes.c_int64, _U64P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, _U64P, _U64P,
            ]
            lib.phase_to_mt.restype = ctypes.c_double
            lib.phase_to_mt.argtypes = [
                _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _U64P, _U64P, _U64P, _U64P, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int, _U64P,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def _u64ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def ntt_mod_t(data: np.ndarray, t: int, psi: int, inverse: bool) -> np.ndarray | None:
    """Batched negacyclic NTT mod t (<= 63 bits). data: (batch, n) uint64.
    Returns transformed copy, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None or t >= 1 << 63:
        return None
    out = np.ascontiguousarray(data, dtype=np.uint64).copy()
    batch, n = out.shape
    rc = lib.ntt_mod_t(_u64ptr(out), batch, n, t, psi, 1 if inverse else 0)
    if rc != 0:
        return None
    return out


def phase_to_mt(
    phase: np.ndarray, q_primes: tuple[int, ...], t: int, scheme: str
) -> tuple[np.ndarray, float] | None:
    """Exact RNS phase -> message mod t via __int128 CRT (big-t decrypt,
    reference 40/48-bit moduli). phase: (..., L, n) uint64 residues.
    Returns ((..., n) uint64 messages, noise-fraction in [0, 0.5]) or None.
    """
    lib = get_lib()
    if lib is None or t >= 1 << 63:
        return None
    L = len(q_primes)
    q = 1
    for p in q_primes:
        q *= p
    ph = np.ascontiguousarray(phase, dtype=np.uint64)
    lead = ph.shape[:-2]
    n = ph.shape[-1]
    rows = int(np.prod(lead)) if lead else 1
    qp = np.array(q_primes, dtype=np.uint64)
    inv_qhat = np.array(
        [pow(q // p, -1, p) for p in q_primes], dtype=np.uint64
    )
    if scheme == "bfv":
        int_coef = np.array([t // p for p in q_primes], dtype=np.uint64)
        frac_fp = np.array(
            [((t % p) << 64) // p for p in q_primes], dtype=np.uint64
        )
        sub_coef = 0
    else:
        int_coef = np.array([(q // p) % t for p in q_primes], dtype=np.uint64)
        frac_fp = np.array([(1 << 64) // p for p in q_primes], dtype=np.uint64)
        sub_coef = q % t
    out = np.zeros((rows, n), dtype=np.uint64)
    dist = lib.phase_to_mt(
        _u64ptr(ph.reshape(rows, L, n)),
        rows,
        L,
        n,
        _u64ptr(qp),
        _u64ptr(inv_qhat),
        _u64ptr(int_coef),
        _u64ptr(frac_fp),
        sub_coef,
        t,
        1 if scheme == "bfv" else 0,
        _u64ptr(out),
    )
    return out.reshape(*lead, n), float(dist)


def cuckoo_insert_seq(
    items: np.ndarray,
    hash_table: np.ndarray,
    starting_hash_id: int,
    n_hf: int,
    size: int,
    max_pp: int,
    multi_table: bool,
    stash_size: int,
    seed: int,
):
    """Reference-style sequential cuckoo insertion (the reference's
    CuckooHashTable semantics: lookUp skip, 1000 eviction rounds, random
    victim depth from an xorshift stream seeded with ``seed``). items:
    (n, 2) uint64; hash_table: the tabulation table (n_hf, 16, 256).
    Returns (table (n_tables, max_pp, size, 2), stash (stash_size, 2),
    n_failures) or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    items = np.ascontiguousarray(items, dtype=np.uint64)
    hash_table = np.ascontiguousarray(hash_table, dtype=np.uint64)
    # the C loop reads these bounds unchecked
    if items.ndim != 2 or items.shape[1] != 2:
        raise ValueError(f"items must be (n, 2) uint64, got {items.shape}")
    if hash_table.shape[1:] != (16, 256) or not 0 <= starting_hash_id <= \
            hash_table.shape[0] - n_hf:
        raise ValueError(f"hash functions [{starting_hash_id}, {starting_hash_id + n_hf}) "
                         f"not in a tabulation table of shape {hash_table.shape}")
    if min(n_hf, size, max_pp) < 1 or stash_size < 0:
        raise ValueError("n_hf, size and max_pp must be positive, stash_size >= 0")
    n_tables = n_hf if multi_table else 1
    table = np.zeros((n_tables, max_pp, size, 2), dtype=np.uint64)
    stash = np.zeros((max(stash_size, 1), 2), dtype=np.uint64)
    failures = lib.cuckoo_insert_seq(
        _u64ptr(items),
        len(items),
        _u64ptr(hash_table),
        starting_hash_id,
        n_hf,
        size,
        max_pp,
        1 if multi_table else 0,
        stash_size,
        seed,
        _u64ptr(table),
        _u64ptr(stash),
    )
    return table, stash[:stash_size], int(failures)
