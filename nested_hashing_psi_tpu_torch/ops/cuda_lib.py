"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, then linked into a plain-C shared library under
``build/nhpsi_torch/`` at the repository root, at first use, and loaded with
ctypes (no PyTorch headers: the build takes seconds). The library is rebuilt
when any source is newer than it. Nothing here runs at import time:
``get_lib`` is called by the kernel wrappers when they are handed a CUDA
tensor, and it raises if nvcc or the build fails -- there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nhpsi_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libnhpsi_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # (x, y, twiddle_pairs, iscale, primes, rows, L, logn, inverse, grids*, stream)
    "nhpsi_ntt": [_P] * 5 + [_I] * 4 + [ctypes.POINTER(_I), _P],
    # as nhpsi_ntt with a forced form before grids*
    "nhpsi_ntt_form": [_P] * 5 + [_I] * 5 + [ctypes.POINTER(_I), _P],
    # (idx, pt, acc, out, primes, pinvs, H, D, P, L, N, idx h stride,
    #  table h, d, p, l strides, stream)
    "nhpsi_pie_ip": [_P] * 6 + [_I] * 5 + [_LL] * 5 + [_P],
    # (x, y, tmp, ga, gb, tw, rc, primes, pinvs, rows, L, m1, m2, inverse,
    #  launched*, stream)
    "nhpsi_ntt_mxu": [_P] * 9 + [_I] * 5 + [ctypes.POINTER(_I), _P],
    # (phase, mask, consts, psi, s2n, rows, L, logn, length, bgv, cluster, stream)
    "nhpsi_decrypt_mask": [_P] * 5 + [_I] * 5 + [_P],
    # the probes under benchmarks/: (x, y, n, mix, k, stream)
    "nhpsi_probe_vpu_ops": [_P, _P, _I, _I, _I, _P],
    # (x, y, sa, sb, primes, B, L, m, variant, stream)
    "nhpsi_probe_ntt_lazy": [_P] * 5 + [_I] * 4 + [_P],
    # (x, y, sa, sb, tw, primes, B, L, m, variant, stream)
    "nhpsi_probe_ntt_anatomy": [_P] * 6 + [_I] * 4 + [_P],
}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise if any fails. Returns their
    combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    failed = [f"{' '.join(c)}\n{out}" for c, out, rc in outs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(out for _, out, _ in outs)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into LIB_PATH (atomically replaced). Returns the compiler's output
    (register/spill report with verbose=True)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in sources()]
    out = _run_all([
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", s, "-o", o]
        for s, o in zip(sources(), objs)
    ])
    tmp = f"{LIB_PATH}.{tag}"
    out += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, LIB_PATH)
    return out


def ptxas_report(names: list[str]) -> str:
    """The ``-Xptxas -v`` report (registers and spills of every kernel
    instance) of the named csrc/ sources, compiled as ``build`` compiles
    them into a temporary directory; the library is not touched."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        return _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", os.path.join(CSRC, nm),
                          "-o", os.path.join(tmp, f"{nm}.o")] for nm in names])


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
