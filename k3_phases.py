#!/usr/bin/env python3
"""Where K3's time goes on the card: per-phase SM cycles of each CTA.

    python3 k3_phases.py

Copies the port into build/k3_phases/ (ignored by git), adds clock64()
marks to that copy of csrc/ntt_mxu.cu (the package's own source is not
touched), builds it, runs the forward NTT at (2,12,2,6,16384) and prints,
over the CTAs that hold a row, the mean / min / max cycles to the end of
each phase (first digit build, each stage's wgmma passes and epilogue, the
second digit build) and the cycles each warpgroup spent waiting for ring
chunks, issuing and waiting on its wgmmas, and draining and folding after
each digit matrix. Needs a GPU; fails if the source no longer has the
places it marks.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(ROOT, "build", "k3_phases")
SLOTS = 16  # marks per (CTA, warpgroup)
MARKS = ["start", "digits, stage 1", "stage 1 wgmma + folds", "stage 2 wgmma + folds",
         "stage 1 epilogue", "stage 2 epilogue", "digits, stage 2", "end",
         "waiting for chunks", "wgmma issue + wait", "drain + fold"]

# (text in csrc/ntt_mxu.cu, its instrumented replacement)
PATCHES = [
    ("constexpr int kMaxSmem = 232448;", "constexpr int kMaxSmem = 231424;"),
    ("enum Mode {", f"__device__ unsigned long long g_marks[8192 * {SLOTS}];\nenum Mode {{"),
    ("struct Ring {", "__shared__ long long s_stats[2][4];\nstruct Ring {"),
    ("""  bar_wait(&r.full[r.slot], r.phase);
  const int8_t* gk = r.base + r.slot * r.chunk_bytes;""",
     """  long long t0 = clock64();
  bar_wait(&r.full[r.slot], r.phase);
  long long t1 = clock64();
  const int8_t* gk = r.base + r.slot * r.chunk_bytes;"""),
    ("""  wgmma_commit();
  wgmma_wait<1>();
  if (r.held >= 0""",
     """  wgmma_commit();
  wgmma_wait<1>();
  if ((tid & 127) == 0) {
    s_stats[tid >> 7][0] += t1 - t0;
    s_stats[tid >> 7][1] += clock64() - t1;
  }
  if (r.held >= 0"""),
    ("""    mma_chunk<N>(acc, r, dig, g, left, ks, ga_off, gd_off, tid);
  wgmma_wait<0>();""",
     """    mma_chunk<N>(acc, r, dig, g, left, ks, ga_off, gd_off, tid);
  long long te = clock64();
  wgmma_wait<0>();"""),
    ("""  fold<I>(acc, sum, wts, p);
}""",
     """  fold<I>(acc, sum, wts, p);
  if ((tid & 127) == 0) s_stats[tid >> 7][2] += clock64() - te;
}"""),
    ("""    const int tid = threadIdx.x, wg = tid >> 7;""",
     f"""    const int tid = threadIdx.x, wg = tid >> 7;
    unsigned long long* D = g_marks + (blockIdx.x * 2 + wg) * {SLOTS};
    long long T0 = clock64();
    if ((tid & 127) == 0) s_stats[wg][0] = s_stats[wg][1] = s_stats[wg][2] = 0;"""),
    ("""    fence_proxy_async();
    consumers_sync();
    // The row buffer is free""",
     """    fence_proxy_async();
    consumers_sync();
    if ((tid & 127) == 0) D[1] = clock64() - T0;
    // The row buffer is free"""),
    ("""        mma_matrix<4, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);""",
     """        mma_matrix<4, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        if ((tid & 127) == 0) D[2 + st] = clock64() - T0;"""),
    ("""        if (mine) store_tile<N>(sum, dst, r0, m1, twl, p, pinv);
      }""",
     """        if (mine) store_tile<N>(sum, dst, r0, m1, twl, p, pinv);
        if ((tid & 127) == 0) D[4 + st] = clock64() - T0;
      }"""),
    ("""        fence_proxy_async();
        consumers_sync();
      }
    }
    cluster_sync();""",
     """        fence_proxy_async();
        consumers_sync();
        if ((tid & 127) == 0) D[6] = clock64() - T0;
      }
    }
    if ((tid & 127) == 0) {
      D[7] = clock64() - T0;
      D[8] = s_stats[wg][0];
      D[9] = s_stats[wg][1];
      D[10] = s_stats[wg][2];
      D[11] = active;
    }
    cluster_sync();"""),
]
READER = """
extern "C" int nhpsi_k3_marks(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)));
}
"""


def instrumented_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "nested_hashing_psi_tpu_torch"),
                    os.path.join(COPY, "nested_hashing_psi_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(COPY, "nested_hashing_psi_tpu_torch", "csrc", "ntt_mxu.cu")
    src = open(path).read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            sys.exit(f"k3_phases: csrc/ntt_mxu.cu no longer has the place to mark: {old[:60]!r}")
        src = src.replace(old, new)
    open(path, "w").write(src + READER)


def main() -> None:
    instrumented_copy()
    sys.path.insert(0, COPY)
    import numpy as np
    import torch

    from nested_hashing_psi_tpu_torch.ops import cuda_lib, ntt_cuda, ntt_mxu
    from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
    from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

    if not torch.cuda.is_available():
        sys.exit("k3_phases: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build()
    read_marks = cuda_lib.get_lib().nhpsi_k3_marks
    read_marks.argtypes, read_marks.restype = [ctypes.c_void_p], ctypes.c_int
    n, L = 16384, 6
    ps = ntt_primes(L, 31, 2 * n)
    mp, plan = ntt_mxu.MxuNTTPlan(n, ps), NTTPlan(n, ps)
    rng = np.random.default_rng(1)
    p = np.array(ps, np.int64).reshape(L, 1)
    x = torch.from_numpy((rng.integers(0, 1 << 62, size=(2, 12, 2, L, n)) % p).astype(np.int32))
    x = x.cuda()
    for _ in range(3):
        y = ntt_mxu.ntt_mxu(x, mp)
    torch.cuda.synchronize()
    if not torch.equal(y, ntt_cuda.ntt(x, plan)):
        sys.exit("k3_phases: the instrumented K3 disagrees with K1")
    marks = np.zeros(8192 * SLOTS, np.uint64)
    cuda_lib.check(read_marks(marks.ctypes.data), "reading the marks")
    rows = x.numel() // n
    d = marks.reshape(-1, SLOTS)[:2 * (rows + 4 * L)].astype(np.float64)
    d = d[d[:, 11] == 1]
    print(f"K3 forward (2,12,2,{L},{n}): {len(d) // 2} CTAs with a row; SM cycles per "
          "consumer warpgroup (mean / min / max)", flush=True)
    for k in range(1, 11):
        kind = "to the end of" if k < 8 else "in all, "
        print(f"  {kind} {MARKS[k]}: {d[:, k].mean():.0f} / {d[:, k].min():.0f} / "
              f"{d[:, k].max():.0f}", flush=True)


if __name__ == "__main__":
    main()
