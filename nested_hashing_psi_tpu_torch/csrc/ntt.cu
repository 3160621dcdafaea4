// K1: negacyclic NTT / inverse NTT over RNS limb rows, register-blocked for
// Hopper.
//
// Replaces the TPU kernel ntt_pallas / intt_pallas of
// nested_hashing_psi_tpu/ops/ntt_pallas.py (pallas_call at :596, entries
// :631 and :645). Same contract: x (..., L, n) residues mod 31-bit primes,
// the prime of row `row` is primes[row % L]; forward goes natural ->
// canonical bit-reversed order, inverse goes back and includes the 1/n
// scale; bit-exact with the plain version in
// nested_hashing_psi_tpu_torch/ops/ntt.py. The kernel runs the plain
// version's butterflies (merged-twiddle Cooley-Tukey forward,
// Gentleman-Sande inverse, Shoup products with the same twiddle pairs) and
// only regroups them. Every helper returns the canonical residue, so the
// result is bit-exact by construction.
//
// What bounds it on an H100: its bytes. A row of n = 16384 residues (64 KB,
// read and written once) takes n/2 log2 n = 114,688 butterflies of 8 32-bit
// integer instructions each: a Shoup product (one high and two low
// multiplies, on the FMA pipe, and a conditional subtract), an add_mod and
// a sub_mod (a three-input add and a fused add-min each, on the ALU pipe;
// the compiler moves some adds to the FMA pipe). The two pipes take 64
// instructions per clock per SM each and issue side by side, so a row's
// integer work takes about two thirds of its bytes' time.
//
// Design:
// - Register-blocked radix-32 passes. The log2 n index bits of a row are
//   cut into windows of at most 5 bits; a pass gives every thread the 2^r
//   residues that differ only in its window's r bits and runs those r
//   stages in registers. Threads exchange through shared memory only
//   between passes: 3 passes and 3 barriers per row at n = 16384 (14
//   barriers before). The exchange is padded by one word in 32, which
//   keeps every pass's loads and stores free of bank conflicts at the main
//   path's shapes.
// - Twiddles are read as one 8-byte [value, Shoup quotient] pair
//   (NTTPlan's interleaved tables); a pass of r stages needs 2^r - 1 pairs
//   per thread, which the threads of a pass's first windows share.
// - Rows of one prime share every twiddle. The deep stages read one pair
//   per butterfly or two, each from L2, so the split form's chunk kernel
//   gives a block one chunk of 8 rows of one prime (l, l + L, ...) and
//   first stages the chunk's 2^W - 1 pairs in shared memory: 8 times fewer
//   twiddle loads, and the passes then read them at shared-memory latency.
// - The inverse folds the n^-1 scale into its last stage (the Shoup pairs
//   of n^-1 and of psi^-1 * n^-1), saving a pass over the row.
// - From n = 1024 up every call takes the split form: one kernel runs the
//   top 5-bit window as independent 32-residue columns (no shared memory),
//   another the remaining bits as independent chunks of n/32 residues,
//   eight chunks per 128-thread block; the second of the two runs in
//   place. Its many small blocks overlap loads, integer work and stores
//   across the SM, which the whole-row blocks (one row in 512 threads at
//   n = 16384), each loading, computing and storing in step, do not; the
//   extra round trip of the rows through L2 costs less. Measured on an
//   H100 at the main path's nine launches (96-384 rows of n = 16384,
//   chip_smoke.py), the split form was the faster at each. Below n = 1024
//   the whole-row kernel is the only form.
// - The shared-memory attribute is set once per kernel and device.
// - Lazy (Harvey) reduction is not used: the primes lie just below 2^31,
//   so 4p does not fit in 32 bits; the conditional subtracts are
//   branch-free (modarith.cuh).
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

using nhpsi::add_mod;
using nhpsi::shoup_mul;
using nhpsi::sub_mod;

constexpr int kMaxRadixLog = 5;     // at most 32 residues per thread and pass
constexpr int kSplitThreads = 128;  // block size of the split form
constexpr int kSplitBlocksPerSM = 6;  // 80 registers per thread (96-128 uncapped)
constexpr int kMaxDevices = 16;
constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 15;
constexpr int kMinSplitLogN = 10;   // the split form's chunks hold >= 32 residues

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The bits [BL, BL + W) of a row index, processed in NP passes of at most
// 2^R residues per thread. A unit is the set of indices that agree outside
// the window; 2^TU_LOG threads handle one unit.
template <int LOGN, bool INV, int BL, int W>
struct Window {
  static constexpr int R = imin(kMaxRadixLog, W);
  static constexpr int E = 1 << R;
  static constexpr int TU_LOG = W - R;
  static constexpr int NP = (W + R - 1) / R;
  static constexpr int STRIDE = (1 << W) + ((1 << W) >> 5);  // padded words per unit
  static constexpr int UPR_LOG = LOGN - W;                    // units per row
  static constexpr bool WHOLE = W == LOGN;
  static constexpr int BLOCK = WHOLE ? (1 << TU_LOG) : kSplitThreads;
  static constexpr int UPB = BLOCK >> TU_LOG;                 // units per block
  // resident blocks per SM asked of the compiler (it caps registers to fit)
  static constexpr int MIN_BLOCKS = !WHOLE ? kSplitBlocksPerSM : BLOCK == 512 ? 2 : 1;
  // the split form's second launch reads and writes the same rows
  static constexpr bool IN_PLACE = !WHOLE && (INV ? BL != 0 : BL == 0);
  // The split form's chunks (the low W bits): a block takes one chunk of
  // UPB rows of one prime and stages that chunk's 2^W - 1 twiddle pairs in
  // shared memory, indexed like a table of 2^W (TLOG).
  static constexpr bool CHUNKS = !WHOLE && BL == 0;
  static constexpr int TLOG = CHUNKS ? W : LOGN;
  static constexpr size_t TW_SMEM = CHUNKS ? sizeof(uint2) << W : 0;
  static constexpr size_t SMEM = TW_SMEM + (NP > 1 ? sizeof(uint32_t) * UPB * STRIDE : 0);
  // the forward runs the bits top-down, the inverse bottom-up
  __host__ __device__ static constexpr int pass_b(int j) {
    return INV ? BL + j * R : imax(BL, BL + W - (j + 1) * R);
  }
  __host__ __device__ static constexpr int pass_r(int j) {
    return INV ? imin(R, W - j * R) : BL + W - j * R - pass_b(j);
  }
};

// Cooley-Tukey: (X, Y) -> (X + wY, X - wY).
__device__ __forceinline__ void ct(uint32_t& x, uint32_t& y, uint2 w, uint32_t p) {
  const uint32_t v = shoup_mul(y, w.x, w.y, p);
  y = sub_mod(x, v, p);
  x = add_mod(x, v, p);
}

// Gentleman-Sande: (X, Y) -> (X + Y, w(X - Y)).
__device__ __forceinline__ void gs(uint32_t& x, uint32_t& y, uint2 w, uint32_t p) {
  const uint32_t d = sub_mod(x, y, p);
  x = add_mod(x, y, p);
  y = shoup_mul(d, w.x, w.y, p);
}

// The inverse's last stage with the 1/n scale folded in:
// (X, Y) -> (n^-1 (X + Y), psi^-1 n^-1 (X - Y)); sc = [n^-1, quotient,
// psi^-1 n^-1, quotient].
__device__ __forceinline__ void gs_last(uint32_t& x, uint32_t& y, uint4 sc, uint32_t p) {
  const uint32_t d = sub_mod(x, y, p);
  x = shoup_mul(add_mod(x, y, p), sc.x, sc.y, p);
  y = shoup_mul(d, sc.z, sc.w, p);
}

// A load through the read-only path, unless PLAIN: from rows the launch
// also writes, or from shared memory.
template <bool PLAIN, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (PLAIN)
    return *p;
  else
    return __ldg(p);
}

// Pass J of the window for one thread: load its residues (from the row in
// device memory on the first pass, else from the unit's shared memory), run
// the pass's stages in registers, store them (to the output row on the
// last pass, else back to shared memory). Each thread stores exactly the
// residues it loaded, so a pass needs no barrier of its own.
template <int LOGN, bool INV, int BL, int W, int J>
__device__ __forceinline__ void run_pass(uint32_t (&v)[Window<LOGN, INV, BL, W>::E],
                                         const uint32_t* x, uint32_t* y, uint32_t* s,
                                         const uint2* __restrict__ tw, uint4 sc,
                                         uint32_t p, uint32_t unit_hi,
                                         uint32_t unit_lo, uint32_t tid_u) {
  using Wd = Window<LOGN, INV, BL, W>;
  constexpr int b = Wd::pass_b(J);
  constexpr int r = Wd::pass_r(J);
  constexpr int bw = b - BL;            // the pass's lowest bit inside the window
  constexpr int S = 1 << (Wd::R - r);   // tasks per thread
  constexpr bool FIRST = J == 0;
  constexpr bool LAST = J == Wd::NP - 1;
  constexpr bool VEC = b == 0 && r >= 2;  // the 2^r residues are contiguous
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const uint32_t tau = tid_u + (static_cast<uint32_t>(t) << Wd::TU_LOG);
    const uint32_t iw0 = ((tau >> bw) << (bw + r)) | (tau & ((1u << bw) - 1));
    const uint32_t i0 = (unit_hi << (BL + W)) | (iw0 << BL) | unit_lo;
    // the index bits above the pass (inside the chunk for staged twiddles)
    const uint32_t hi = (i0 & ((1u << Wd::TLOG) - 1)) >> (b + r);
    uint32_t* a = v + (t << r);  // constant offset once unrolled
    if constexpr (FIRST) {
      if constexpr (VEC) {
        const uint4* src = reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
        for (int q = 0; q < (1 << r) / 4; ++q) {
          const uint4 c = load<Wd::IN_PLACE>(src + q);
          a[4 * q] = c.x;
          a[4 * q + 1] = c.y;
          a[4 * q + 2] = c.z;
          a[4 * q + 3] = c.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < (1 << r); ++k) a[k] = load<Wd::IN_PLACE>(x + i0 + (k << b));
      }
    } else {
#pragma unroll
      for (int k = 0; k < (1 << r); ++k) a[k] = s[pad(iw0 + (k << bw))];
    }
    // Both loops have constant trip counts, so they unroll fully and every
    // register index below is a constant (no local-memory array).
    if constexpr (!INV) {
#pragma unroll
      for (int st = 0; st < r; ++st) {
        const int half = 1 << (r - 1 - st);
        uint2 w = make_uint2(0, 0);
#pragma unroll
        for (int j = 0; j < (1 << (r - 1)); ++j) {
          const int g = j >> (r - 1 - st);          // twiddle group
          const int k = (g << (r - st)) | (j & (half - 1));
          if ((j & (half - 1)) == 0)
            w = load<Wd::CHUNKS>(tw + (1u << (Wd::TLOG - b - r + st)) + (hi << st) + g);
          ct(a[k], a[k + half], w, p);
        }
      }
    } else {
#pragma unroll
      for (int st = 0; st < r; ++st) {
        const int half = 1 << st;
        const bool last = b + st == LOGN - 1;  // one group, the 1/n scale folded in
        uint2 w = make_uint2(0, 0);
#pragma unroll
        for (int j = 0; j < (1 << (r - 1)); ++j) {
          const int g = j >> st;
          const int k = (g << (st + 1)) | (j & (half - 1));
          if (last) {
            gs_last(a[k], a[k + half], sc, p);
          } else {
            if ((j & (half - 1)) == 0)
              w = load<Wd::CHUNKS>(tw + (1u << (Wd::TLOG - 1 - b - st)) + (hi << (r - 1 - st)) +
                                   g);
            gs(a[k], a[k + half], w, p);
          }
        }
      }
    }
    if constexpr (LAST) {
      if constexpr (VEC) {
        uint4* dst = reinterpret_cast<uint4*>(y + i0);
#pragma unroll
        for (int q = 0; q < (1 << r) / 4; ++q)
          dst[q] = make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < (1 << r); ++k) y[i0 + (k << b)] = a[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < (1 << r); ++k) s[pad(iw0 + (k << bw))] = a[k];
    }
  }
}

// One window of every row: each block takes UPB units (index sets that
// agree outside the window); a whole-row window has one unit per row. An
// in-place launch reads the rows through y (x is null).
// tw: (L, n) [value, quotient] pairs; iscale: (L,) [n^-1, quotient,
// psi^-1 n^-1, quotient], read by the inverse only.
template <int LOGN, bool INV, int BL, int W>
__device__ __forceinline__ void ntt_body(const uint32_t* __restrict__ x,
                                         uint32_t* __restrict__ y,
                                         const uint2* __restrict__ tw,
                                         const uint4* __restrict__ iscale,
                                         const uint32_t* __restrict__ primes,
                                         int units, int L) {
  using Wd = Window<LOGN, INV, BL, W>;
  extern __shared__ uint32_t smem[];
  const uint32_t unit_local = threadIdx.x >> Wd::TU_LOG;
  const uint32_t tid_u = threadIdx.x & ((1u << Wd::TU_LOG) - 1);
  uint2* staged = reinterpret_cast<uint2*>(smem);
  uint32_t* s = smem + Wd::TW_SMEM / sizeof(uint32_t) + unit_local * Wd::STRIDE;
  bool active;
  int row;
  uint32_t uu;  // the unit's index within its row
  if constexpr (Wd::CHUNKS) {
    // blocks walk (chunk, prime, UPB rows of that prime); row = k L + l
    const int per_prime = (units >> Wd::UPR_LOG) / L;
    const int per_group = (per_prime + Wd::UPB - 1) / Wd::UPB;
    const int group = blockIdx.x / per_group;
    const int k = (blockIdx.x - group * per_group) * Wd::UPB + static_cast<int>(unit_local);
    active = k < per_prime;
    row = (active ? k : 0) * L + group % L;
    uu = static_cast<uint32_t>(group / L);
  } else {
    const int u = blockIdx.x * Wd::UPB + static_cast<int>(unit_local);
    active = u < units;
    row = active ? u >> Wd::UPR_LOG : 0;
    uu = static_cast<uint32_t>(u) & ((1u << Wd::UPR_LOG) - 1);
  }
  const uint32_t unit_lo = uu & ((1u << BL) - 1);
  const uint32_t unit_hi = uu >> BL;
  const int l = row % L;
  const uint32_t p = __ldg(primes + l);
  const uint2* w = tw + (static_cast<size_t>(l) << LOGN);
  if constexpr (Wd::CHUNKS) {
    // window stage t reads 2^t pairs from 2^(t + LOGN - W) + uu 2^t on
    for (int i = threadIdx.x; i < (1 << W); i += Wd::BLOCK) {
      const int t = 31 - __clz(i | 1);
      if (i > 0) staged[i] = __ldg(w + ((1 << t) << (LOGN - W)) + (uu << t) + (i - (1 << t)));
    }
    __syncthreads();
    w = staged;
  }
  const uint4 sc = (INV && BL + W == LOGN) ? __ldg(iscale + l) : make_uint4(0, 0, 0, 0);
  const uint32_t* xr = (Wd::IN_PLACE ? y : x) + (static_cast<size_t>(row) << LOGN);
  uint32_t* yr = y + (static_cast<size_t>(row) << LOGN);
  uint32_t v[Wd::E];
  if (active) run_pass<LOGN, INV, BL, W, 0>(v, xr, yr, s, w, sc, p, unit_hi, unit_lo, tid_u);
  if constexpr (Wd::NP > 1) {
    __syncthreads();
    if (active) run_pass<LOGN, INV, BL, W, 1>(v, xr, yr, s, w, sc, p, unit_hi, unit_lo, tid_u);
  }
  if constexpr (Wd::NP > 2) {
    __syncthreads();
    if (active) run_pass<LOGN, INV, BL, W, 2>(v, xr, yr, s, w, sc, p, unit_hi, unit_lo, tid_u);
  }
}

template <int LOGN, int BL, int W>
__global__ void __launch_bounds__(Window<LOGN, false, BL, W>::BLOCK,
                                  Window<LOGN, false, BL, W>::MIN_BLOCKS)
    ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint2* __restrict__ tw, const uint32_t* __restrict__ primes,
                   int units, int L) {
  ntt_body<LOGN, false, BL, W>(x, y, tw, nullptr, primes, units, L);
}

template <int LOGN, int BL, int W>
__global__ void __launch_bounds__(Window<LOGN, true, BL, W>::BLOCK,
                                  Window<LOGN, true, BL, W>::MIN_BLOCKS)
    ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint2* __restrict__ tw, const uint4* __restrict__ iscale,
                   const uint32_t* __restrict__ primes, int units, int L) {
  ntt_body<LOGN, true, BL, W>(x, y, tw, iscale, primes, units, L);
}

struct Args {
  const uint32_t* x;
  uint32_t* y;
  const uint2* tw;
  const uint4* iscale;
  const uint32_t* primes;
  int rows, L;
  cudaStream_t stream;
};

// Launch one window over every row, one block per UPB units, from a.x (or
// in place) to a.y. The shared-memory attribute is set once per kernel and
// device.
template <int LOGN, bool INV, int BL, int W>
cudaError_t launch_window(const Args& a) {
  using Wd = Window<LOGN, INV, BL, W>;
  if constexpr (Wd::SMEM > 48 * 1024) {
    static bool attr_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      const void* fn;
      if constexpr (INV)
        fn = reinterpret_cast<const void*>(ntt_inv_kernel<LOGN, BL, W>);
      else
        fn = reinterpret_cast<const void*>(ntt_fwd_kernel<LOGN, BL, W>);
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Wd::SMEM));
      if (err != cudaSuccess) return err;
      attr_set[dev] = true;
    }
  }
  const int units = a.rows << Wd::UPR_LOG;
  const int blocks = Wd::CHUNKS
      ? (1 << Wd::UPR_LOG) * a.L * ((a.rows / a.L + Wd::UPB - 1) / Wd::UPB)
      : (units + Wd::UPB - 1) / Wd::UPB;
  const uint32_t* x = Wd::IN_PLACE ? nullptr : a.x;  // never both x and y
  if constexpr (INV)
    ntt_inv_kernel<LOGN, BL, W><<<blocks, Wd::BLOCK, Wd::SMEM, a.stream>>>(
        x, a.y, a.tw, a.iscale, a.primes, units, a.L);
  else
    ntt_fwd_kernel<LOGN, BL, W><<<blocks, Wd::BLOCK, Wd::SMEM, a.stream>>>(
        x, a.y, a.tw, a.primes, units, a.L);
  return cudaGetLastError();
}

enum Form { kAuto = 0, kWholeRow = 1, kSplit = 2 };

// Run one transform in the given form; *grids is the number of kernel
// launches it made.
template <int LOGN, bool INV>
cudaError_t run(const Args& a, int form, int* grids) {
  *grids = 0;
  if (form == kAuto) form = LOGN >= kMinSplitLogN ? kSplit : kWholeRow;
  if constexpr (LOGN >= kMinSplitLogN) {
    if (form == kSplit) {
      constexpr int TOP = LOGN - kMaxRadixLog;
      cudaError_t err;
      if constexpr (INV)  // chunks x -> y, then the top window in place
        err = launch_window<LOGN, INV, 0, TOP>(a);
      else                // the top window x -> y, then the chunks in place
        err = launch_window<LOGN, INV, TOP, kMaxRadixLog>(a);
      if (err != cudaSuccess) return err;
      *grids = 1;
      if constexpr (INV)
        err = launch_window<LOGN, INV, TOP, kMaxRadixLog>(a);
      else
        err = launch_window<LOGN, INV, 0, TOP>(a);
      if (err == cudaSuccess) *grids = 2;
      return err;
    }
  }
  if (form != kWholeRow) return cudaErrorInvalidValue;
  const cudaError_t err = launch_window<LOGN, INV, 0, LOGN>(a);
  if (err == cudaSuccess) *grids = 1;
  return err;
}

template <bool INV>
cudaError_t dispatch(const Args& a, int logn, int form, int* grids) {
  switch (logn) {
    case 4: return run<4, INV>(a, form, grids);
    case 5: return run<5, INV>(a, form, grids);
    case 6: return run<6, INV>(a, form, grids);
    case 7: return run<7, INV>(a, form, grids);
    case 8: return run<8, INV>(a, form, grids);
    case 9: return run<9, INV>(a, form, grids);
    case 10: return run<10, INV>(a, form, grids);
    case 11: return run<11, INV>(a, form, grids);
    case 12: return run<12, INV>(a, form, grids);
    case 13: return run<13, INV>(a, form, grids);
    case 14: return run<14, INV>(a, form, grids);
    case 15: return run<15, INV>(a, form, grids);
    default: return cudaErrorInvalidValue;
  }
}

int entry(const void* x, void* y, const void* tw, const void* iscale, const void* primes,
          int rows, int L, int logn, int inverse, int form, int* grids, void* stream) {
  *grids = 0;
  if (rows <= 0) return 0;
  if (logn < kMinLogN || logn > kMaxLogN || L <= 0 || rows % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
               static_cast<const uint2*>(tw), static_cast<const uint4*>(iscale),
               static_cast<const uint32_t*>(primes), rows, L,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(inverse ? dispatch<true>(a, logn, form, grids)
                                  : dispatch<false>(a, logn, form, grids));
}

}  // namespace

// x, y: (rows, n) int32 residues, row r mod primes[r % L]; tw: (L, n, 2)
// [value, Shoup quotient] pairs in bit-reversed order (the inverse pairs
// when inverse != 0); iscale: (L, 4) [n^-1, quotient, psi^-1 n^-1,
// quotient], read by the inverse only. The form is chosen from n; *grids
// receives the number of kernel launches. Returns a cudaError_t.
extern "C" int nhpsi_ntt(const void* x, void* y, const void* tw, const void* iscale,
                         const void* primes, int rows, int L, int logn, int inverse,
                         int* grids, void* stream) {
  return entry(x, y, tw, iscale, primes, rows, L, logn, inverse, kAuto, grids, stream);
}

// As nhpsi_ntt in a form forced by the caller (1 whole-row, 2 split), for
// measuring the two forms against each other; not used by the port.
extern "C" int nhpsi_ntt_form(const void* x, void* y, const void* tw, const void* iscale,
                              const void* primes, int rows, int L, int logn, int inverse,
                              int form, int* grids, void* stream) {
  if (form != kWholeRow && form != kSplit) {
    *grids = 0;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry(x, y, tw, iscale, primes, rows, L, logn, inverse, form, grids, stream);
}
