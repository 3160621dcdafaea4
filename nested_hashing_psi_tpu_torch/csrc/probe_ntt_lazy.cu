// A2: lazy-butterfly probe, 14 split-form stages in three butterfly forms.
//
// Replaces the TPU kernel of benchmarks/bench_ntt_lazy_probe.py (the `call`
// that make_variant(plan, which) returns at :142, pallas_call at :145,
// kernel at :124-140, stage forms at :89-122). Per (M, M) tile of one limb
// row: the stages of the first half down the columns with the prime's
// s1_v2 table, a transpose, the stages of the second half with s2_v2, and
// the transpose back. The tables are the regrouped ones but the data is
// never regrouped, so the function is deterministic but not an NTT. The
// forms (template VAR):
//   0 exact:   Shoup product, then add_mod / sub_mod (canonical residues);
//   1 lazy:    u reduced below 2p, w = vW - mulhi(v, W') p, out u + w and
//              u + 2p - w with no reduction (wrapping mod 2^32 with 31-bit
//              primes: the output means nothing, only the op mix counts);
//   2 lazy_ps: lazy with mulhi built from the quotient's pre-split 16-bit
//              halves, as the TPU has no 32-bit high multiply (the same
//              function as lazy).
// Bit-exact with lazy_probe_plain in
// nested_hashing_psi_tpu_torch/benchmarks/bench_ntt_lazy_probe.py.
//
// What bounds it on an H100: exact and lazy, their bytes, 201 MB read and
// written once each at (512, 6, 16384) (0.120 ms at 3.35 TB/s), a little
// more than their 352 M butterflies take on the busier integer pipe (the
// FMA pipe's 5.4-5.5 issue slots a butterfly); lazy_ps, its instructions
// (10.3 FMA-pipe slots and 10.1 ALU a butterfly, 0.217 ms).
// benchmarks/bench_ntt_lazy_probe.py bound_ms counts both by pipe from the
// kernel's SASS.
//
// Design (probe_ntt.cuh): the work is the slab of one row class alpha of a
// tile, C = M / S rows alpha + S i of all M columns (16 x 128 at M = 128),
// taken by M threads, kThreads / M slabs to a block at a time, the blocks
// of a prime walking its slabs in a grid-stride loop (no wave tail), each
// thread loading its next slab's residues before it runs this one's
// stages, so the loads overlap the integer work. Thread c loads its
// column's C residues (a warp's loads are 128 B rows) and runs the first
// half in registers (table entries indexed by row: a broadcast read). The
// slab goes through shared memory, C rows padded to W = M + S words: then
// thread t holds slab row t / S restricted to the column class beta = t % S,
// columns beta + S j, and runs the second half (entries indexed by column:
// S distinct consecutive entries per warp read). As W mod 32 = S, the
// column writes and the class reads are free of bank conflicts. The slab
// goes back the same way and is stored a row at a time. Two barriers per
// slab, among its M threads only (a named barrier; a warp sync at M = 32).
// The prime's two tables are staged in shared memory once per block.
#include <type_traits>

#include "probe_ntt.cuh"

namespace {

using namespace nhpsi_probe;

__device__ __forceinline__ uint32_t mulhi_presplit(uint32_t x, uint32_t wl, uint32_t wh) {
  const uint32_t xl = x & 0xFFFFu, xh = x >> 16;
  const uint32_t ll = xl * wl, lh = xl * wh, hl = xh * wl, hh = xh * wh;
  const uint32_t mid = (ll >> 16) + (lh & 0xFFFFu) + (hl & 0xFFFFu);
  return hh + (lh >> 16) + (hl >> 16) + (mid >> 16);
}

struct CtLazy {
  using Entry = uint2;
  uint32_t p;
  __device__ __forceinline__ void operator()(uint32_t& u, uint32_t& v, uint2 w) const {
    const uint32_t p2 = p + p;
    const uint32_t uu = min(u, u - p2);  // where(u >= 2p, u - 2p, u)
    const uint32_t x = v * w.x - __umulhi(v, w.y) * p;
    u = uu + x;
    v = uu + p2 - x;
  }
};

struct CtLazyPresplit {
  using Entry = uint4;  // value, quotient low and high halves
  uint32_t p;
  __device__ __forceinline__ void operator()(uint32_t& u, uint32_t& v, uint4 w) const {
    const uint32_t p2 = p + p;
    const uint32_t uu = min(u, u - p2);
    const uint32_t x = v * w.x - mulhi_presplit(v, w.y, w.z) * p;
    u = uu + x;
    v = uu + p2 - x;
  }
};

template <int VAR>
using Form = std::conditional_t<VAR == 0, CtExact, std::conditional_t<VAR == 1, CtLazy, CtLazyPresplit>>;

template <int M, int VAR>
constexpr size_t smem_bytes() {
  return 2 * ilog2(M) * M * sizeof(typename Form<VAR>::Entry) +
         sizeof(uint32_t) * (kThreads / M) * kClass<M> * (M + kStride<M>);
}

// The barrier of one slab's M threads.
template <int M>
__device__ __forceinline__ void slab_sync() {
  if constexpr (M == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + static_cast<int>(threadIdx.x) / M), "r"(M)
                 : "memory");
  }
}

template <int M, int VAR>
__global__ void __launch_bounds__(kThreads) ntt_lazy_kernel(const uint32_t* __restrict__ x,
                                                            uint32_t* __restrict__ y,
                                                            const uint32_t* __restrict__ sa,
                                                            const uint32_t* __restrict__ sb,
                                                            const uint32_t* __restrict__ primes,
                                                            int B, int L) {
  using BF = Form<VAR>;
  using T = typename BF::Entry;
  constexpr int LOG = ilog2(M), S = kStride<M>, C = kClass<M>, W = M + S;
  static_assert(kThreads / M + 1 <= 16, "one named barrier per slab group");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);
  T* tb = ta + LOG * M;
  uint32_t* slab = reinterpret_cast<uint32_t*>(tb + LOG * M) + threadIdx.x / M * C * W;
  const SlabWalk w = slab_walk<M>(B, L);
  stage_table<M>(ta, sa + static_cast<size_t>(w.l) * 2 * LOG * M);
  stage_table<M>(tb, sb + static_cast<size_t>(w.l) * 2 * LOG * M);
  const BF bf{__ldg(primes + w.l)};
  __syncthreads();
  const int t = threadIdx.x % M;  // first half: column t
  const int beta = t % S;         // second half: slab row t / S, columns beta + S j
  uint32_t* row = slab + t / S * W + beta;
  uint32_t a[C], next[C];
  if (w.first < w.end) load_class<M>(next, x + slab_at<M>(w.first, w.l, L, t));
#pragma unroll 1
  for (int s = w.first; s < w.end; s += w.stride) {
#pragma unroll
    for (int i = 0; i < C; ++i) a[i] = next[i];
    // the next slab's loads are in flight while this one's stages run
    if (s + w.stride < w.end) load_class<M>(next, x + slab_at<M>(s + w.stride, w.l, L, t));
    const int alpha = s % S;
    run_half<M, 0>(a, ta + alpha, bf);
#pragma unroll
    for (int i = 0; i < C; ++i) slab[i * W + t] = a[i];
    slab_sync<M>();  // the transpose: row t / S of class beta
#pragma unroll
    for (int j = 0; j < C; ++j) a[j] = row[S * j];
    run_half<M, 0>(a, tb + beta, bf);
#pragma unroll
    for (int j = 0; j < C; ++j) row[S * j] = a[j];
    slab_sync<M>();  // and back: column t again
    uint32_t* out = y + slab_at<M>(s, w.l, L, t);
#pragma unroll
    for (int i = 0; i < C; ++i) out[i * S * M] = slab[i * W + t];
    // no third barrier: the next slab's column writes touch only column t,
    // which only this thread reads here
  }
}

template <int M, int VAR>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint32_t* sa, const uint32_t* sb,
                   const uint32_t* primes, int B, int L, cudaStream_t s) {
  static int found[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<M, VAR>();
  static_assert(smem <= 48 * 1024, "the probe needs no opt-in shared memory");
  int resident = 0;
  const cudaError_t err = resident_blocks(ntt_lazy_kernel<M, VAR>, smem, found, &resident);
  if (err != cudaSuccess) return err;
  ntt_lazy_kernel<M, VAR><<<slab_grid<M>(resident, B, L), kThreads, smem, s>>>(x, y, sa, sb,
                                                                               primes, B, L);
  return cudaGetLastError();
}

template <int M>
cudaError_t by_variant(int variant, const uint32_t* x, uint32_t* y, const uint32_t* sa,
                       const uint32_t* sb, const uint32_t* primes, int B, int L, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<M, 0>(x, y, sa, sb, primes, B, L, s);
    case 1: return launch<M, 1>(x, y, sa, sb, primes, B, L, s);
    case 2: return launch<M, 2>(x, y, sa, sb, primes, B, L, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (B, L, m * m) uint32, limb l mod primes[l]; sa, sb: (L, 2, log2 m,
// m) the plan's s1_v2 and s2_v2 tables; variant 0 exact, 1 lazy, 2
// lazy_ps; m in {32, 64, 128}. Returns a cudaError_t.
extern "C" int nhpsi_probe_ntt_lazy(const void* x, void* y, const void* sa, const void* sb,
                                    const void* primes, int B, int L, int m, int variant,
                                    void* stream) {
  if (B <= 0) return 0;
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* yo = static_cast<uint32_t*>(y);
  const auto* a = static_cast<const uint32_t*>(sa);
  const auto* b = static_cast<const uint32_t*>(sb);
  const auto* p = static_cast<const uint32_t*>(primes);
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 32: return static_cast<int>(by_variant<32>(variant, xi, yo, a, b, p, B, L, s));
    case 64: return static_cast<int>(by_variant<64>(variant, xi, yo, a, b, p, B, L, s));
    case 128: return static_cast<int>(by_variant<128>(variant, xi, yo, a, b, p, B, L, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
