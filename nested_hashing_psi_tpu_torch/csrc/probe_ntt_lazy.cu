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
// What bounds it on an H100: its bytes. A (512, 6, 16384) call reads and
// writes 201 MB once each (0.120 ms at 3.35 TB/s); its 352 M butterflies
// take 0.084 ms at 8 instructions each at 33.5 T/s (the pre-split form
// needs more).
//
// Design (probe_ntt.cuh): a block of M threads takes kRowsPerBlock rows of
// one prime and stages the prime's two tables in shared memory once. Per
// row, thread j loads column j (coalesced) into registers and runs the
// first half's stages there; the tile goes through shared memory (padded
// to M + 1 words a row, so column writes and row reads are free of bank
// conflicts); thread i runs the second half on row i; the tile goes back
// through shared memory and thread j stores column j.
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
  return 2 * ilog2(M) * M * sizeof(typename Form<VAR>::Entry) + sizeof(uint32_t) * M * (M + 1);
}

template <int M, int VAR>
__global__ void __launch_bounds__(M) ntt_lazy_kernel(const uint32_t* __restrict__ x,
                                                     uint32_t* __restrict__ y,
                                                     const uint32_t* __restrict__ sa,
                                                     const uint32_t* __restrict__ sb,
                                                     const uint32_t* __restrict__ primes, int B,
                                                     int L) {
  using BF = Form<VAR>;
  using T = typename BF::Entry;
  constexpr int LOG = ilog2(M), S = M + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);
  T* tb = ta + LOG * M;
  uint32_t* d = reinterpret_cast<uint32_t*>(tb + LOG * M);
  const int l = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * kRowsPerBlock;
  stage_table<M>(ta, sa + static_cast<size_t>(l) * 2 * LOG * M);
  stage_table<M>(tb, sb + static_cast<size_t>(l) * 2 * LOG * M);
  const BF bf{__ldg(primes + l)};
  __syncthreads();
  const int j = threadIdx.x;
  uint32_t a[M];
  const int b1 = min(B, b0 + kRowsPerBlock);
#pragma unroll 1
  for (int b = b0; b < b1; ++b) {
    const size_t base = (static_cast<size_t>(b) * L + l) * M * M;
#pragma unroll
    for (int r = 0; r < M; ++r) a[r] = __ldg(x + base + r * M + j);
    run_half<M, 0>(a, ta, bf);
#pragma unroll
    for (int r = 0; r < M; ++r) d[r * S + j] = a[r];
    __syncthreads();  // the transpose: thread j now takes row j
#pragma unroll
    for (int c = 0; c < M; ++c) a[c] = d[j * S + c];
    run_half<M, 0>(a, tb, bf);
#pragma unroll
    for (int c = 0; c < M; ++c) d[j * S + c] = a[c];
    __syncthreads();  // and back: column j again
#pragma unroll
    for (int r = 0; r < M; ++r) y[base + r * M + j] = d[r * S + j];
    __syncthreads();
  }
}

template <int M, int VAR>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint32_t* sa, const uint32_t* sb,
                   const uint32_t* primes, int B, int L, cudaStream_t s) {
  static bool attr[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<M, VAR>();
  cudaError_t err = allow_smem(ntt_lazy_kernel<M, VAR>, smem, attr);
  if (err != cudaSuccess) return err;
  ntt_lazy_kernel<M, VAR><<<blocks_for(B, L), M, smem, s>>>(x, y, sa, sb, primes, B, L);
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
