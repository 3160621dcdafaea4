// A1: uint32 op-rate probe, chained applications of one op mix.
//
// Replaces the TPU kernel of benchmarks/bench_vpu_ops.py (the `call` that
// make(name) returns at :101, pallas_call at :102, kernel at :93-99). The
// function: c = x + 12345, p = 2^31 - 2^20 + 1, then x <- f(x, c, p) K
// times, per element; bit-exact with vpu_ops_plain in
// nested_hashing_psi_tpu_torch/benchmarks/bench_vpu_ops.py (fmul: NaNs
// compare as one class). Every mix wraps mod 2^32 like the JAX formulas;
// the modarith.cuh helpers compute those same functions for any 32-bit
// inputs (csub is min(x, x - p), which equals where(x >= p, x - p, x)
// unsigned; __umulhi is JAX's mulhi_u32 exactly).
//
// What bounds it on an H100: its instructions, at any K large enough that
// one launch outlasts its 8 MB of bytes (K = 64 at (64, 128, 128) is
// about 2 us of either). The rate run uses K = 2^15.
//
// Design: each thread keeps kElems elements (strided by the grid, so the
// loads and stores coalesce) and runs their kElems independent chains in
// registers, kUnroll applications per pass of a runtime loop. An empty
// asm statement that claims to change x follows every application: it
// emits no instruction, but the compiler can no longer fold the chain (64
// wrapping adds into one multiply-add, 64 multiplies by a constant into a
// few squarings); ptxas may still pair two adds of `add` into one
// three-input IADD3, which is the hardware doing both. chip_smoke.py counts
// the loop body's SASS instructions per application and fails below half
// an instruction per application: a folded chain. fmul multiplies with
// PTX mul.rn.ftz.f32 (subnormal inputs and results flushed to signed zero,
// as XLA computes it): the build's flags are shared by every source, so
// the flush is asked for per instruction.
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kUnroll = 16;  // applications per pass (bench_vpu_ops.UNROLL)
constexpr int kElems = 4;    // elements per thread (bench_vpu_ops.ELEMS)
constexpr int kThreads = 256;
constexpr uint32_t kP = (1u << 31) - (1u << 20) + 1u;
constexpr uint32_t kOffset = 12345u;

enum Mix {
  kAdd, kMul, kAddMul, kWhereGe, kMulHi, kShoup, kShoupLazy, kMont, kAddMod, kFMul,
  kMul4Ilp, kMixes
};

__device__ __forceinline__ uint32_t fmul_ftz(uint32_t a, uint32_t b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(r);
}

template <int MIX>
__device__ __forceinline__ uint32_t apply(uint32_t x, uint32_t c) {
  if constexpr (MIX == kAdd) return x + c;
  if constexpr (MIX == kMul) return x * c;
  if constexpr (MIX == kAddMul) return x * c + c;
  if constexpr (MIX == kWhereGe) return x >= kP ? x - kP : x;
  if constexpr (MIX == kMulHi) return __umulhi(x, c);
  if constexpr (MIX == kShoup) return nhpsi::shoup_mul(x, c, c, kP);
  if constexpr (MIX == kShoupLazy) return x * c - __umulhi(x, c) * kP;
  if constexpr (MIX == kMont) return nhpsi::mont_mul(x, c, kP, c | 1u);
  if constexpr (MIX == kAddMod) return nhpsi::csub(x + c, kP);
  if constexpr (MIX == kFMul) return fmul_ftz(x, c);
  if constexpr (MIX == kMul4Ilp) return (x * c) ^ (x * (c + 1u)) ^ (x * (c + 2u)) ^ (x * (c + 3u));
  return x;
}

template <int MIX>
__device__ __forceinline__ void step(uint32_t (&v)[kElems], const uint32_t (&c)[kElems]) {
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    v[j] = apply<MIX>(v[j], c[j]);
    asm volatile("" : "+r"(v[j]));
  }
}

template <int MIX>
__global__ void __launch_bounds__(kThreads) vpu_ops_kernel(const uint32_t* __restrict__ x,
                                                           uint32_t* __restrict__ y, int n,
                                                           int passes, int rest) {
  const long long grid = static_cast<long long>(gridDim.x) * kThreads;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t v[kElems], c[kElems];
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const long long i = g + j * grid;
    v[j] = i < n ? __ldg(x + i) : 0u;
    c[j] = v[j] + kOffset;
  }
#pragma unroll 1
  for (int o = 0; o < passes; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step<MIX>(v, c);
  }
#pragma unroll 1
  for (int o = 0; o < rest; ++o) step<MIX>(v, c);
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const long long i = g + j * grid;
    if (i < n) y[i] = v[j];
  }
}

template <int MIX>
cudaError_t launch(const uint32_t* x, uint32_t* y, int n, int k, cudaStream_t s) {
  const long long threads = (static_cast<long long>(n) + kElems - 1) / kElems;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  vpu_ops_kernel<MIX><<<blocks, kThreads, 0, s>>>(x, y, n, k / kUnroll, k % kUnroll);
  return cudaGetLastError();
}

}  // namespace

// x, y: n uint32; mix: the index in bench_vpu_ops.MIXES; k applications.
// Returns a cudaError_t.
extern "C" int nhpsi_probe_vpu_ops(const void* x, void* y, int n, int mix, int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || mix < 0 || mix >= kMixes) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* yo = static_cast<uint32_t*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mix) {
    case kAdd: err = launch<kAdd>(xi, yo, n, k, s); break;
    case kMul: err = launch<kMul>(xi, yo, n, k, s); break;
    case kAddMul: err = launch<kAddMul>(xi, yo, n, k, s); break;
    case kWhereGe: err = launch<kWhereGe>(xi, yo, n, k, s); break;
    case kMulHi: err = launch<kMulHi>(xi, yo, n, k, s); break;
    case kShoup: err = launch<kShoup>(xi, yo, n, k, s); break;
    case kShoupLazy: err = launch<kShoupLazy>(xi, yo, n, k, s); break;
    case kMont: err = launch<kMont>(xi, yo, n, k, s); break;
    case kAddMod: err = launch<kAddMod>(xi, yo, n, k, s); break;
    case kFMul: err = launch<kFMul>(xi, yo, n, k, s); break;
    default: err = launch<kMul4Ilp>(xi, yo, n, k, s); break;
  }
  return static_cast<int>(err);
}
