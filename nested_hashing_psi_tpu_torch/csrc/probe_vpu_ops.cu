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
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; measured
// with benchmarks/probe_sweep.py of the port, which reads each call's
// device time from a CUDA graph of chained calls). At K = 2^15 (the rate
// run) the busier pipe's issue slots: the chains are all there is. At K =
// 64 on the JAX probe's (64, 128, 128) the chains take 2-30 us, and x and
// the result, 8 MB, take 2.5 us at 3.35 TB/s (less from L2, where a chain
// of calls finds its input). A one-wave launch that loads everything, runs
// every chain, then stores everything takes about 2 us beyond its chains,
// and most of that is the gap between one launch's end and the next one's
// start: splitting the work into 2-8 tiles a block, so that loads run
// under chains, was slower, since a quarter to a half of the warps run the
// chains more slowly than the overlap saves.
//
// Design. A tile is kThreads 16-byte vectors of x: a thread takes one
// vector, four elements, and runs their four independent chains in
// registers, kUnroll applications per pass of a runtime loop, then the
// rest of K. The grid is persistent: as many blocks as the SMs hold at
// once (the occupancy API, found once per device), or one a tile where
// there are fewer tiles, walking the tiles in a grid-stride loop. Each
// thread copies its vectors with cp.async into a ring of kStages slots in
// shared memory and issues tile t + kStages - 1's copy before it waits for
// tile t, so the next tiles' loads run under this tile's chains; it writes
// the result with one 16-byte store, which retires while the next tile
// computes. At the JAX probe's shape the SMs hold all 1024 tiles at once,
// so a block has one; a larger array gives each several. Each launch is a
// programmatic dependent of the kernel before it on the stream (PDL): its
// blocks wait in griddepcontrol.wait until that grid has finished, then
// let the next launch begin, so the next call's launch and dispatch run
// under this call's chains, which is what moves K = 64. cp.async and not a
// TMA bulk copy: a thread reads back only the 16 bytes it copied itself,
// so cp.async.wait_group orders copy and read without a block barrier or
// an mbarrier, and the ragged last vector is the same instruction with
// fewer source bytes (the rest zero-filled). The kernel masks the ragged
// last tile itself: a vector past n copies nothing and stores nothing, a
// partial one stores its elements one by one. Index arithmetic is 32-bit
// (n < 2^31) and divides by nothing known only at run time: a 64-bit
// division before the first copy delayed every launch's loads. x and y
// must be 16-byte aligned (the wrapper copies an unaligned x).
//
// What keeps the rate right: an empty asm statement that claims to change
// x follows every application. It emits no instruction, but the compiler
// can no longer fold the chain (64 wrapping adds into one multiply-add, 64
// multiplies by a constant into a few squarings); ptxas may still pair two
// adds of `add` into one three-input IADD3, which is the hardware doing
// both. chip_smoke.py counts the chain loop's SASS instructions per
// application and fails below the fewest one application can take: a
// folded chain. fmul multiplies with PTX mul.rn.ftz.f32 (subnormal inputs
// and results flushed to signed zero, as XLA computes it): the build's
// flags are shared by every source, so the flush is asked for per
// instruction.
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"
#include "probe_ntt.cuh"  // resident_blocks, kMaxDevices

namespace {

constexpr int kUnroll = 16;  // applications per pass (bench_vpu_ops.UNROLL)
constexpr int kElems = 4;    // elements per thread and tile, one vector (bench_vpu_ops.ELEMS)
constexpr int kThreads = nhpsi_probe::kThreads;  // 256 (bench_vpu_ops.THREADS)
constexpr int kTile = kThreads * kElems;  // elements (bench_vpu_ops.TILE)
constexpr int kStages = 3;  // the cp.async ring: tiles in flight per thread
// 8 blocks, 2048 threads an SM: at most 32 registers a thread, which
// every mix fits in without spilling (chip_smoke.py's [sass] checks), and
// under which ptxas keeps mont's chain at the one-wave kernel's rate
constexpr int kBlocksPerSm = 8;
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

// 16 bytes (src_bytes of them read, the rest zero-filled) global -> shared,
// cached in L2 only.
__device__ __forceinline__ void copy16(uint4* dst, const uint32_t* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

template <int MIX>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    vpu_ops_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, unsigned n,
                   int passes, int rest) {
  __shared__ uint4 ring[kStages][kThreads];
  // launched as a programmatic dependent of the kernel before it on the
  // stream: wait until that grid has finished and its writes are visible,
  // then let the next launch begin, so its launch and block dispatch run
  // under this grid's chains
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  // n < 2^31, so every element index, and one tile past the last, fits 32 bits
  const unsigned tiles = (n + kTile - 1) / kTile;
  auto first = [](unsigned tile) { return (tile * kThreads + threadIdx.x) * kElems; };
  // this thread's vector of `tile` into ring slot `slot`, as one commit
  // group; past the last tile the group is empty, so the waits count alike
  auto issue = [&](unsigned tile, int slot) {
    if (tile < tiles) {
      const unsigned e = first(tile);
      const int bytes = e + kElems <= n ? 16 : e < n ? static_cast<int>(n - e) * 4 : 0;
      copy16(&ring[slot][threadIdx.x], bytes ? x + e : x, bytes);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  int slot = 0;  // this tile's slot; the one before it is free again
#pragma unroll 1
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    issue(tile + (kStages - 1) * gridDim.x, slot == 0 ? kStages - 1 : slot - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    const uint4 in = ring[slot][threadIdx.x];
    slot = slot + 1 == kStages ? 0 : slot + 1;
    uint32_t v[kElems] = {in.x, in.y, in.z, in.w}, c[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) c[j] = v[j] + kOffset;
#pragma unroll 1
    for (int o = 0; o < passes; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) step<MIX>(v, c);
    }
#pragma unroll 1
    for (int o = 0; o < rest; ++o) step<MIX>(v, c);
    const unsigned e = first(tile);
    if (e + kElems <= n) {
      *reinterpret_cast<uint4*>(y + e) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kElems; ++j)
        if (e + j < n) y[e + j] = v[j];
    }
  }
}

template <int MIX>
cudaError_t launch(const uint32_t* x, uint32_t* y, int n, int k, cudaStream_t s) {
  static int found[nhpsi_probe::kMaxDevices] = {};
  int resident = 0;
  const cudaError_t err = nhpsi_probe::resident_blocks(vpu_ops_kernel<MIX>, 0, found, &resident);
  if (err != cudaSuccess) return err;
  const int tiles = static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
  const int grid = tiles < resident ? tiles : resident;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, vpu_ops_kernel<MIX>, x, y,
                                                  static_cast<unsigned>(n), k / kUnroll,
                                                  k % kUnroll);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

// x, y: n uint32, 16-byte aligned; mix: the index in bench_vpu_ops.MIXES;
// k applications. Returns a cudaError_t.
extern "C" int nhpsi_probe_vpu_ops(const void* x, void* y, int n, int mix, int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || mix < 0 || mix >= kMixes) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
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
