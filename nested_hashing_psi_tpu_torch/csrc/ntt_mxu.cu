// K3: the negacyclic NTT / inverse NTT as int8 digit products on the tensor
// cores, one block per (batch, limb) row.
//
// Replaces the TPU kernel ntt_mxu_pallas / intt_mxu_pallas of
// nested_hashing_psi_tpu/ops/ntt_mxu.py (entries :323 and :330, pallas_call
// at :295, body _make_kernel at :266). Same contract as K1 (csrc/ntt.cu):
// x (..., L, n) residues mod 31-bit primes, forward to canonical bit-reversed
// order, inverse back with 1/n; bit-exact with the plain version in
// nested_hashing_psi_tpu_torch/ops/ntt_mxu.py and with K1.
//
// A row is the m1 x m2 matrix X (n = m1 * m2). The four-step stages are
//   forward  C = M1 @ X, D = C * T (Montgomery), S = D @ M2T
//   inverse  D = X @ iM2T, C = D * iT, X = C @ iM1
// and each product runs on five 7-bit digits of the data, stacked along the
// contraction axis, against the plan's int8 digit matrices G_i: Q_i =
// G_i @ digits in int32 is exact (Q_i <= 5 * m * 127^2 < 2^25), and three
// Montgomery products recombine sum_i 2^(7i) Q_i mod p.
//
// What bounds it on an H100: per row and stage 5 * m1 * m2 * 5m int8
// multiply-adds (52 M at n = 16384) on the int8 tensor cores, fed by the
// digit stack in shared memory and by the G_i, 400 KB per prime and stage
// at n = 16384, which every row of one prime shares and which are read
// through L2 (they do not fit in shared memory). This simple form loads one
// G fragment from L2 for every tensor-core product, so it is bound by L2
// fragment loads rather than by the tensor cores; wgmma, TMA and keeping G
// tiles resident across output tiles are later work.
//
// Design: the digit split, the products, the recombination and the twiddle
// are fused; no digit tensor and no Q_i reaches device memory. The digit
// stack (5n bytes) lives in shared memory in 16x16 row-major tiles, so every
// wmma fragment load is 256-byte aligned; the plan stores the G_i in the
// same tiled layout. Each warp computes 16x16 output tiles: five int32
// accumulators, one per digit matrix, recombined element by element (the
// five fragments share one layout), then staged through a per-warp 1 KB
// buffer to apply the twiddle by position and store. Up to n = 16384 both
// stages run in one launch, the intermediate in shared memory (9n bytes +
// 16 KB: 160 KB at 16384). Above that one row's working set does not fit,
// so each stage is its own launch with the intermediate in device memory
// (5n bytes + 16 KB: 176 KB at 32768). m1 and m2 must be multiples of 16.
// One block per SM fits, so a block has 16 warps to hide the L2 latency.
#include <cuda_runtime.h>
#include <mma.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

using namespace nvcuda;
using nhpsi::add_mod;
using nhpsi::mont_mul;

constexpr int kDigits = 5;
constexpr int kDigitBits = 7;
constexpr int kTile = 16;
constexpr int kTileBytes = kTile * kTile;  // one 16x16 int8 tile
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = kWarps * kTileBytes * 4;  // per-warp int32 tiles
constexpr int kMaxSmem = 227 * 1024;

enum Mode { kBoth = 0, kFirst = 1, kSecond = 2 };

// Byte offset of element (r, c) of an int8 matrix with `cols` columns kept
// as 16x16 row-major tiles, tile rows outermost.
__device__ __forceinline__ int tile_off(int r, int c, int cols) {
  return ((r >> 4) * (cols >> 4) + (c >> 4)) * kTileBytes + ((r & 15) << 4) +
         (c & 15);
}

// Digits of X[a][b] = v into the stack of a left stage ((5 m1) x m2, row
// j*m1 + a) or of a right stage (m1 x (5 m2), column j*m2 + b).
__device__ __forceinline__ void put_digits(int8_t* dig, uint32_t v, int a,
                                           int b, int m1, int m2, bool left) {
#pragma unroll
  for (int j = 0; j < kDigits; ++j) {
    const int8_t d = static_cast<int8_t>((v >> (kDigitBits * j)) & 127u);
    dig[left ? tile_off(j * m1 + a, b, m2)
             : tile_off(a, j * m2 + b, kDigits * m2)] = d;
  }
}

// Bytes of one prime's five digit matrices for a left / right stage.
__host__ __device__ __forceinline__ size_t g_bytes(bool left, int m1, int m2) {
  return left ? static_cast<size_t>(kDigits) * m1 * kDigits * m1
              : static_cast<size_t>(kDigits) * kDigits * m2 * m2;
}

// One stage, out = G @ digits (left) or digits @ G (right) mod p, over every
// 16x16 tile of the m1 x m2 result. g: this prime's five tiled digit
// matrices. The result goes to dst (row-major, shared or device memory),
// times tw (Montgomery form) when tw is given.
template <bool kLeft>
__device__ void mxu_stage(const int8_t* dig, const int8_t* __restrict__ g,
                          int m1, int m2, uint32_t p, uint32_t pinv,
                          const uint32_t rc[3], const uint32_t* __restrict__ tw,
                          uint32_t* dst, int* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TR = m1 / kTile, TC = m2 / kTile;
  const int KT = (kLeft ? kDigits * m1 : kDigits * m2) / kTile;
  const size_t g_digit = g_bytes(kLeft, m1, m2) / kDigits;
  wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, signed char,
                 wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, signed char,
                 wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, int> acc[kDigits];
  for (int t = warp; t < TR * TC; t += kWarps) {
    const int r = t / TC, c = t % TC;
#pragma unroll
    for (int i = 0; i < kDigits; ++i) wmma::fill_fragment(acc[i], 0);
    for (int kk = 0; kk < KT; ++kk) {
      if (kLeft) {
        wmma::load_matrix_sync(fb, dig + (kk * TC + c) * kTileBytes, kTile);
#pragma unroll
        for (int i = 0; i < kDigits; ++i) {
          wmma::load_matrix_sync(
              fa, g + i * g_digit + static_cast<size_t>(r * KT + kk) * kTileBytes,
              kTile);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      } else {
        wmma::load_matrix_sync(fa, dig + (r * KT + kk) * kTileBytes, kTile);
#pragma unroll
        for (int i = 0; i < kDigits; ++i) {
          wmma::load_matrix_sync(
              fb, g + i * g_digit + static_cast<size_t>(kk * TC + c) * kTileBytes,
              kTile);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    // S = [A * 2^32 + B * 2^14 * 2^32 + Q_4 * 2^28 * 2^32]_p in REDC form;
    // A = Q_0 + 2^7 Q_1 and B = Q_2 + 2^7 Q_3 stay below 2^32.
#pragma unroll
    for (int e = 0; e < acc[0].num_elements; ++e) {
      const uint32_t A = static_cast<uint32_t>(acc[0].x[e]) +
                         (static_cast<uint32_t>(acc[1].x[e]) << kDigitBits);
      const uint32_t B = static_cast<uint32_t>(acc[2].x[e]) +
                         (static_cast<uint32_t>(acc[3].x[e]) << kDigitBits);
      uint32_t s = add_mod(mont_mul(A, rc[0], p, pinv),
                           mont_mul(B, rc[1], p, pinv), p);
      s = add_mod(s, mont_mul(static_cast<uint32_t>(acc[4].x[e]), rc[2], p, pinv),
                  p);
      acc[0].x[e] = static_cast<int>(s);
    }
    wmma::store_matrix_sync(stage, acc[0], kTile, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < kTileBytes; e += 32) {
      const int a = r * kTile + (e >> 4), b = c * kTile + (e & 15);
      uint32_t v = static_cast<uint32_t>(stage[e]);
      if (tw != nullptr) v = mont_mul(v, tw[a * m2 + b], p, pinv);
      dst[a * m2 + b] = v;
    }
    __syncwarp();
  }
}

// ga / gb: the first / second stage's tiled digit matrices for all L primes
// (forward: G1 then G2; inverse: iG2 then iG1); tw: (L, m1, m2) Montgomery
// twiddles of the first stage; rcs: (L, 3) recombination constants.
__global__ void __launch_bounds__(kThreads)
    ntt_mxu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const int8_t* __restrict__ ga, const int8_t* __restrict__ gb,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ rcs,
                   const uint32_t* __restrict__ primes,
                   const uint32_t* __restrict__ pinvs, int L, int m1, int m2,
                   int inverse, int mode) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int n = m1 * m2;
  const int row = blockIdx.x;
  const int l = row % L;
  const uint32_t p = primes[l], pinv = pinvs[l];
  const uint32_t rc[3] = {rcs[3 * l], rcs[3 * l + 1], rcs[3 * l + 2]};
  int* stage = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * kTileBytes;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kStageBytes);
  int8_t* dig = reinterpret_cast<int8_t*>(smem + kStageBytes +
                                          (mode == kBoth ? 4 * n : 0));
  const uint32_t* src = x + static_cast<size_t>(row) * n;
  uint32_t* dst = y + static_cast<size_t>(row) * n;
  const bool first_left = !inverse;  // forward starts with M1 @ X

  if (mode != kSecond) {
    for (int i = threadIdx.x; i < n; i += kThreads)
      put_digits(dig, src[i], i / m2, i % m2, m1, m2, first_left);
    __syncthreads();
    uint32_t* out = mode == kBoth ? xs : dst;
    const int8_t* g = ga + l * g_bytes(first_left, m1, m2);
    const uint32_t* twl = tw + static_cast<size_t>(l) * n;
    if (first_left)
      mxu_stage<true>(dig, g, m1, m2, p, pinv, rc, twl, out, stage);
    else
      mxu_stage<false>(dig, g, m1, m2, p, pinv, rc, twl, out, stage);
    if (mode == kFirst) return;
    __syncthreads();
  }
  const uint32_t* mid = mode == kBoth ? xs : src;
  for (int i = threadIdx.x; i < n; i += kThreads)
    put_digits(dig, mid[i], i / m2, i % m2, m1, m2, !first_left);
  __syncthreads();
  const int8_t* g = gb + l * g_bytes(!first_left, m1, m2);
  if (first_left)
    mxu_stage<false>(dig, g, m1, m2, p, pinv, rc, nullptr, dst, stage);
  else
    mxu_stage<true>(dig, g, m1, m2, p, pinv, rc, nullptr, dst, stage);
}

cudaError_t launch(const void* x, void* y, const void* ga, const void* gb,
                   const void* tw, const void* rcs, const void* primes,
                   const void* pinvs, int rows, int L, int m1, int m2,
                   int inverse, int mode, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(ntt_mxu_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ntt_mxu_kernel<<<rows, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int8_t*>(ga), static_cast<const int8_t*>(gb),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(rcs),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinvs),
      L, m1, m2, inverse, mode);
  return cudaGetLastError();
}

}  // namespace

// tmp: a buffer like y, used (and required) only when both stages do not fit
// one block's shared memory; then the first launch writes the twiddled
// intermediate there and the second reads it.
extern "C" int nhpsi_ntt_mxu(const void* x, void* y, void* tmp, const void* ga,
                             const void* gb, const void* tw, const void* rcs,
                             const void* primes, const void* pinvs, int rows,
                             int L, int m1, int m2, int inverse, void* stream) {
  if (rows <= 0) return 0;
  if (m1 <= 0 || m2 <= 0 || m1 % kTile || m2 % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(m1) * m2;
  const size_t both = kStageBytes + 9 * n, one = kStageBytes + 5 * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (both <= kMaxSmem)
    return static_cast<int>(launch(x, y, ga, gb, tw, rcs, primes, pinvs, rows,
                                   L, m1, m2, inverse, kBoth, both, s));
  if (one > kMaxSmem || tmp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch(x, tmp, ga, gb, tw, rcs, primes, pinvs, rows, L, m1,
                           m2, inverse, kFirst, one, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(tmp, y, ga, gb, tw, rcs, primes, pinvs, rows,
                                 L, m1, m2, inverse, kSecond, one, s));
}
