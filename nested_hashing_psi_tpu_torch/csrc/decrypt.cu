// The client's decrypt: phase coefficients to the per-slot zero mask, in one
// launch, for BFV-form and BGV-form results.
//
//   y_i  = [x_i * (q/q_i)^-1]_{q_i}                          (each limb i)
//   BFV: m = ((sum_i y_i * T_i + 2^71) >> 72) mod t,  T_i = floor(t 2^72 / q_i)
//   BGV: k = (sum_i y_i * F_i + 2^71) >> 72,          F_i = floor(2^72 / q_i)
//        m = (sum_i y_i [q/q_i]_t - k [q]_t) mod t
//   mask[s] = (NTT_t(m)[s2n[s]] == 0)                       (s < length)
//
// Replaces no TPU kernel: the JAX package decrypts with plain jnp arithmetic
// (nested_hashing_psi_tpu/fhe/device_decrypt.py) and has no Pallas decrypt.
// It was added because the port's plain version of the same function
// (DeviceDecryptor in nested_hashing_psi_tpu_torch/fhe/device_decrypt.py,
// two-plane int64 arithmetic from ops/mod64.py) launches some 2,900 small
// kernels a call, and a BGV-form result had no device decrypt at all. Its
// mask is bit-exact with that plain version's: the BFV front is the plain
// version's 96-bit fixed-point sum taken in 128-bit integers; the BGV front
// rounds k = round(sum_i y_i / q_i) from 72 fraction bits, which agrees
// with the host decrypt's float64 k while the noise budget holds (|x| far
// below q/2, so the sum's fraction is far from one half).
//
// Input: the phase (rows, L, n) int32, the coefficients of c0 + c1*s after
// K1's inverse NTT, any leading shape flattened into rows. Output: (rows,
// length) bytes, 1 where the slot is 0. The tracked ciphertext scale is a
// unit mod t, so it never changes which slots are zero and is not read.
//
// What bounds it on an H100: operations, by a little (benchmarks/card.py
// decrypt_bound: 0.0017 / 0.0040 ms at the benchmark cells' 12 rows of
// 16384 on L = 4 / 9 limbs, whose phase is 3.1 / 7.1 MB). A row's work is
// one CRT per coefficient and a negacyclic NTT mod a t of up to 62 bits,
// n/2 log2 n butterflies of 64-bit Shoup products, each some 16 FMA-pipe
// slots of 32-bit multiplies. What it meets instead is latency: each stage
// is a barrier, and one block a row leaves most SMs idle (12 of 132 at
// the cells' shapes: 0.085 / 0.137 ms measured, against 0.028 / 0.035 ms
// split over clusters of 8, on an H100).
//
// Design:
// - A row's m values stay on chip from the CRT to the zero test: a block
//   holds its part of the row in shared memory as uint64, and the mask is
//   the only write. Nothing of a row goes back to device memory.
// - One row per thread-block cluster of C blocks (C = 8 at n = 16384, one
//   per 2048 coefficients up to 8), so the cells' 12 rows fill 96 SMs and
//   not 12. Each block takes the CRT of its n/C coefficients; the first
//   log2 C stages of the transform pair coefficients in different blocks and
//   read the partner from its block's shared memory (distributed shared
//   memory), every block computing its own outputs into registers between
//   two cluster barriers; the later stages are local, one barrier each; the
//   gather through s2n reads across the cluster again. Rows below 4096
//   coefficients take C = 1, the plain one-block-per-row form.
// - The transform is the plain version's (mod64.ntt2_mod_t, the order of
//   the encoder's ntt_numpy): Cooley-Tukey with bit-reversed psi powers and
//   their 64-bit Shoup quotients, t < 2^62, so every sum stays below 2^64.
//   Outputs of every butterfly are canonical, so the zero test is exact.
// - Constants are one uint64 table per (form, limb count), built once by
//   the caller (ops/decrypt_cuda.py constants()), read through the cache.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace cg = cooperative_groups;

namespace {

// the constant table: kHead words, then kLimbWords per limb
constexpr int kHead = 4;       // t, [q]_t, its Shoup quotient, 0
constexpr int kLimbWords = 8;  // q_i, inv_i, Shoup(inv_i), T_lo, T_hi, h_i, Shoup(h_i), 0
constexpr int kMaxThreads = 512;
constexpr int kPer = 8;        // coefficients a thread keeps in a cross-block stage
// A block holds at most 2^15 / 8 = 4096 coefficients (32 KB of shared
// memory, under the default 48 KB), which its threads cover in one
// cross-block stage.
static_assert(kPer * kMaxThreads >= (1 << 15) / 8, "a split block's part exceeds kPer");

using u128 = unsigned __int128;

// x * w mod t for a constant w < t < 2^63 with wq = floor(w 2^64 / t): the
// quotient underestimates floor(x w / t) by at most 1, so r lies in [0, 2t).
__device__ __forceinline__ uint64_t shoup64(uint64_t x, uint64_t w, uint64_t wq, uint64_t t) {
  const uint64_t q = __umul64hi(x, wq);
  const uint64_t r = x * w - q * t;
  return r >= t ? r - t : r;
}

__device__ __forceinline__ uint64_t add64(uint64_t a, uint64_t b, uint64_t t) {
  const uint64_t s = a + b;  // < 2t < 2^63
  return s >= t ? s - t : s;
}

__device__ __forceinline__ uint64_t sub64(uint64_t a, uint64_t b, uint64_t t) {
  return a >= b ? a - b : a + t - b;
}

// m mod t of one coefficient j of a row whose limb i sits at x[i * n + j]
__device__ __forceinline__ uint64_t crt(const int32_t* __restrict__ x, int j, int n, int L,
                                        const uint64_t* __restrict__ c, bool bgv) {
  const uint64_t t = c[0];
  u128 lo = static_cast<u128>(1) << 71;  // rounding; sum_i y_i T_lo_i
  u128 hi = 0;                           // sum_i y_i T_hi_i, weight 2^64
  uint64_t acc = 0;                      // BGV: sum_i y_i [q/q_i]_t mod t
  for (int i = 0; i < L; ++i) {
    const uint64_t* li = c + kHead + kLimbWords * i;
    const uint32_t q = static_cast<uint32_t>(li[0]);
    const uint32_t y = nhpsi::shoup_mul(static_cast<uint32_t>(__ldg(x + static_cast<size_t>(i) * n + j)),
                                        static_cast<uint32_t>(li[1]), static_cast<uint32_t>(li[2]), q);
    lo += static_cast<u128>(y) * li[3];
    hi += static_cast<u128>(y) * li[4];
    if (bgv) acc = add64(acc, shoup64(y, li[5], li[6], t), t);
  }
  // (S + 2^71) >> 72 with S = lo + 2^64 hi: the low 64 bits of lo lie below
  // bit 72's weight by a factor 2^8, so they never reach the quotient
  const uint64_t k = static_cast<uint64_t>(((lo >> 64) + hi) >> 8);
  if (!bgv) return k % t;  // round(t x / q) + t k', k' < L
  return sub64(acc, shoup64(k, c[1], c[2], t), t);
}

__global__ void __launch_bounds__(kMaxThreads)
decrypt_mask_kernel(const int32_t* __restrict__ phase, uint8_t* __restrict__ mask,
                    const uint64_t* __restrict__ c, const uint64_t* __restrict__ psi,
                    const int32_t* __restrict__ s2n, int L, int logn, int log_c, int length,
                    int bgv) {
  extern __shared__ uint64_t part[];  // this block's E coefficients of the row
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn, E = n >> log_c, C = 1 << log_c;
  const int rank = static_cast<int>(cluster.block_rank());
  const int base = rank * E;
  const size_t row = blockIdx.x >> log_c;
  const int T = blockDim.x, tid = threadIdx.x;
  const uint64_t t = c[0];
  const int32_t* x = phase + row * static_cast<size_t>(L) * n;

  for (int e = tid; e < E; e += T) part[e] = crt(x, base + e, n, L, c, bgv != 0);
  cluster.sync();

  // stages whose butterflies pair coefficients of two blocks: each block
  // computes its own outputs, reading the partner across the cluster
  for (int s = 0; s < log_c; ++s) {
    const int log_tt = logn - s - 1, tt = 1 << log_tt, m = 1 << s;
    uint64_t out[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * T;
      if (e < E) {
        const int g = base + e, p = g ^ tt;
        const uint64_t* far = cluster.map_shared_rank(part, static_cast<unsigned>(p / E));
        const uint64_t mine = part[e], other = far[p % E];
        const bool upper = (g & tt) != 0;
        const int i = m + (g >> (log_tt + 1));
        const uint64_t v = shoup64(upper ? mine : other, psi[i], psi[n + i], t);
        const uint64_t u = upper ? other : mine;
        out[k] = upper ? sub64(u, v, t) : add64(u, v, t);
      }
    }
    cluster.sync();
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (tid + k * T < E) part[tid + k * T] = out[k];
    cluster.sync();
  }
  // stages within the block's own coefficients
  for (int s = log_c; s < logn; ++s) {
    const int log_tt = logn - s - 1, tt = 1 << log_tt, m = 1 << s;
    const int group0 = base >> (log_tt + 1);
    for (int b = tid; b < (E >> 1); b += T) {
      const int gl = b >> log_tt, pos = (gl << (log_tt + 1)) + (b & (tt - 1));
      const int i = m + group0 + gl;
      const uint64_t u = part[pos];
      const uint64_t v = shoup64(part[pos + tt], psi[i], psi[n + i], t);
      part[pos] = add64(u, v, t);
      part[pos + tt] = sub64(u, v, t);
    }
    __syncthreads();
  }
  cluster.sync();  // every block's part is final before the gather reads it

  uint8_t* out = mask + row * static_cast<size_t>(length);
  for (int s = rank * T + tid; s < length; s += C * T) {
    const int p = __ldg(s2n + s);
    const uint64_t* far = cluster.map_shared_rank(part, static_cast<unsigned>(p / E));
    out[s] = far[p % E] == 0 ? 1 : 0;
  }
  cluster.sync();  // no block leaves while another may still read its part
}

}  // namespace

// Checks what the kernel cannot take, then launches one cluster of C blocks
// per row, C picked from n alone. Returns a cudaError_t.
extern "C" int nhpsi_decrypt_mask(const void* phase, void* mask, const void* consts,
                                  const void* psi, const void* s2n, int rows, int L, int logn,
                                  int length, int bgv, void* stream) {
  if (rows <= 0 || length == 0) return 0;
  if (L <= 0 || logn < 1 || logn > 15 || length < 0 || length > (1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 1 << logn;
  // one block per 2048 coefficients, at most 8 (a portable cluster)
  const int log_c = logn <= 11 ? 0 : (logn - 11 < 3 ? logn - 11 : 3);
  const int cluster = 1 << log_c, E = n >> log_c;
  const int threads = E / 2 < 32 ? 32 : (E / 2 > kMaxThreads ? kMaxThreads : E / 2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = sizeof(uint64_t) * static_cast<size_t>(E);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block a row: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decrypt_mask_kernel, static_cast<const int32_t*>(phase),
      static_cast<uint8_t*>(mask), static_cast<const uint64_t*>(consts),
      static_cast<const uint64_t*>(psi), static_cast<const int32_t*>(s2n), L, logn, log_c,
      length, bgv);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
