// K1: negacyclic NTT / inverse NTT over RNS limb rows, one block per row.
//
// Replaces the TPU kernel ntt_pallas / intt_pallas of
// nested_hashing_psi_tpu/ops/ntt_pallas.py (pallas_call at :596, entries
// :631 and :645). Same contract: x (..., L, n) residues mod 31-bit primes;
// forward goes natural -> canonical bit-reversed order, inverse goes back
// and includes the 1/n scale; bit-exact with the plain version in
// nested_hashing_psi_tpu_torch/ops/ntt.py, whose stage sequence (merged
// twiddles, Cooley-Tukey forward, Gentleman-Sande inverse, Shoup
// multiplies) this kernel runs verbatim.
//
// What bounds it on an H100: a row of n = 16384 residues is 64 KB, read and
// written once; the log2(n) stages in between are 32-bit integer multiplies
// (one __umulhi + two low multiplies per butterfly) plus a __syncthreads per
// stage. With the row resident in shared memory the device-memory traffic
// is the minimum (8 B per coefficient plus the twiddle rows, which stay in
// L2 across rows of the same prime), so the kernel is bound by integer issue
// and stage barriers, not bandwidth.
//
// Design: the whole row lives in dynamic shared memory (n * 4 bytes: 64 KB
// at n = 16384, 128 KB at 32768, above the 48 KB static limit, hence
// cudaFuncSetAttribute). Each thread runs n / (2 * blockDim) butterflies per
// stage. The four-step split, roll-based stages and regroup tables of the
// TPU kernel are Mosaic layout devices and are not carried over.
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

using nhpsi::add_mod;
using nhpsi::shoup_mul;
using nhpsi::sub_mod;

// psi: (L, 2, n) Shoup pairs [value, quotient] in bit-reversed order.
__global__ void ntt_fwd_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ primes, int L,
                               int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int row = blockIdx.x;
  const int l = row % L;
  const uint32_t p = primes[l];
  const uint32_t* w_val = psi + static_cast<size_t>(l) * 2 * n;
  const uint32_t* w_quo = w_val + n;
  const uint32_t* src = x + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  // stage with m groups of 2t: group i pairs (i*2t + k, i*2t + t + k)
  for (int lm = 0, lt = logn - 1; lm < logn; ++lm, --lt) {
    const int m = 1 << lm;
    const int tmask = (1 << lt) - 1;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int i = j >> lt;
      const int u = (i << (lt + 1)) + (j & tmask);
      const int v = u + (1 << lt);
      const uint32_t U = s[u];
      const uint32_t V = shoup_mul(s[v], w_val[m + i], w_quo[m + i], p);
      s[u] = add_mod(U, V, p);
      s[v] = sub_mod(U, V, p);
    }
    __syncthreads();
  }
  uint32_t* dst = y + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
}

// ipsi: (L, 2, n) inverse Shoup pairs; ninv: (L, 2) n^-1 Shoup pair.
__global__ void ntt_inv_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ ipsi,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ primes, int L,
                               int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int row = blockIdx.x;
  const int l = row % L;
  const uint32_t p = primes[l];
  const uint32_t* w_val = ipsi + static_cast<size_t>(l) * 2 * n;
  const uint32_t* w_quo = w_val + n;
  const uint32_t* src = x + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  // stage with h = m/2 groups of 2t, t = 1, 2, ..., n/2
  for (int lt = 0; lt < logn; ++lt) {
    const int h = half >> lt;
    const int tmask = (1 << lt) - 1;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int i = j >> lt;
      const int u = (i << (lt + 1)) + (j & tmask);
      const int v = u + (1 << lt);
      const uint32_t U = s[u];
      const uint32_t V = s[v];
      s[u] = add_mod(U, V, p);
      s[v] = shoup_mul(sub_mod(U, V, p), w_val[h + i], w_quo[h + i], p);
    }
    __syncthreads();
  }
  const uint32_t nv = ninv[2 * l], nq = ninv[2 * l + 1];
  uint32_t* dst = y + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = shoup_mul(s[i], nv, nq, p);
}

int threads_for(int logn) {
  const int half = 1 << (logn - 1);
  return half < 512 ? half : 512;
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace

extern "C" int nhpsi_ntt_fwd(const void* x, void* y, const void* psi,
                             const void* primes, int rows, int L, int logn,
                             void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = prepare(reinterpret_cast<const void*>(ntt_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<rows, threads_for(logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(primes),
      L, logn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nhpsi_ntt_inv(const void* x, void* y, const void* ipsi,
                             const void* ninv, const void* primes, int rows,
                             int L, int logn, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = prepare(reinterpret_cast<const void*>(ntt_inv_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_kernel<<<rows, threads_for(logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(ninv),
      static_cast<const uint32_t*>(primes), L, logn);
  return static_cast<int>(cudaGetLastError());
}
