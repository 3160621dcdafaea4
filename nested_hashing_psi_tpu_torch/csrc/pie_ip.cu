// K2: the batched PIE's position sum, one thread per (h, l, n) column.
//
//   ip[h, d, c, l, n] = sum_p mont_mul(idx[h, p, c, l, n], pt[h, d, p, l, n])
//                       mod q_l
//
// Replaces the TPU kernel indexed_inner_product of
// nested_hashing_psi_tpu/ops/pie_kernels.py (pallas_call at :75, body
// _ip_kernel at :29), and is bit-exact with indexed_inner_product_plain in
// nested_hashing_psi_tpu_torch/ops/pie_kernels.py. The layouts of the public
// function are kept: idx (H, P, 2, L, N), pt (H, D, P, L, N) -> out
// (H, D, 2, L, N); the TPU kernel's limb-major transpose is not needed.
// The table may be wider than the index: with pt (H, D, P_full, L, N) the
// kernel reads positions [p0, p0 + P) of it in place, so a streamed chunk of
// the index is summed against its slice of the table without a copy
// (p0 = 0, P_full = P is the whole table).
//
// What bounds it on an H100: the packed table pt is read exactly once and is
// by far the largest operand (H*D*P*L*N*4 B: ~113 MB at the 2^20-server
// geometry), against 2 Montgomery products per table word. At 3.35 TB/s the
// table read takes ~34 us, far more than the integer work, so the kernel is
// bound by device-memory bandwidth.
//
// Design: consecutive n go to consecutive threads, so every table, index and
// output access is coalesced. Each thread stages its 2*P index residues in
// shared memory once (laid out [c*P + p][thread] so a warp hits 32 banks)
// and reuses them for all D depths, so the index tensor is read once too.
// Every partial sum is canonical mod q_l, so the summation order cannot
// change the result.
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

using nhpsi::add_mod;
using nhpsi::mont_mul;

constexpr int kThreads = 128;

__global__ void pie_ip_kernel(const uint32_t* __restrict__ idx,
                              const uint32_t* __restrict__ pt,
                              uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ primes,
                              const uint32_t* __restrict__ pinvs, int H, int D,
                              int P, int L, int N, int p0, int P_full) {
  extern __shared__ uint32_t s_idx[];  // (2P, blockDim)
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long cols = static_cast<long long>(H) * L * N;
  const bool active = col < cols;
  const int n = static_cast<int>(col % N);
  const int l = static_cast<int>((col / N) % L);
  const int h = static_cast<int>(col / (static_cast<long long>(N) * L));
  const size_t LN = static_cast<size_t>(L) * N;
  if (active) {
    // idx[h, p, c, l, n]
    const uint32_t* ib = idx + static_cast<size_t>(h) * P * 2 * LN +
                         static_cast<size_t>(l) * N + n;
    for (int p = 0; p < P; ++p)
      for (int c = 0; c < 2; ++c)
        s_idx[(c * P + p) * blockDim.x + threadIdx.x] =
            ib[(static_cast<size_t>(p) * 2 + c) * LN];
  }
  if (!active) return;  // no barrier below: each thread reads its own column
  const uint32_t q = primes[l];
  const uint32_t qinv = pinvs[l];
  for (int d = 0; d < D; ++d) {
    // pt[h, d, p0 + p, l, n]
    const uint32_t* tb =
        pt + ((static_cast<size_t>(h) * D + d) * P_full + p0) * LN +
        static_cast<size_t>(l) * N + n;
    uint32_t acc0 = 0, acc1 = 0;
    for (int p = 0; p < P; ++p) {
      const uint32_t w = tb[static_cast<size_t>(p) * LN];
      acc0 = add_mod(acc0,
                     mont_mul(s_idx[p * blockDim.x + threadIdx.x], w, q, qinv),
                     q);
      acc1 = add_mod(
          acc1,
          mont_mul(s_idx[(P + p) * blockDim.x + threadIdx.x], w, q, qinv), q);
    }
    // out[h, d, c, l, n]
    uint32_t* ob = out + (static_cast<size_t>(h) * D + d) * 2 * LN +
                   static_cast<size_t>(l) * N + n;
    ob[0] = acc0;
    ob[LN] = acc1;
  }
}

}  // namespace

extern "C" int nhpsi_pie_ip(const void* idx, const void* pt, void* out,
                            const void* primes, const void* pinvs, int H,
                            int D, int P, int L, int N, int p0, int P_full,
                            void* stream) {
  const long long cols = static_cast<long long>(H) * L * N;
  if (cols <= 0 || D <= 0) return 0;
  if (p0 < 0 || P < 0 || p0 + P > P_full)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * 2 * static_cast<size_t>(P) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(pie_ip_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>((cols + kThreads - 1) / kThreads);
  pie_ip_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(idx), static_cast<const uint32_t*>(pt),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(pinvs), H, D, P, L, N, p0, P_full);
  return static_cast<int>(cudaGetLastError());
}
