// What the two NTT probes (probe_ntt_lazy.cu, probe_ntt_anatomy.cu) share:
// the tile geometry, the staging of one prime's stage tables in shared
// memory, and the split-form stages of one (M, M) tile half run on the M
// residues a thread holds in registers.
//
// A tile is one limb row of n = M * M residues viewed as (M, M), row-major;
// a block takes kRowsPerBlock rows of one prime, one after another, with M
// threads. The stage tables are the v2 tables of the split NTT plan
// (nested_hashing_psi_tpu_torch/ops/split_plan.py): per prime (2, LOG, M),
// value then Shoup quotient, stage k's entry for row r at k * M + r. Stage
// k of a half pairs rows at distance te = t if t >= 8 else t * (M / 8),
// t = M >> (k + 1), and reads the entry of the pair's v row, as the JAX
// probes' split stages do.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace nhpsi_probe {

constexpr int kRowsPerBlock = 4;
constexpr int kMaxDevices = 16;

__host__ __device__ constexpr int ilog2(int m) { return m <= 1 ? 0 : 1 + ilog2(m / 2); }

__host__ __device__ constexpr int pair_distance(int M, int k) {
  return (M >> (k + 1)) >= 8 ? (M >> (k + 1)) : (M >> (k + 1)) * (M / 8);
}

// The entry of a stage table: a Shoup pair, or (for the pre-split form)
// the value and the quotient's two 16-bit halves.
__device__ __forceinline__ void make_entry(uint2& e, uint32_t w, uint32_t wq) {
  e = make_uint2(w, wq);
}
__device__ __forceinline__ void make_entry(uint4& e, uint32_t w, uint32_t wq) {
  e = make_uint4(w, wq & 0xFFFFu, wq >> 16, 0u);
}

// One prime's (2, LOG, M) table -> dst[k * M + r], by the whole block.
template <int M, typename T>
__device__ __forceinline__ void stage_table(T* dst, const uint32_t* __restrict__ tab) {
  constexpr int N = ilog2(M) * M;
  for (int i = threadIdx.x; i < N; i += blockDim.x) make_entry(dst[i], __ldg(tab + i), __ldg(tab + N + i));
}

// Stages K.. of one half: every butterfly bf(u, v, entry of the v row).
// The recursion and the unrolled loop leave every register index constant.
template <int M, int K, typename T, typename BF>
__device__ __forceinline__ void run_half(uint32_t (&a)[M], const T* tab, const BF& bf) {
  if constexpr (K < ilog2(M)) {
    constexpr int te = pair_distance(M, K);
#pragma unroll
    for (int b = 0; b < M / 2; ++b) {
      const int u = (b / te) * 2 * te + b % te;
      bf(a[u], a[u + te], tab[K * M + u + te]);
    }
    run_half<M, K + 1>(a, tab, bf);
  }
}

// Cooley-Tukey, exact: (u, v) -> (u + wv, u - wv) mod p.
struct CtExact {
  using Entry = uint2;
  uint32_t p;
  __device__ __forceinline__ void operator()(uint32_t& u, uint32_t& v, uint2 w) const {
    const uint32_t x = nhpsi::shoup_mul(v, w.x, w.y, p);
    v = nhpsi::sub_mod(u, x, p);
    u = nhpsi::add_mod(u, x, p);
  }
};

// Gentleman-Sande, exact: (u, v) -> (u + v, w(u - v)) mod p.
struct GsExact {
  using Entry = uint2;
  uint32_t p;
  __device__ __forceinline__ void operator()(uint32_t& u, uint32_t& v, uint2 w) const {
    const uint32_t d = nhpsi::sub_mod(u, v, p);
    u = nhpsi::add_mod(u, v, p);
    v = nhpsi::shoup_mul(d, w.x, w.y, p);
  }
};

// Sets the kernel's dynamic shared memory above 48 KB once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

inline int blocks_for(int B, int L) { return L * ((B + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace nhpsi_probe
