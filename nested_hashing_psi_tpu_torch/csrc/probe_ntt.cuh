// What the two NTT probes (probe_ntt_lazy.cu, probe_ntt_anatomy.cu) share:
// the tile geometry and its residue classes, the staging of one prime's
// stage tables in shared memory, the split-form stages of one class run in
// registers, and the grid of slabs.
//
// A tile is one limb row of n = M * M residues viewed as (M, M), row-major.
// The stage tables are the v2 tables of the split NTT plan
// (nested_hashing_psi_tpu_torch/ops/split_plan.py): per prime (2, LOG, M),
// value then Shoup quotient, stage k's entry for row r at k * M + r. Stage
// k of a half pairs rows at distance te = t if t >= 8 else t * (M / 8),
// t = M >> (k + 1), and reads the entry of the pair's v row, as the JAX
// probes' split stages do.
//
// The classes. Every pair distance is a power of two from S = the least of
// them (8 at M = 64 and 128, 4 at M = 32) up to M / 2, so no stage pairs
// rows that differ modulo S: rows alpha + S i (i < C = M / S) of one column
// form a class that the stages of a half never leave, and stage k pairs
// its members i and i + te / S. A thread holds one class in registers, C
// residues instead of a whole column. A slab is the S-th of a tile that one
// alpha selects: C rows of M columns, one class per column, M threads.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>

#include "modarith.cuh"

namespace nhpsi_probe {

constexpr int kThreads = 256;  // a block of the redesigned kernels: kThreads / M slabs
constexpr int kMaxDevices = 16;

__host__ __device__ constexpr int ilog2(int m) { return m <= 1 ? 0 : 1 + ilog2(m / 2); }

__host__ __device__ constexpr int pair_distance(int M, int k) {
  return (M >> (k + 1)) >= 8 ? (M >> (k + 1)) : (M >> (k + 1)) * (M / 8);
}

// S: the least pair distance of a half.
__host__ __device__ constexpr int class_stride(int M) {
  int s = M;
  for (int k = 0; k < ilog2(M); ++k) s = pair_distance(M, k) < s ? pair_distance(M, k) : s;
  return s;
}

// True when every pair distance is a multiple of S below M: the classes
// are closed under the stages.
__host__ __device__ constexpr bool classes_closed(int M) {
  for (int k = 0; k < ilog2(M); ++k)
    if (pair_distance(M, k) % class_stride(M) != 0 || pair_distance(M, k) >= M) return false;
  return true;
}

template <int M>
constexpr int kStride = class_stride(M);
template <int M>
constexpr int kClass = M / class_stride(M);

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

// Stages K.. of one half on the class a thread holds: a[i] is row (or
// column) base + S i, and tab is the stage table advanced by base, so the
// butterfly bf(u, v, entry of the v row) reads tab[K * M + S v]. The
// stages run in the plain version's order and each keeps its (u, v)
// roles; the recursion and the unrolled loop leave every register index
// constant.
template <int M, int K, typename T, typename BF>
__device__ __forceinline__ void run_half(uint32_t (&a)[kClass<M>], const T* tab, const BF& bf) {
  static_assert(classes_closed(M), "a stage pairs rows of two classes");
  if constexpr (K < ilog2(M)) {
    constexpr int S = kStride<M>, te = pair_distance(M, K) / S;
#pragma unroll
    for (int b = 0; b < kClass<M> / 2; ++b) {
      const int u = (b / te) * 2 * te + b % te;
      bf(a[u], a[u + te], tab[K * M + S * (u + te)]);
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

// The slab loop of a thread: block b of the grid takes prime l = b % L,
// and the kThreads / M slab groups of that prime's gridDim.x / L blocks
// walk its B * S slabs (tile s / S, alpha = s % S), each from `first` with
// a stride of all of them.
struct SlabWalk {
  int l, first, stride, end;
};

template <int M>
__device__ __forceinline__ SlabWalk slab_walk(int B, int L) {
  constexpr int G = kThreads / M;
  const int b = static_cast<int>(blockIdx.x);
  return {b % L, b / L * G + static_cast<int>(threadIdx.x) / M,
          static_cast<int>(gridDim.x) / L * G, B * kStride<M>};
}

// Where column c of slab s of prime l begins: tile s / S, row s % S.
template <int M>
__device__ __forceinline__ size_t slab_at(int s, int l, int L, int c) {
  return (static_cast<size_t>(s / kStride<M>) * L + l) * M * M + s % kStride<M> * M + c;
}

// A column's class from p = x + slab_at: its rows S i apart.
template <int M>
__device__ __forceinline__ void load_class(uint32_t (&a)[kClass<M>], const uint32_t* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < kClass<M>; ++i) a[i] = __ldg(p + i * kStride<M> * M);
}

// The resident blocks of one kernel instance on the current device (SMs
// times blocks per SM at its shared memory, found on its first launch there
// and kept in `found`). Returns a cudaError_t, and clears a refused runtime
// call from the runtime's last error.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int (&found)[kMaxDevices], int* blocks) {
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (err == cudaSuccess && found[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) found[dev] = sms * per_sm;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *blocks = found[dev];
  return cudaSuccess;
}

// The grid of a slab kernel: L primes times the blocks a prime gets, the
// resident blocks shared among the primes, and no more blocks for a prime
// than it has slab groups.
template <int M>
inline int slab_grid(int resident, int B, int L) {
  constexpr int G = kThreads / M;
  const long long groups = (static_cast<long long>(B) * kStride<M> + G - 1) / G;
  const long long per_prime = resident / L > 1 ? resident / L : 1;
  return L * static_cast<int>(per_prime < groups ? per_prime : groups);
}

}  // namespace nhpsi_probe
