// K2: the batched PIE's position sum, designed for the H100.
//
//   ip[h, d, c, l, n] = sum_p mont_mul(idx[h, p, c, l, n], pt[h, d, p, l, n])
//                       (+ acc[h, d, c, l, n])  mod q_l
//
// Replaces the TPU kernel indexed_inner_product of
// nested_hashing_psi_tpu/ops/pie_kernels.py (pallas_call at :75, body
// _ip_kernel at :29), and is bit-exact with indexed_inner_product_plain in
// nested_hashing_psi_tpu_torch/ops/pie_kernels.py. out / acc (H, D, 2, L, N)
// are contiguous, idx (H, P, 2, L, N) is contiguous within each h (its h
// stride is given: a position slice of a wider index is read in place). The
// table is any (H, D, P, L, N) view whose n axis is contiguous, given by its
// pointer and element strides, so both of its layouts are read in place: the
// device-resident (H, D, P_full, L, N) table at position p0 (a streamed
// chunk's slice), and the host-resident path's position-major
// (w, H, D, L, N) upload buffer, permuted.
// With acc the kernel writes add_mod(acc, sum), over acc itself if out is
// acc, so a running sum over slices or chunks costs no separate pass.
//
// What bounds it on an H100: bytes. The table is read once and is by far the
// largest operand (H*D*P*L*N*4 B: 113 MB at the 2^20-server geometry, L = 6),
// the index once, the output written once: 0.045 ms at 3.35 TB/s. The work
// per table word is two 32x32->64 products; a 64-bit-result multiply takes
// two FMA-pipe slots (IMAD.WIDE, the probe A1), so the products alone need
// ~0.007 ms at L = 6, if nothing else is spent per product.
//
// Design:
// - One reduction per output, not per product. The exact 62-bit products
//   idx * pt are summed in 64 bits four at a time (4 (q-1)^2 < 2^64: one
//   IMAD.WIDE each) and each group of four is added with carries into a
//   96-bit sum S < P q^2. Each output then reduces once:
//   sum_p mont_mul(a_p, b_p) mod q is the canonical residue of S 2^-32 mod q,
//   which two Montgomery reductions give (reduce() below), so the
//   result is bit-exact for any P < 2^32.
// - No wave tail: the work is (h, l, 256-column tile) items of D depths,
//   and a thread's work on one item is a long chain of dependent load
//   rounds, so a block left with an extra item runs it almost alone and the
//   kernel waits for it. While the items fit in the resident blocks
//   (SMs x blocks per SM) each block takes one whole item; beyond, a
//   persistent grid of the resident blocks gives every block an equal run
//   of the (item, depth) units, walked forward in even blocks and backward
//   in odd ones, so a tile whose depths two neighbouring blocks share is
//   staged by both at the same time and its index leaves device memory once.
// - Bytes in flight: each thread owns 4 consecutive n, so every table, index
//   and output access is a 16-byte vector, neighbouring threads on
//   neighbouring addresses; the table's loads are issued eight positions at a
//   time, before any product that uses them.
// - The index is read once: each thread stages its 2P index vectors in
//   shared memory (its own slots, [k][thread], so no barrier is needed) and
//   reads them back for every depth of the item it has.
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "modarith.cuh"

namespace {

using nhpsi::add_mod;
using nhpsi::redc;

constexpr int kVec = 4;    // consecutive n per thread: 16-byte accesses
constexpr int kGroup = 4;  // products summed in 64 bits: 4 (q-1)^2 < 2^64

// S = w0 + w1 2^32 + w2 2^64.
struct Wide {
  uint32_t w0, w1, w2;
};

__device__ __forceinline__ void add_wide(Wide& s, uint64_t g) {
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(s.w0), "+r"(s.w1), "+r"(s.w2)
      : "r"(static_cast<uint32_t>(g)), "r"(static_cast<uint32_t>(g >> 32)));
}

// g[j] += a[j] b[j]: exact 62-bit products of residues below q < 2^31.
__device__ __forceinline__ void mac4(uint64_t (&g)[kVec], const uint4& a, const uint4& b) {
  g[0] += static_cast<uint64_t>(a.x) * b.x;
  g[1] += static_cast<uint64_t>(a.y) * b.y;
  g[2] += static_cast<uint64_t>(a.z) * b.z;
  g[3] += static_cast<uint64_t>(a.w) * b.w;
}

// S 2^-32 mod q for S < P q^2 with r2 = 2^64 mod q. X = S >> 32 is below
// q 2^32 (as P q < 2^64), so u = redc(X) = X 2^-32; then u r2 + w0 is below
// q 2^32 too, and redc(u r2 + w0) = X + w0 2^-32 = S 2^-32 (mod q): the
// canonical sum of the Montgomery products mont_mul(a_p, b_p).
__device__ __forceinline__ uint32_t reduce(const Wide& s, uint32_t q, uint32_t qinv,
                                           uint32_t r2) {
  const uint32_t u = redc((static_cast<uint64_t>(s.w2) << 32) | s.w1, q, qinv);
  return redc(static_cast<uint64_t>(u) * r2 + s.w0, q, qinv);
}

__device__ __forceinline__ uint32_t pow2_64_mod(uint32_t q) {
  const uint32_t r = static_cast<uint32_t>(~0ull % q) + 1u;  // (2^64 - 1) mod q + 1
  return r == q ? 0u : r;
}

// out[o], out[o + LN] = the reduced sums of c = 0 and 1 for 4 columns, each
// added to acc's word first when acc is given. acc may be out itself: each
// word is read before this thread writes it, and by no other thread.
__device__ __forceinline__ void store_sums(const Wide (&s0)[kVec], const Wide (&s1)[kVec],
                                           uint32_t q, uint32_t qinv, uint32_t r2,
                                           const uint32_t* acc, uint32_t* out, size_t o,
                                           size_t LN) {
  uint4 r0 = make_uint4(reduce(s0[0], q, qinv, r2), reduce(s0[1], q, qinv, r2),
                        reduce(s0[2], q, qinv, r2), reduce(s0[3], q, qinv, r2));
  uint4 r1 = make_uint4(reduce(s1[0], q, qinv, r2), reduce(s1[1], q, qinv, r2),
                        reduce(s1[2], q, qinv, r2), reduce(s1[3], q, qinv, r2));
  if (acc != nullptr) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(acc + o);
    const uint4 a1 = *reinterpret_cast<const uint4*>(acc + o + LN);
    r0 = make_uint4(add_mod(a0.x, r0.x, q), add_mod(a0.y, r0.y, q), add_mod(a0.z, r0.z, q),
                    add_mod(a0.w, r0.w, q));
    r1 = make_uint4(add_mod(a1.x, r1.x, q), add_mod(a1.y, r1.y, q), add_mod(a1.z, r1.z, q),
                    add_mod(a1.w, r1.w, q));
  }
  *reinterpret_cast<uint4*>(out + o) = r0;
  *reinterpret_cast<uint4*>(out + o + LN) = r1;
}

// This block's share of the (item, depth) units, as runs of depths of one
// item each: an equal run per block, walked forward in even blocks and
// backward in odd ones, so a tile whose depths two neighbouring blocks share
// comes first or last in both.
struct Segments {
  long long lo, hi;
  int D;
  bool backward;
  __device__ Segments(long long units, int D_)
      : lo(units * blockIdx.x / gridDim.x),
        hi(units * (blockIdx.x + 1) / gridDim.x),
        D(D_),
        backward((blockIdx.x & 1) != 0) {}
  __device__ bool next(long long& item, int& d_lo, int& d_hi) {
    if (lo >= hi) return false;
    const long long left = hi - lo;
    if (!backward) {
      item = lo / D;
      d_lo = static_cast<int>(lo - item * D);
      d_hi = left < D - d_lo ? d_lo + static_cast<int>(left) : D;
      lo += d_hi - d_lo;
    } else {
      item = (hi - 1) / D;
      d_hi = static_cast<int>(hi - item * D);
      d_lo = left < d_hi ? d_hi - static_cast<int>(left) : 0;
      hi -= d_hi - d_lo;
    }
    return true;
  }
};

constexpr int kThreads = 64;            // two warps per block
constexpr int kTile = kThreads * kVec;  // n columns per work item
constexpr int kLoads = 2 * kGroup;      // table loads issued before their products

__global__ void __launch_bounds__(kThreads)
pie_ip_kernel(const uint32_t* __restrict__ idx, const uint32_t* __restrict__ pt,
              const uint32_t* acc, uint32_t* out, const uint32_t* __restrict__ primes,
              const uint32_t* __restrict__ pinvs, int D, int P, int L, int N,
              long long sIH, long long sH, long long sD, long long sP, long long sL,
              int tiles, long long units) {
  extern __shared__ uint4 s_idx[];  // (2P, kThreads): [2p + c][thread]
  const int tid = threadIdx.x;
  const size_t LN = static_cast<size_t>(L) * N;
  Segments seg(units, D);
  long long item;
  int d_lo, d_hi;
  while (seg.next(item, d_lo, d_hi)) {
    const int tile = static_cast<int>(item % tiles);
    const int l = static_cast<int>((item / tiles) % L);
    const int h = static_cast<int>(item / (static_cast<long long>(tiles) * L));
    const int n = tile * kTile + tid * kVec;
    if (n >= N) continue;  // N % kVec == 0: a thread's columns are all in or all out
    const uint32_t q = primes[l], qinv = pinvs[l], r2 = pow2_64_mod(q);
    // idx[h, p, c, l, n:n+4]
    const uint32_t* ib = idx + h * sIH + static_cast<size_t>(l) * N + n;
    for (int k = 0; k < 2 * P; ++k)
      s_idx[k * kThreads + tid] = __ldg(reinterpret_cast<const uint4*>(ib + k * LN));
    const uint32_t* tb0 = pt + h * sH + l * sL + n;
    const size_t ob0 = static_cast<size_t>(h) * D * 2 * LN + static_cast<size_t>(l) * N + n;
    for (int d = d_lo; d < d_hi; ++d) {
      const uint32_t* tb = tb0 + d * sD;
      Wide s0[kVec] = {}, s1[kVec] = {};
      for (int p = 0; p < P; p += kLoads) {
        uint4 w[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          w[u] = p + u < P ? __ldcs(reinterpret_cast<const uint4*>(tb + (p + u) * sP))
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int g = 0; g < kLoads; g += kGroup) {
          if (p + g >= P) break;
          uint64_t g0[kVec] = {}, g1[kVec] = {};
#pragma unroll
          for (int u = g; u < g + kGroup; ++u) {
            if (p + u < P) {
              mac4(g0, s_idx[2 * (p + u) * kThreads + tid], w[u]);
              mac4(g1, s_idx[(2 * (p + u) + 1) * kThreads + tid], w[u]);
            }
          }
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            add_wide(s0[j], g0[j]);
            add_wide(s1[j], g1[j]);
          }
        }
      }
      // out[h, d, c, l, n:n+4]
      store_sums(s0, s1, q, qinv, r2, acc, out, ob0 + static_cast<size_t>(d) * 2 * LN, LN);
    }
  }
}

// The kernel's resident blocks (SMs x blocks per SM) on the current device
// at `smem` bytes of shared memory, found on the first launch of each
// (device, size) and kept, so a launch costs the host no runtime query; the
// device's shared-memory limit for the kernel is raised once where a size
// needs more than 48 KB. Returns a cudaError_t.
int resident_blocks(size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> found;
  static std::map<int, size_t> smem_limit;  // per device: the limit set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = found.find({dev, smem});
  if (hit != found.end()) {
    *blocks = hit->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024 && smem > smem_limit[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(pie_ip_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) smem_limit[dev] = smem;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pie_ip_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = found[{dev, smem}] = static_cast<long long>(sms) * per_sm;
  return 0;
}

}  // namespace

// Checks what the kernel cannot read (n not a multiple of 4, a view that is
// not 16-byte aligned), sizes the grid and launches: one whole item of kTile
// columns per block while the items fit in the resident blocks, equal runs
// of (item, depth) units over the resident blocks beyond. Returns a
// cudaError_t.
extern "C" int nhpsi_pie_ip(const void* idx, const void* pt, const void* acc, void* out,
                            const void* primes, const void* pinvs, int H, int D, int P,
                            int L, int N, long long sIH, long long sH, long long sD,
                            long long sP, long long sL, void* stream) {
  if (H <= 0 || D <= 0 || L <= 0 || N <= 0) return 0;
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (P < 0 || N % kVec != 0 || (sIH | sH | sD | sP | sL) % kVec != 0 || misaligned(idx) ||
      misaligned(pt) || misaligned(acc) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint4) * 2 * static_cast<size_t>(P) * kThreads;
  long long resident = 0;
  if (const int err = resident_blocks(smem, &resident)) {
    // a refused runtime call also stays the runtime's last error, which the
    // next launch anywhere would read back: clear it before returning it
    cudaGetLastError();
    return err;
  }
  const int tiles = (N + kTile - 1) / kTile;
  const long long items = static_cast<long long>(H) * L * tiles;
  const long long grid = items <= resident ? items : resident;
  pie_ip_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(idx), static_cast<const uint32_t*>(pt),
      static_cast<const uint32_t*>(acc), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinvs), D, P, L, N,
      sIH, sH, sD, sP, sL, tiles, items * D);
  return static_cast<int>(cudaGetLastError());
}
