// K3: the negacyclic NTT / inverse NTT as int8 digit products on Hopper's
// tensor cores (wgmma), the G digit matrices staged in shared memory once for
// four rows of one prime.
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
// G_i @ digits in int32 is exact (Q_i <= 5 * m * 127^2 < 2^25), and
// sum_i 2^(7i) Q_i mod p recombines them.
//
// The bound on an H100: operations. Per row and stage 5 * m1 * m2 * 5m int8
// multiply-adds (52 M at n = 16384), 60.4 G int8 ops at (2,12,2,6,16384):
// 0.0305 ms at 1,979 T ops/s; 0.0407 ms at (2,12,2,8,16384). The bytes (rows
// read and written once, the tables once) take a fifth of that.
//
// Design. Only wgmma reaches the int8 tensor-core rate, and it reads its
// operands from shared memory, so the G_i (400 KB per prime and stage at
// n = 16384) stream through a ring of shared-memory stages:
// - A cluster of 4 CTAs holds 4 rows of one prime (rows l + L*(4c + rank)).
//   Its rank-0 producer copies each ring stage once with a multicast bulk
//   copy into all 4 CTAs, so each G byte leaves L2 once for 4 rows, as the
//   TPU kernel kept one prime's G in VMEM across tile_b rows. A CTA whose
//   slot has no row (ragged rows per prime) joins the barriers and stores
//   nothing.
// - The plan stores G on the device in the order and layout the ring
//   consumes (ops/ntt_mxu.py _device_stream): per prime and stage a byte
//   stream of chunks (per pass, digit matrix and 4 k-steps), each one
//   contiguous bulk copy in wgmma's K-major no-swizzle layout (8-row x
//   16-byte core matrices). The left stage's G is the A operand (rows padded
//   with zeros to the 64-row wgmma tile for m1 < 64), the right stage's the
//   B operand, stored transposed (b, k): s8 wgmma takes both operands
//   K-major only. K = 5m is padded with zero G to whole chunks, so the
//   wgmma loop has a constant trip count (a runtime one, like a wgmma under
//   a thread-dependent branch, makes the compiler serialize the wgmmas).
// - The digit stack of a row stays in shared memory for the whole stage, as
//   the left stage's B operand (rows b, k = j*m1 + a) or the right stage's A
//   operand (rows a, k = j*m2 + b). Two consumer warpgroups each own 64 rows
//   of the output and issue wgmma.mma_async m64 n(m2) k32 s32.s8.s8; one
//   thread of a producer warpgroup keeps the ring full through mbarriers.
//   A chunk is 4 k-steps (16 KB at m = 128): with one k-step per chunk, the
//   single producer thread's per-chunk waits and copy fell behind the
//   wgmmas.
// - The five digit matrices go one per pass over K into an m64n128 s32
//   accumulator, folded into a running sum with Shoup products: Q0 as it is
//   (Q_i < 2^25 < p), then (Q0 + 2^7 Q1) mod p, then Q_i 2^(7i) mod p for
//   i = 2, 3, 4. Two register tiles, 128 registers a thread, under
//   setmaxnreg 232; a third (to fold one matrix while the next one's
//   wgmmas run) leaves too few registers and the compiler serializes.
// - Epilogue in registers: the recombination and the first stage's twiddle;
//   rows go out as 16-byte stores. Up to n = 16384 both stages run in one
//   launch: the row comes in by one bulk copy, then the prime's twiddles
//   into the same buffer behind the first stage's wgmmas, and the
//   intermediate stays there (9n bytes + the ring: 209 KB at 16384); above,
//   one stage per launch with the intermediate in device memory. Neither
//   digits nor Q_i reach device memory. m1 and m2 must be multiples of 16,
//   m2 <= 128.
#include <cuda_runtime.h>
#include <cstdint>

#include "modarith.cuh"

namespace {

using nhpsi::add_mod;
using nhpsi::mont_mul;
using nhpsi::shoup_mul;

constexpr int kDigits = 5;
constexpr int kDigitBits = 7;
constexpr int kKStep = 32;       // bytes of K per s8 wgmma
constexpr int kTileRows = 64;    // M rows of one wgmma
constexpr int kPassRows = 128;   // M rows of one pass: two consumer warpgroups
constexpr int kCluster = 4;      // rows of one prime sharing each G byte
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kChunkSteps = 4;   // k-steps of one ring chunk
constexpr int kMaxStages = 8;
constexpr int kHeader = 1024;    // mbarriers
constexpr int kMaxSmem = 232448;
constexpr int kFusedMaxN = 16384;
constexpr int kMaxDevices = 64;

enum Mode { kBoth = 0, kFirst = 1, kSecond = 2 };

// One stage's shapes. M is the output's row axis a (m1, padded to a wgmma
// tile), N its column axis b (m2). rows: rows of one G matrix in a chunk
// (left: the M rows of a pass; right: N); dig_rows: rows of the digit stack
// (left: N, as B; right: padded M, as A).
struct Geom {
  int passes, ksteps, rows, dig_rows;
};

__host__ __device__ inline Geom geom(bool left, int m1, int m2) {
  const int mp = m1 < kTileRows ? kTileRows : m1;
  Geom g;
  g.passes = (mp + kPassRows - 1) / kPassRows;
  const int chunk_k = kChunkSteps * kKStep;  // K padded to whole chunks
  g.ksteps = (kDigits * (left ? m1 : m2) + chunk_k - 1) / chunk_k * kChunkSteps;
  g.rows = left ? (mp < kPassRows ? mp : kPassRows) : m2;
  g.dig_rows = left ? m2 : mp;
  return g;
}

// Bytes of one prime's G stream for a stage (the right stage's is read once
// per pass).
__host__ __device__ inline size_t stream_bytes(bool left, int m1, int m2) {
  const Geom g = geom(left, m1, m2);
  return static_cast<size_t>(left ? g.passes : 1) * kDigits * g.ksteps * g.rows *
         kKStep;
}

__host__ __device__ inline int digit_bytes(int m1, int m2) {
  const Geom l = geom(true, m1, m2), r = geom(false, m1, m2);
  const int a = l.ksteps * kKStep * l.dig_rows, b = r.ksteps * kKStep * r.dig_rows;
  return ((a > b ? a : b) + 1023) / 1024 * 1024;
}

// Byte of element (r, kk), kk < 32, of a K-major tile: 8-row x 16-byte core
// matrices, the two of one k-step 128 B apart (LBO), 8-row groups 256 B
// apart (SBO).
__device__ __forceinline__ int tile_off(int r, int kk) {
  return (r >> 3) * 256 + (kk >> 4) * 128 + (r & 7) * 16 + (kk & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: no swizzle, LBO 128 B, SBO 256 B.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// ---- mbarriers, bulk copies, cluster -----------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A wait that has spun for ~2^32 clocks (about 2 s) traps: a barrier that
// never completes ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void spin_guard(long long& t0) {
  const long long t = clock64();
  if (t0 == 0) t0 = t;
  else if (t - t0 > (1ll << 32)) __trap();
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long t0 = 0;; spin_guard(t0)) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// Arrive on the barrier at the same offset in the cluster's CTA `cta`.
__device__ __forceinline__ void bar_arrive_remote(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// Copy `bytes` from device memory into this CTA's shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy `bytes` into the same offset of the shared memory of every CTA in
// `mask`, completing on each one's barrier at the offset of `bar`.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src,
                                                    int bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Generic-proxy writes to shared memory visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulators across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (+)= A (64x32, K-major) * B (32x16, K-major), s8 in, s32 out.
__device__ __forceinline__ void wgmma_n(uint32_t (&d)[8], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A (64x32, K-major) * B (32x32, K-major), s8 in, s32 out.
__device__ __forceinline__ void wgmma_n(uint32_t (&d)[16], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A (64x32, K-major) * B (32x64, K-major), s8 in, s32 out.
__device__ __forceinline__ void wgmma_n(uint32_t (&d)[32], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A (64x32, K-major) * B (32x128, K-major), s8 in, s32 out.
__device__ __forceinline__ void wgmma_n(uint32_t (&d)[64], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- digit stacks ---------------------------------------------------------

// Digit j of four residues, as the four bytes of a word (lowest first).
__device__ __forceinline__ uint32_t digit_word(uint32_t v0, uint32_t v1,
                                               uint32_t v2, uint32_t v3, int j) {
  const int s = kDigitBits * j;
  return ((v0 >> s) & 127u) | (((v1 >> s) & 127u) << 8) |
         (((v2 >> s) & 127u) << 16) | (((v3 >> s) & 127u) << 24);
}

// Four digit bytes at (r, k..k+3) of a stack with `rows` rows (k % 4 == 0).
__device__ __forceinline__ void put_word(int8_t* dig, int rows, int r, int k,
                                         uint32_t w) {
  *reinterpret_cast<uint32_t*>(dig + (k >> 5) * rows * kKStep +
                               tile_off(r, k & 31)) = w;
}

// The left stage's stack (the B operand): row b, k = j*m1 + a, from the
// row-major m1 x m2 residues src (shared or device memory). A thread takes
// four a of one b; a warp covers 32 b and 16 a over four turns, so that each
// store instruction fills 32 distinct banks.
__device__ void digits_left(int8_t* dig, const uint32_t* src, int m1, int m2,
                            int tid) {
  const int groups = (m1 >> 2) * m2;
  for (int g = tid; g < groups; g += kConsumers) {
    int b, a0;
    if (m2 >= 32) {
      const int t = g & 31, w = g >> 5, turn = w & 3, task = w >> 2;
      const int bblocks = m2 >> 5;
      b = (task % bblocks) * 32 + t;
      a0 = (task / bblocks) * 16 + 4 * (((t >> 3) + turn) & 3);
    } else {
      b = g % m2;
      a0 = 4 * (g / m2);
    }
    const uint32_t* s = src + a0 * m2 + b;
    const uint32_t v0 = s[0], v1 = s[m2], v2 = s[2 * m2], v3 = s[3 * m2];
#pragma unroll
    for (int j = 0; j < kDigits; ++j)
      put_word(dig, m2, b, j * m1 + a0, digit_word(v0, v1, v2, v3, j));
  }
}

// The right stage's stack (the A operand, `rows` rows): row a, k = j*m2 + b.
// A thread takes four b of one a (one 16-byte load); a warp covers 8 a and
// 32 b over two turns.
__device__ void digits_right(int8_t* dig, const uint32_t* src, int m1, int m2,
                             int rows, int tid) {
  const int quads = m2 >> 2, groups = m1 * quads;
  for (int g = tid; g < groups; g += kConsumers) {
    int a, b0;
    if (m2 >= 32) {
      const int t = g & 31, w = g >> 5, turn = w & 1, task = w >> 1;
      const int bblocks = m2 >> 5;
      a = (task / bblocks) * 8 + (t >> 2);
      b0 = (task % bblocks) * 32 + 4 * (t & 3) + 16 * (((t >> 2) + turn) & 1);
    } else {
      a = g / quads;
      b0 = 4 * (g % quads);
    }
    const uint4 v = *reinterpret_cast<const uint4*>(src + a * m2 + b0);
#pragma unroll
    for (int j = 0; j < kDigits; ++j)
      put_word(dig, rows, a, j * m2 + b0, digit_word(v.x, v.y, v.z, v.w, j));
  }
}

// ---- the kernel -----------------------------------------------------------

// The producer: one thread walks every chunk of the CTA's stages in the
// consumers' order. Every rank sets its own full barrier's byte count; rank
// 0 waits until all 4 CTAs released the slot and multicasts the chunk.
__device__ void produce(uint64_t* full, uint64_t* empty, int8_t* ring,
                        int chunk_bytes, int stages, uint32_t rank,
                        const int8_t* ga, const int8_t* gb, int l, int m1,
                        int m2, int inverse, int st0, int st1) {
  int slot = 0, use = 0;
  for (int st = st0; st < st1; ++st) {
    const bool left = (st == 0) != (inverse != 0);
    const Geom g = geom(left, m1, m2);
    const int8_t* base = (st == 0 ? ga : gb) + l * stream_bytes(left, m1, m2);
    const size_t per_pass = static_cast<size_t>(kDigits) * g.ksteps * g.rows * kKStep;
    for (int pass = 0; pass < g.passes; ++pass) {
      const int8_t* src = base + (left ? pass * per_pass : 0);
      for (int i = 0; i < kDigits; ++i) {
        for (int ks = 0; ks < g.ksteps; ks += kChunkSteps) {
          const int bytes = kChunkSteps * g.rows * kKStep;
          if (use > 0) {
            bar_wait(&full[slot], (use - 1) & 1);
            if (rank == 0) bar_wait(&empty[slot], (use - 1) & 1);
          }
          bar_expect_tx(&full[slot], bytes);
          if (rank == 0)
            bulk_load_multicast(ring + slot * chunk_bytes, src, bytes, &full[slot],
                                static_cast<uint16_t>((1 << kCluster) - 1));
          src += bytes;
          if (++slot == stages) slot = 0, ++use;
        }
      }
    }
  }
}

// The consumers' view of the ring: the next slot and its phase, and the
// slot the last committed wgmma group reads (released one group late).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  const int8_t* base;
  int chunk_bytes, stages, slot, phase, held;
};

// Wait for the next chunk, issue its kChunkSteps wgmmas into acc (k-steps
// ks.. of the stage), then release the chunk the previous group read.
// ga_off / gd_off: byte offsets of this warpgroup's A rows in a G k-step
// slice (left) or in a digit k-step (right).
template <int N>
__device__ __forceinline__ void mma_chunk(uint32_t (&acc)[N / 2], Ring& r,
                                          const int8_t* dig, const Geom& g,
                                          bool left, int ks, int ga_off,
                                          int gd_off, int tid) {
  bar_wait(&r.full[r.slot], r.phase);
  const int8_t* gk = r.base + r.slot * r.chunk_bytes;
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kChunkSteps; ++k) {
    const int8_t* gkk = gk + k * g.rows * kKStep;
    const int8_t* dk = dig + (ks + k) * g.dig_rows * kKStep;
    const uint64_t dg = desc(gkk + ga_off), dd = desc(dk + gd_off);
    wgmma_n(acc, left ? dg : dd, left ? dd : dg, ks + k > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (r.held >= 0 && (tid & 127) == 0) bar_arrive_remote(&r.empty[r.held], 0);
  r.held = r.slot;
  if (++r.slot == r.stages) r.slot = 0, r.phase ^= 1;
}

// Fold digit matrix I's products into S = sum_i 2^(7i) Q_i mod p (Q_i <
// 2^25 < p): Q_0 as it is; Q_0 + 2^7 Q_1 < 2^32 reduced by a Shoup product
// with 1; then a Shoup product with 2^(7i) mod p. wts: this prime's Shoup
// pairs (values, then quotients).
template <int I, int R>
__device__ __forceinline__ void fold(uint32_t (&q)[R], uint32_t (&sum)[R],
                                     const uint32_t* wts, uint32_t p) {
  reg_fence(q);
  const uint32_t w = wts[I == 1 ? 0 : I], wq = wts[kDigits + (I == 1 ? 0 : I)];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    if constexpr (I == 0)
      sum[e] = q[e];
    else if constexpr (I == 1)
      sum[e] = shoup_mul(sum[e] + (q[e] << kDigitBits), w, wq, p);
    else
      sum[e] = add_mod(sum[e], shoup_mul(q[e], w, wq, p), p);
  }
}

// Digit matrix I over the whole stage into acc, then folded into sum.
template <int I, int N>
__device__ __forceinline__ void mma_matrix(uint32_t (&acc)[N / 2],
                                           uint32_t (&sum)[N / 2], Ring& r,
                                           const int8_t* dig, const Geom& g,
                                           bool left, int ga_off, int gd_off,
                                           int tid, const uint32_t* wts,
                                           uint32_t p) {
  for (int ks = 0; ks < g.ksteps; ks += kChunkSteps)
    mma_chunk<N>(acc, r, dig, g, left, ks, ga_off, gd_off, tid);
  wgmma_wait<0>();
  if ((tid & 127) == 0) bar_arrive_remote(&r.empty[r.held], 0);
  r.held = -1;
  fold<I>(acc, sum, wts, p);
}

// The epilogue of one warpgroup's 64 x N tile: rows r0 + [0, 64) of the
// output (those below m1), times the twiddle when twl is given. Lane pairs
// swap halves so that each lane stores four columns of one row (16 bytes).
template <int N>
__device__ void store_tile(const uint32_t (&s)[N / 2], uint32_t* dst, int r0,
                           int m1, const uint32_t* twl, uint32_t p,
                           uint32_t pinv) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const bool odd = lane & 1;
  const int a = r0 + warp * 16 + (lane >> 2) + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t r0v = __shfl_xor_sync(~0u, odd ? s[4 * j] : s[4 * j + 2], 1);
    const uint32_t r1v = __shfl_xor_sync(~0u, odd ? s[4 * j + 1] : s[4 * j + 3], 1);
    uint4 v = odd ? make_uint4(r0v, r1v, s[4 * j + 2], s[4 * j + 3])
                  : make_uint4(s[4 * j], s[4 * j + 1], r0v, r1v);
    const int b0 = 8 * j + 4 * ((lane & 3) >> 1);
    if (a < m1) {
      if (twl != nullptr) {
        const uint4 t = *reinterpret_cast<const uint4*>(twl + a * N + b0);
        v.x = mont_mul(v.x, t.x, p, pinv);
        v.y = mont_mul(v.y, t.y, p, pinv);
        v.z = mont_mul(v.z, t.z, p, pinv);
        v.w = mont_mul(v.w, t.w, p, pinv);
      }
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(a) * N + b0) = v;
    }
  }
}

// ga / gb: the first / second stage's G streams for all L primes (forward:
// G1 then G2; inverse: iG2 then iG1); tw: (L, m1, m2) Montgomery twiddles of
// the first stage; rcs: (L, 2, 5) Shoup pairs of 2^(7i) mod p (the values,
// then floor(value 2^32 / p)). per_prime: rows of each prime (rows / L).
// N = m2.
template <int N>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    ntt_mxu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const int8_t* __restrict__ ga, const int8_t* __restrict__ gb,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ rcs,
                   const uint32_t* __restrict__ primes,
                   const uint32_t* __restrict__ pinvs, int L, int per_prime,
                   int m1, int inverse, int mode, int stages, int chunk_bytes) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int m2 = N;
  const int n = m1 * m2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + kHeader);
  int8_t* dig = ring + stages * chunk_bytes;
  uint32_t* buf = reinterpret_cast<uint32_t*>(dig + digit_bytes(m1, m2));

  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / kCluster;
  const int clusters = (per_prime + kCluster - 1) / kCluster;
  const int l = cid / clusters, j = (cid % clusters) * kCluster + static_cast<int>(rank);
  const bool active = j < per_prime;
  const size_t row = static_cast<size_t>(j) * L + l;
  const int st0 = mode == kSecond ? 1 : 0, st1 = mode == kFirst ? 1 : 2;
  const bool fused = mode == kBoth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kCluster * 2);
    }
    bar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (active && fused) {  // the row, behind the cluster's handshake
      bar_expect_tx(xbar, 4 * n);
      bulk_load(buf, x + row * n, 4 * n, xbar);
    }
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any remote use

  // Registers move from the producer warpgroup to the consumers (a
  // scheduler's share: 2 x 232 + 40 <= 512).
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers)
      produce(full, empty, ring, chunk_bytes, stages, rank, ga, gb, l, m1, m2,
              inverse, st0, st1);
    __syncwarp();
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x, wg = tid >> 7;
    const uint32_t p = primes[l], pinv = pinvs[l];
    const uint32_t* src = fused ? buf : x + row * n;
    if (active && fused) bar_wait(xbar, 0);
    if (active) {
      if ((st0 == 0) != (inverse != 0))
        digits_left(dig, src, m1, m2, tid);
      else
        digits_right(dig, src, m1, m2, geom(false, m1, m2).dig_rows, tid);
    }
    fence_proxy_async();
    consumers_sync();
    // The row buffer is free until stage 1's epilogue: bring this prime's
    // twiddles into it, behind the stage's wgmmas; the epilogue multiplies
    // and writes the intermediate in place.
    const uint32_t* tws = tw + static_cast<size_t>(l) * n;
    if (active && fused && tid == 0) {
      bar_expect_tx(xbar, 4 * n);
      bulk_load(buf, tws, 4 * n, xbar);
    }

    uint32_t qa[N / 2], sum[N / 2];
    Ring r{full, empty, ring, chunk_bytes, stages, 0, 0, -1};
    const uint32_t* wts = rcs + 2 * kDigits * l;
    for (int st = st0; st < st1; ++st) {
      const bool left = (st == 0) != (inverse != 0);
      const Geom g = geom(left, m1, m2);
      uint32_t* dst = (fused && st == 0) ? buf : y + row * n;
      const uint32_t* twl = st != 0 ? nullptr : fused ? buf : tws;
      for (int pass = 0; pass < g.passes; ++pass) {
        // Every warpgroup runs the same wgmma sequence (a wgmma under a
        // thread-dependent branch is serialized by the compiler); one
        // without rows reads rows of the first tile, and only rows it owns
        // are stored.
        const int r0 = pass * kPassRows + wg * kTileRows;
        const bool mine = active && r0 < (m1 < kTileRows ? kTileRows : m1);
        const int ra = mine ? r0 : pass * kPassRows;  // A-operand rows read
        const int ga_off = left ? tile_off(ra - pass * kPassRows, 0) : 0;
        const int gd_off = left ? 0 : tile_off(ra, 0);
        mma_matrix<0, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        mma_matrix<1, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        mma_matrix<2, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        mma_matrix<3, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        mma_matrix<4, N>(qa, sum, r, dig, g, left, ga_off, gd_off, tid, wts, p);
        if (active && fused && st == 0) bar_wait(xbar, 1);
        if (mine) store_tile<N>(sum, dst, r0, m1, twl, p, pinv);
      }
      if (fused && st == 0) {
        consumers_sync();  // the intermediate is whole; no wgmma reads dig
        if (active) {
          if (!left)
            digits_left(dig, buf, m1, m2, tid);
          else
            digits_right(dig, buf, m1, m2, geom(false, m1, m2).dig_rows, tid);
        }
        fence_proxy_async();
        consumers_sync();
      }
    }
    cluster_sync();
  }
}

template <int N>
cudaError_t launch(const void* x, void* y, const void* ga, const void* gb,
                   const void* tw, const void* rcs, const void* primes,
                   const void* pinvs, int rows, int L, int m1, int inverse,
                   int mode, cudaStream_t stream) {
  const Geom gl = geom(true, m1, N), gr = geom(false, m1, N);
  const int chunk = kChunkSteps * kKStep * (gl.rows > gr.rows ? gl.rows : gr.rows);
  const int fixed = kHeader + digit_bytes(m1, N) + (mode == kBoth ? 4 * m1 * N : 0);
  int stages = (kMaxSmem - fixed) / chunk;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(fixed) + stages * chunk;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(ntt_mxu_kernel<N>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const int per_prime = rows / L;
  const int grid = L * ((per_prime + kCluster - 1) / kCluster) * kCluster;
  ntt_mxu_kernel<N><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int8_t*>(ga), static_cast<const int8_t*>(gb),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(rcs),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinvs),
      L, per_prime, m1, inverse, mode, stages, chunk);
  return cudaGetLastError();
}

cudaError_t launch_mode(const void* x, void* y, const void* ga, const void* gb,
                        const void* tw, const void* rcs, const void* primes,
                        const void* pinvs, int rows, int L, int m1, int m2,
                        int inverse, int mode, cudaStream_t s) {
  switch (m2) {
    case 16:
      return launch<16>(x, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, inverse, mode, s);
    case 32:
      return launch<32>(x, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, inverse, mode, s);
    case 64:
      return launch<64>(x, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, inverse, mode, s);
    case 128:
      return launch<128>(x, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, inverse, mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ga / gb: the plan's device G streams (MxuNTTPlan.tensors). tmp: a buffer
// like y, used (and required) only above n = 16384, where each stage is its
// own launch and the first writes the twiddled intermediate there.
// *launched: the number of kernels launched.
extern "C" int nhpsi_ntt_mxu(const void* x, void* y, void* tmp, const void* ga,
                             const void* gb, const void* tw, const void* rcs,
                             const void* primes, const void* pinvs, int rows,
                             int L, int m1, int m2, int inverse, int* launched,
                             void* stream) {
  *launched = 0;
  if (rows <= 0) return 0;
  if (L <= 0 || rows % L || m1 <= 0 || m1 % 16 || m1 > 2 * kPassRows ||
      m2 % 16 || m2 > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m1 * m2 <= kFusedMaxN) {
    err = launch_mode(x, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, m2,
                      inverse, kBoth, s);
    *launched = err == cudaSuccess;
    return static_cast<int>(err);
  }
  if (tmp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_mode(x, tmp, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, m2,
                    inverse, kFirst, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  err = launch_mode(tmp, y, ga, gb, tw, rcs, primes, pinvs, rows, L, m1, m2,
                    inverse, kSecond, s);
  *launched += err == cudaSuccess;
  return static_cast<int>(err);
}
