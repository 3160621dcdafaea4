// BFV's HPS multiply, coefficient by coefficient: the exact drop-limb
// rescale, the fast base extension q' -> aux, the Karatsuba tensor products
// over q' and aux, and scale-and-round with the exact return to q.
//
// Replaces no TPU kernel: the JAX package computes these steps in plain jnp
// (nested_hashing_psi_tpu/ops/basis.py, fhe/bfv.py) and has no Pallas
// kernel for them. They were added because the port's plain versions of the
// same functions (ops/basis.py RNSRescale.rescale, BasisExtension.convert,
// BFVMulConverter.scale_round and exact_to_q; fhe/bgv.py tensor_product)
// build (..., L, L', N) int64 temporaries and run each 32-bit Shoup product
// as a dozen int64 elementwise kernels: BFV's product took some 830 kernels
// and 60 ms a set at the north star (2^24 x 4096, D = 48), 95 % of the
// server's step. Each kernel here is bit-exact with its plain version, for
// every coefficient: the integer steps return canonical residues whatever
// their formulation (modarith.cuh), and the float64 overflow counts add the
// limbs' terms in the plain version's order, limb 0 first, one IEEE product
// and one IEEE add each (__dmul_rn, __dadd_rn: no fused multiply-add), as
// torch.sum over the limb axis adds them on the CPU for rows of 16 or more
// coefficients (every ring the port runs; below 16 torch vectorises the limb
// axis and adds in another order).
//
// What bounds them on an H100 (benchmarks/card.py hps_*_bound; one slab is
// 48 x 16384 int32 = 3.15 MB): bytes, each input read once and each output
// written once, for three; for the third its products, by a hair. At the
// north star's shapes / at 2^20 (D = 12):
//   rescale 6 -> 5 + extension to aux, both operands, (2, D, 2, 6, 16384)
//     in, q' (5 limbs) and aux (8 limbs) out: 239 / 60 MB, 0.0714 / 0.0178 ms;
//   the tensor products over q' and aux: 286 / 72 MB, 0.0855 / 0.0214 ms;
//   scale-and-round + return to q, (D, 3, 5 | 8, 16384) in, (D, 3, 5, 16384)
//     out: 170 / 42 MB, 0.0507 / 0.0127 ms of bytes, 0.0512 / 0.0128 ms of
//     products (121 Shoup products a coefficient, 3 FMA-pipe slots each);
//   the ship rescale 5 -> 4, (D, 2, 5, 16384): 57 / 14 MB, 0.0169 / 0.0042 ms.
// Their products are 32-bit Shoup and Montgomery products (__umulhi, no
// 64-bit emulation).
//
// Design, for that bound:
// - A thread owns one coefficient of one row and loads every limb of it
//   once, along N, so a warp reads 128 contiguous bytes a limb. The limb
//   vectors and the L x L' sums stay in registers (arrays unrolled over the
//   template's limb caps, so no index is dynamic); each output limb is
//   written once. Blocks are persistent (as many as the SMs hold) and walk
//   the coefficients in a grid-stride loop.
// - The first kernel does the rescale and the extension of the rescaled
//   residues in one pass, so q' is read from registers and not from memory;
//   the third keeps y over aux in registers between scale-and-round and the
//   return to q, so it never reaches device memory.
// - Each converter's constants are one table, built once on the host
//   (ops/hps_cuda.py) and staged in shared memory by every block: every
//   thread reads the same word, a broadcast. Shoup pairs (w, floor(w 2^32 /
//   p)) lie in neighbouring words, read as one 8-byte load. The layouts
//   below are fixed (kMaxQ x kMaxAux strides), so an unrolled loop's
//   offsets are immediates.
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "modarith.cuh"

namespace {

constexpr int kMaxQ = 16;    // q-side limbs: the rescale's source, q', the return to q
constexpr int kMaxAux = 20;  // aux limbs, K + 1
constexpr int kThreads = 256;

// Rescale table (RNSRescale: keep the first Lk of L primes, drop Ld).
constexpr int kRKeepP = 0;         // [kMaxQ] keep primes
constexpr int kRDropP = 16;        // [kMaxQ] drop primes
constexpr int kRQdhatInv = 32;     // [kMaxQ] pairs: [(qd/p_i)^-1]_{p_i}, drop i
constexpr int kRQdhatModK = 64;    // [kMaxQ drop][kMaxQ keep] pairs: [qd/p_i]_{k_j}
constexpr int kRQdModK = 576;      // [kMaxQ] pairs: [qd]_{k_j}
constexpr int kRQdinvModK = 608;   // [kMaxQ] pairs: [qd^-1]_{k_j}
constexpr int kRInvDrop = 640;     // [kMaxQ] doubles: 1.0 / p_i, drop i
constexpr int kRWords = 672;
static_assert(kRDropP == kRKeepP + kMaxQ && kRQdhatInv == kRDropP + kMaxQ &&
              kRQdhatModK == kRQdhatInv + 2 * kMaxQ &&
              kRQdModK == kRQdhatModK + 2 * kMaxQ * kMaxQ && kRQdinvModK == kRQdModK + 2 * kMaxQ &&
              kRInvDrop == kRQdinvModK + 2 * kMaxQ && kRWords == kRInvDrop + 2 * kMaxQ,
              "rescale table layout");

// Extension table (BasisExtension: src q, Ls primes -> dst, Kd primes).
constexpr int kESrcP = 0;          // [kMaxQ] src primes
constexpr int kEDstP = 16;         // [kMaxAux] dst primes
constexpr int kEQhatInv = 36;      // [kMaxQ] pairs: [(q/q_i)^-1]_{q_i}
constexpr int kEQhatModB = 68;     // [kMaxQ src][kMaxAux dst] pairs: [q/q_i]_{b_j}
constexpr int kEQModB = 708;       // [kMaxAux] pairs: [q]_{b_j}
constexpr int kEInvSrc = 748;      // [kMaxQ] doubles: 1.0 / q_i
constexpr int kEWords = 780;
static_assert(kEDstP == kESrcP + kMaxQ && kEQhatInv == kEDstP + kMaxAux &&
              kEQhatModB == kEQhatInv + 2 * kMaxQ &&
              kEQModB == kEQhatModB + 2 * kMaxQ * kMaxAux && kEInvSrc == kEQModB + 2 * kMaxAux &&
              kEWords == kEInvSrc + 2 * kMaxQ,
              "extension table layout");

// Multiply table (BFVMulConverter over q with aux = b_1..b_K, m_r; its
// primes are the q -> aux extension table's).
constexpr int kMTQ = 0;            // [kMaxQ] pairs: [t]_{q_i}
constexpr int kMTAux = 32;         // [kMaxAux] pairs: [t]_{aux_j}
constexpr int kMQinvAux = 72;      // [kMaxAux] pairs: [q^-1]_{aux_j}
constexpr int kMCModAux = 112;     // [kMaxAux]: [B/2]_{aux_j}
constexpr int kMCModQ = 132;       // [kMaxQ]: [B/2]_{q_i}
constexpr int kMBhatInv = 148;     // [kMaxAux] pairs: [(B/b_k)^-1]_{b_k}, k < K
constexpr int kMBhatModQ = 188;    // [kMaxAux k][kMaxQ i] pairs: [B/b_k]_{q_i}
constexpr int kMBhatModMr = 828;   // [kMaxAux] pairs: [B/b_k]_{m_r}
constexpr int kMBModQ = 868;       // [kMaxQ] pairs: [B]_{q_i}
constexpr int kMBinvMr = 900;      // one pair: [B^-1]_{m_r}
constexpr int kMWords = 904;
static_assert(kMTAux == kMTQ + 2 * kMaxQ && kMQinvAux == kMTAux + 2 * kMaxAux &&
              kMCModAux == kMQinvAux + 2 * kMaxAux && kMCModQ == kMCModAux + kMaxAux &&
              kMBhatInv == kMCModQ + kMaxQ && kMBhatModQ == kMBhatInv + 2 * kMaxAux &&
              kMBhatModMr == kMBhatModQ + 2 * kMaxAux * kMaxQ &&
              kMBModQ == kMBhatModMr + 2 * kMaxAux && kMBinvMr == kMBModQ + 2 * kMaxQ &&
              kMWords >= kMBinvMr + 2,
              "multiply table layout");

// Tensor-product table: (p, -p^-1 mod 2^32, 2^64 mod p) per limb, q' first.
constexpr int kTWords = 3 * (kMaxQ + kMaxAux);

// flags of the first and the third kernel
constexpr int kRescale = 1, kExtend = 2, kCorrect = 4;
constexpr int kScale = 1, kExact = 2;

using nhpsi::add_mod;
using nhpsi::mont_mul;
using nhpsi::sub_mod;

__device__ __forceinline__ uint32_t shoup(uint32_t x, const uint32_t* pair, uint32_t p) {
  const uint2 c = *reinterpret_cast<const uint2*>(pair);
  return nhpsi::shoup_mul(x, c.x, c.y, p);
}

__device__ __forceinline__ double dbl(const uint32_t* t, int off, int i) {
  return reinterpret_cast<const double*>(t + off)[i];
}

// Copy a table into shared memory; every thread of the block reads it after.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Rescale (L -> Lk, flag kRescale), then the extension of the Lk residues
// (or of the L read residues, without kRescale) to KA primes (kExtend; the
// overflow count with kCorrect). x (rows, L, N); keep (rows, Lk, N) written
// when not null; aux (rows, KA, N) written with kExtend.
template <int MQ, int MA>
__global__ void __launch_bounds__(kThreads, 2)
rescale_extend_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ keep,
                      uint32_t* __restrict__ aux, const uint32_t* __restrict__ rtab,
                      const uint32_t* __restrict__ etab, long long rows, int L, int Lk, int KA,
                      int N, int flags) {
  __shared__ __align__(16) uint32_t sm[kRWords + kEWords];
  const uint32_t* R = sm;
  const uint32_t* E = sm + kRWords;
  const bool rescale = flags & kRescale, extend = flags & kExtend, correct = flags & kCorrect;
  if (rescale) stage(sm, rtab, kRWords);
  if (extend) stage(sm + kRWords, etab, kEWords);
  __syncthreads();
  const int Ls = rescale ? Lk : L;  // the residues the extension reads
  const int Ld = L - Lk;
  const long long total = rows * N;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / N;
    const long long n = g - row * N;
    const uint32_t* xr = x + row * L * N + n;
    uint32_t v[MQ];  // the residues over q' (the rescale's output, or as read)
    if (rescale) {
      uint32_t yd[MQ];
      double s = 0.0;  // sum_i y_i / p_i over the dropped limbs, limb 0 first
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        if (i >= Ld) break;
        const uint32_t r = __ldg(xr + static_cast<long long>(Lk + i) * N);
        yd[i] = shoup(r, R + kRQdhatInv + 2 * i, R[kRDropP + i]);
        s = __dadd_rn(s, __dmul_rn(static_cast<double>(yd[i]), dbl(R, kRInvDrop, i)));
      }
      // v + centering: floor(s), plus one where its fraction exceeds one half
      const double fl = floor(s);
      const uint32_t corr = static_cast<uint32_t>(fl) + (__dsub_rn(s, fl) > 0.5 ? 1u : 0u);
#pragma unroll
      for (int j = 0; j < MQ; ++j) {
        if (j >= Lk) break;
        const uint32_t p = R[kRKeepP + j];
        const uint32_t c = __ldg(xr + static_cast<long long>(j) * N);
        uint32_t acc = 0;
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          if (i >= Ld) break;
          acc = add_mod(acc, shoup(yd[i], R + kRQdhatModK + 2 * (i * kMaxQ + j), p), p);
        }
        const uint32_t rc = sub_mod(acc, shoup(corr, R + kRQdModK + 2 * j, p), p);
        v[j] = shoup(sub_mod(c, rc, p), R + kRQdinvModK + 2 * j, p);
        if (keep != nullptr) keep[(row * Lk + j) * N + n] = v[j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        if (i >= L) break;
        v[i] = __ldg(xr + static_cast<long long>(i) * N);
      }
    }
    if (!extend) continue;
    uint32_t y[MQ];
    double s = 0.0;  // sum_i y_i / q_i, limb 0 first
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      if (i >= Ls) break;
      y[i] = shoup(v[i], E + kEQhatInv + 2 * i, E[kESrcP + i]);
      if (correct) s = __dadd_rn(s, __dmul_rn(static_cast<double>(y[i]), dbl(E, kEInvSrc, i)));
    }
    const uint32_t over = correct ? static_cast<uint32_t>(rint(s)) : 0u;  // half to even
#pragma unroll
    for (int j = 0; j < MA; ++j) {
      if (j >= KA) break;
      const uint32_t b = E[kEDstP + j];
      uint32_t acc = 0;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        if (i >= Ls) break;
        acc = add_mod(acc, shoup(y[i], E + kEQhatModB + 2 * (i * kMaxAux + j), b), b);
      }
      if (correct) acc = sub_mod(acc, shoup(over, E + kEQModB + 2 * j, b), b);
      aux[(row * KA + j) * N + n] = acc;
    }
  }
}

// Karatsuba in Montgomery form, as fhe/bgv.py tensor_product: per limb
// b0m, b1m = b0 R, b1 R; d0 = a0 b0m, d2 = a1 b1m, d1 = (a0 + a1)(b0m + b1m)
// - d0 - d2 (REDC products). qa, qb (rows, 2, Lq, N) -> dq (rows, 3, Lq, N)
// over q', aa, ab (rows, 2, KA, N) -> daux (rows, 3, KA, N) over aux.
__global__ void __launch_bounds__(kThreads)
tensor_kernel(const uint32_t* __restrict__ qa, const uint32_t* __restrict__ qb,
              const uint32_t* __restrict__ aa, const uint32_t* __restrict__ ab,
              uint32_t* __restrict__ dq, uint32_t* __restrict__ daux,
              const uint32_t* __restrict__ ttab, long long rows, int Lq, int KA, int N) {
  __shared__ uint32_t T[kTWords];
  stage(T, ttab, kTWords);
  __syncthreads();
  const long long total = rows * N;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / N;
    const long long n = g - row * N;
    for (int side = 0; side < 2; ++side) {
      const int Ls = side ? KA : Lq;
      const uint32_t* A = (side ? aa : qa) + row * 2 * Ls * N + n;
      const uint32_t* B = (side ? ab : qb) + row * 2 * Ls * N + n;
      uint32_t* D = (side ? daux : dq) + row * 3 * Ls * N + n;
      const uint32_t* c = T + 3 * (side ? Lq : 0);
      const long long plane = static_cast<long long>(Ls) * N;
      for (int l = 0; l < Ls; ++l) {
        const uint32_t p = c[3 * l], pinv = c[3 * l + 1], r2 = c[3 * l + 2];
        const long long o = static_cast<long long>(l) * N;
        const uint32_t a0 = __ldg(A + o), a1 = __ldg(A + o + plane);
        const uint32_t b0m = mont_mul(__ldg(B + o), r2, p, pinv);
        const uint32_t b1m = mont_mul(__ldg(B + o + plane), r2, p, pinv);
        const uint32_t d0 = mont_mul(a0, b0m, p, pinv);
        const uint32_t d2 = mont_mul(a1, b1m, p, pinv);
        const uint32_t mid = mont_mul(add_mod(a0, a1, p), add_mod(b0m, b1m, p), p, pinv);
        D[o] = d0;
        D[o + plane] = sub_mod(sub_mod(mid, d0, p), d2, p);
        D[o + 2 * plane] = d2;
      }
    }
  }
}

// Scale-and-round (kScale): y = [q^-1 (t d - r)]_aux with r = [t d]_q
// extended lazily (no overflow count) from d's residues dq (rows, Lq, N),
// d's aux residues din (rows, KA, N); without kScale y is read from din.
// Then the exact return to q (kExact, Shenoy-Kumaresan through m_r): out
// (rows, Lq, N); without kExact, out (rows, KA, N) is y.
template <int MQ, int MA>
__global__ void __launch_bounds__(kThreads, 2)
scale_exact_kernel(const uint32_t* __restrict__ dq, const uint32_t* __restrict__ din,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ etab,
                   const uint32_t* __restrict__ mtab, long long rows, int Lq, int KA, int N,
                   int flags) {
  __shared__ __align__(16) uint32_t sm[kEWords + kMWords];
  const uint32_t* E = sm;
  const uint32_t* M = sm + kEWords;
  stage(sm, etab, kEWords);
  stage(sm + kEWords, mtab, kMWords);
  __syncthreads();
  const bool scale = flags & kScale, exact = flags & kExact;
  const int K = KA - 1;
  const long long total = rows * N;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / N;
    const long long n = g - row * N;
    const uint32_t* ar = din + row * KA * N + n;
    uint32_t yv[MA];  // y over aux
    if (scale) {
      const uint32_t* qr = dq + row * Lq * N + n;
      uint32_t y[MQ];
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        if (i >= Lq) break;
        const uint32_t q = E[kESrcP + i];
        const uint32_t r = shoup(__ldg(qr + static_cast<long long>(i) * N), M + kMTQ + 2 * i, q);
        y[i] = shoup(r, E + kEQhatInv + 2 * i, q);
      }
#pragma unroll
      for (int j = 0; j < MA; ++j) {
        if (j >= KA) break;
        const uint32_t b = E[kEDstP + j];
        uint32_t r_aux = 0;
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          if (i >= Lq) break;
          r_aux = add_mod(r_aux, shoup(y[i], E + kEQhatModB + 2 * (i * kMaxAux + j), b), b);
        }
        const uint32_t td = shoup(__ldg(ar + static_cast<long long>(j) * N), M + kMTAux + 2 * j, b);
        yv[j] = shoup(sub_mod(td, r_aux, b), M + kMQinvAux + 2 * j, b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < MA; ++j) {
        if (j >= KA) break;
        yv[j] = __ldg(ar + static_cast<long long>(j) * N);
      }
    }
    if (!exact) {
#pragma unroll
      for (int j = 0; j < MA; ++j) {
        if (j >= KA) break;
        out[(row * KA + j) * N + n] = yv[j];
      }
      continue;
    }
    // y + B/2 in [0, B): z_k = [(y + B/2) (B/b_k)^-1]_{b_k}; the same at m_r
    const uint32_t mr = E[kEDstP + K];
    uint32_t z[MA];
    uint32_t y_mr = 0;
#pragma unroll
    for (int k = 0; k < MA; ++k) {
      if (k > K) break;
      const uint32_t b = E[kEDstP + k];
      const uint32_t yp = add_mod(yv[k], M[kMCModAux + k], b);
      if (k < K)
        z[k] = shoup(yp, M + kMBhatInv + 2 * k, b);
      else
        y_mr = yp;
    }
    uint32_t s_mr = 0;
#pragma unroll
    for (int k = 0; k < MA; ++k) {
      if (k >= K) break;
      s_mr = add_mod(s_mr, shoup(z[k], M + kMBhatModMr + 2 * k, mr), mr);
    }
    const uint32_t u = shoup(sub_mod(s_mr, y_mr, mr), M + kMBinvMr, mr);
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      if (i >= Lq) break;
      const uint32_t q = E[kESrcP + i];
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < MA; ++k) {
        if (k >= K) break;
        acc = add_mod(acc, shoup(z[k], M + kMBhatModQ + 2 * (k * kMaxQ + i), q), q);
      }
      acc = sub_mod(acc, shoup(u, M + kMBModQ + 2 * i, q), q);
      out[(row * Lq + i) * N + n] = sub_mod(acc, M[kMCModQ + i], q);
    }
  }
}

// Resident blocks of kThreads threads for a kernel on the current device,
// found once per (kernel, device).
int resident_blocks(const void* kernel, long long* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, long long> found;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = found.find({kernel, dev});
  if (hit != found.end()) {
    *blocks = hit->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = found[{kernel, dev}] = static_cast<long long>(sms) * per_sm;
  return 0;
}

// The grid for `total` coefficients: one thread each while they fit in the
// resident blocks, the resident blocks in a grid-stride loop beyond.
int grid_for(const void* kernel, long long total, unsigned* grid) {
  long long resident = 0;
  if (const int err = resident_blocks(kernel, &resident)) {
    cudaGetLastError();  // a refused runtime call stays the last error: clear it
    return err;
  }
  const long long need = (total + kThreads - 1) / kThreads;
  *grid = static_cast<unsigned>(need < resident ? need : resident);
  return 0;
}

// The smaller limb caps when the counts fit them (the cells' 6 -> 5 + 8 and
// the full basis' 6 + 9): fewer registers, more resident threads.
bool small_caps(int lq, int ka) { return lq <= 8 && ka <= 12; }

}  // namespace

// Each entry checks the counts against the caps, launches one kernel on
// `stream` and returns a cudaError_t; no coefficient launches nothing.
extern "C" int nhpsi_hps_rescale_extend(const void* x, void* keep, void* aux, const void* rtab,
                                        const void* etab, long long rows, int L, int Lk,
                                        int KA, int N, int flags, void* stream) {
  const bool rescale = flags & kRescale, extend = flags & kExtend;
  if (rows < 0 || N < 0 || (!rescale && !extend) || L < 1 || L > kMaxQ ||
      (rescale && (Lk < 1 || Lk >= L)) || (extend && (KA < 1 || KA > kMaxAux)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || N == 0) return 0;  // empty tensors may hold null pointers
  if ((rescale && rtab == nullptr) || (extend && (etab == nullptr || aux == nullptr)) ||
      (!extend && keep == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool small = small_caps(L, extend ? KA : 1);
  const void* kernel = small ? reinterpret_cast<const void*>(rescale_extend_kernel<8, 12>)
                             : reinterpret_cast<const void*>(rescale_extend_kernel<kMaxQ, kMaxAux>);
  unsigned grid = 0;
  if (const int err = grid_for(kernel, rows * N, &grid)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* ko = static_cast<uint32_t*>(keep);
  auto* ao = static_cast<uint32_t*>(aux);
  const auto* r = static_cast<const uint32_t*>(rtab);
  const auto* e = static_cast<const uint32_t*>(etab);
  if (small)
    rescale_extend_kernel<8, 12><<<grid, kThreads, 0, s>>>(xi, ko, ao, r, e, rows, L, Lk, KA, N,
                                                           flags);
  else
    rescale_extend_kernel<kMaxQ, kMaxAux><<<grid, kThreads, 0, s>>>(xi, ko, ao, r, e, rows, L,
                                                                    Lk, KA, N, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nhpsi_hps_tensor(const void* qa, const void* qb, const void* aa, const void* ab,
                                void* dq, void* daux, const void* ttab, long long rows, int Lq,
                                int KA, int N, void* stream) {
  if (rows < 0 || N < 0 || Lq < 1 || Lq > kMaxQ || KA < 1 || KA > kMaxAux)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || N == 0) return 0;
  unsigned grid = 0;
  if (const int err = grid_for(reinterpret_cast<const void*>(tensor_kernel), rows * N, &grid))
    return err;
  tensor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qa), static_cast<const uint32_t*>(qb),
      static_cast<const uint32_t*>(aa), static_cast<const uint32_t*>(ab),
      static_cast<uint32_t*>(dq), static_cast<uint32_t*>(daux),
      static_cast<const uint32_t*>(ttab), rows, Lq, KA, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nhpsi_hps_scale_exact(const void* dq, const void* din, void* out, const void* etab,
                                     const void* mtab, long long rows, int Lq, int KA, int N,
                                     int flags, void* stream) {
  if (rows < 0 || N < 0 || Lq < 1 || Lq > kMaxQ || KA < 2 || KA > kMaxAux ||
      (flags & (kScale | kExact)) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || N == 0) return 0;  // empty tensors may hold null pointers
  if ((flags & kScale) && dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = small_caps(Lq, KA);
  const void* kernel = small ? reinterpret_cast<const void*>(scale_exact_kernel<8, 12>)
                             : reinterpret_cast<const void*>(scale_exact_kernel<kMaxQ, kMaxAux>);
  unsigned grid = 0;
  if (const int err = grid_for(kernel, rows * N, &grid)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint32_t*>(dq);
  const auto* b = static_cast<const uint32_t*>(din);
  auto* o = static_cast<uint32_t*>(out);
  const auto* e = static_cast<const uint32_t*>(etab);
  const auto* m = static_cast<const uint32_t*>(mtab);
  if (small)
    scale_exact_kernel<8, 12><<<grid, kThreads, 0, s>>>(a, b, o, e, m, rows, Lq, KA, N, flags);
  else
    scale_exact_kernel<kMaxQ, kMaxAux><<<grid, kThreads, 0, s>>>(a, b, o, e, m, rows, Lq, KA, N,
                                                                 flags);
  return static_cast<int>(cudaGetLastError());
}
