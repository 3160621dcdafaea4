// A3: NTT-anatomy probe, K1's butterflies without its data movement and
// its data movement without its butterflies.
//
// Replaces the TPU kernel of benchmarks/bench_ntt_anatomy.py (the `call`
// that make_variant(plan, which) returns at :100, pallas_call at :103,
// kernel at :71-98). Per (M, M) tile of one limb row (M = m1 = m2):
//   0 stages: the 7 Cooley-Tukey stages of the split NTT's first half with
//             the prime's s1_v2 table, then 7 Gentleman-Sande stages with
//             s2_v2, all down the columns, with no transpose and no
//             regroup (ct_stage / gs_stage of ops/ntt_pallas.py; their
//             roll form below pair distance 8 is the same function as the
//             split form);
//   1 moves:  a regroup and its undoing, the elementwise Shoup product by
//             the twiddle tw, a transpose, a regroup and its undoing, and
//             the transpose back: as a function only the Shoup product.
// Bit-exact with anatomy_probe_plain in
// nested_hashing_psi_tpu_torch/benchmarks/bench_ntt_anatomy.py. The third
// line of the JAX probe, `full`, is K1 itself (csrc/ntt.cu).
//
// What bounds it on an H100: its bytes, 201 MB read and written once at
// (512, 6, 16384) (0.120 ms at 3.35 TB/s; moves also reads tw, 1.6 MB).
//
// Design (probe_ntt.cuh): a block of M threads takes kRowsPerBlock rows of
// one prime. stages: thread j holds column j of a tile in registers and
// runs all 14 stages on it, with the two tables staged in shared memory
// once per block: butterflies and table reads, no exchange between
// threads, no barrier. moves must move the data, or it would only time one
// Shoup product: thread j loads column j, multiplies by tw and writes it
// to shared memory at the regrouped rows; thread i reads natural row i
// back (the ungroup) and writes it transposed, at regrouped rows again;
// thread j reads its natural column back (ungroup and transpose) and
// stores it. Three barriers per tile; chip_smoke.py checks for LDS and STS
// in its SASS. The regrouped row reads conflict 4-way in shared memory at
// M = 128 (rows off * 16 + blk of one warp fall on 8 banks).
#include "probe_ntt.cuh"

namespace {

using namespace nhpsi_probe;

template <int M>
__device__ __forceinline__ int regrouped(int r) {  // row blk*8 + off -> off*(M/8) + blk
  return (r % 8) * (M / 8) + r / 8;
}

template <int M, int VAR>
constexpr size_t smem_bytes() {
  return VAR == 0 ? 2 * ilog2(M) * M * sizeof(uint2) : sizeof(uint32_t) * M * (M + 1);
}

template <int M, int VAR>
__global__ void __launch_bounds__(M) ntt_anatomy_kernel(const uint32_t* __restrict__ x,
                                                        uint32_t* __restrict__ y,
                                                        const uint32_t* __restrict__ sa,
                                                        const uint32_t* __restrict__ sb,
                                                        const uint32_t* __restrict__ tw,
                                                        const uint32_t* __restrict__ primes,
                                                        int B, int L) {
  constexpr int LOG = ilog2(M), S = M + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * kRowsPerBlock;
  const int b1 = min(B, b0 + kRowsPerBlock);
  const uint32_t p = __ldg(primes + l);
  const int j = threadIdx.x;
  uint32_t a[M];
  if constexpr (VAR == 0) {
    uint2* ta = reinterpret_cast<uint2*>(smem);
    uint2* tb = ta + LOG * M;
    stage_table<M>(ta, sa + static_cast<size_t>(l) * 2 * LOG * M);
    stage_table<M>(tb, sb + static_cast<size_t>(l) * 2 * LOG * M);
    __syncthreads();
    const CtExact ct{p};
    const GsExact gs{p};
#pragma unroll 1
    for (int b = b0; b < b1; ++b) {
      const size_t base = (static_cast<size_t>(b) * L + l) * M * M;
#pragma unroll
      for (int r = 0; r < M; ++r) a[r] = __ldg(x + base + r * M + j);
      run_half<M, 0>(a, ta, ct);
      run_half<M, 0>(a, tb, gs);
#pragma unroll
      for (int r = 0; r < M; ++r) y[base + r * M + j] = a[r];
    }
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(smem);
    const uint32_t* tw0 = tw + static_cast<size_t>(l) * 2 * M * M;
    const uint32_t* tw1 = tw0 + M * M;
#pragma unroll 1
    for (int b = b0; b < b1; ++b) {
      const size_t base = (static_cast<size_t>(b) * L + l) * M * M;
#pragma unroll 16  // fully unrolled, the loads of x and tw spill registers at M = 128
      for (int r = 0; r < M; ++r)
        d[regrouped<M>(r) * S + j] = nhpsi::shoup_mul(__ldg(x + base + r * M + j),
                                                      __ldg(tw0 + r * M + j),
                                                      __ldg(tw1 + r * M + j), p);
      __syncthreads();  // thread j takes natural row j
#pragma unroll
      for (int c = 0; c < M; ++c) a[c] = d[regrouped<M>(j) * S + c];
      __syncthreads();
#pragma unroll
      for (int c = 0; c < M; ++c) d[regrouped<M>(c) * S + j] = a[c];  // transposed
      __syncthreads();  // thread j takes natural column j
#pragma unroll 16
      for (int r = 0; r < M; ++r) y[base + r * M + j] = d[regrouped<M>(j) * S + r];
      __syncthreads();
    }
  }
}

template <int M, int VAR>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint32_t* sa, const uint32_t* sb,
                   const uint32_t* tw, const uint32_t* primes, int B, int L, cudaStream_t s) {
  static bool attr[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<M, VAR>();
  cudaError_t err = allow_smem(ntt_anatomy_kernel<M, VAR>, smem, attr);
  if (err != cudaSuccess) return err;
  ntt_anatomy_kernel<M, VAR><<<blocks_for(B, L), M, smem, s>>>(x, y, sa, sb, tw, primes, B, L);
  return cudaGetLastError();
}

template <int M>
cudaError_t by_variant(int variant, const uint32_t* x, uint32_t* y, const uint32_t* sa,
                       const uint32_t* sb, const uint32_t* tw, const uint32_t* primes, int B,
                       int L, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<M, 0>(x, y, sa, sb, tw, primes, B, L, s);
    case 1: return launch<M, 1>(x, y, sa, sb, tw, primes, B, L, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (B, L, m * m) uint32, limb l mod primes[l]; sa, sb: (L, 2, log2 m,
// m) the plan's s1_v2 and s2_v2 tables; tw: (L, 2, m, m); variant 0
// stages, 1 moves; m in {32, 64, 128}. Returns a cudaError_t.
extern "C" int nhpsi_probe_ntt_anatomy(const void* x, void* y, const void* sa, const void* sb,
                                       const void* tw, const void* primes, int B, int L, int m,
                                       int variant, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* yo = static_cast<uint32_t*>(y);
  const auto* a = static_cast<const uint32_t*>(sa);
  const auto* b = static_cast<const uint32_t*>(sb);
  const auto* t = static_cast<const uint32_t*>(tw);
  const auto* p = static_cast<const uint32_t*>(primes);
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 32: return static_cast<int>(by_variant<32>(variant, xi, yo, a, b, t, p, B, L, s));
    case 64: return static_cast<int>(by_variant<64>(variant, xi, yo, a, b, t, p, B, L, s));
    case 128: return static_cast<int>(by_variant<128>(variant, xi, yo, a, b, t, p, B, L, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
