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
// What bounds it on an H100: stages, its bytes and its instructions about
// equally: 201 MB read and written once at (512, 6, 16384) is 0.120 ms at
// 3.35 TB/s, and its 352 M butterflies on the busier integer pipe, the FMA
// pipe's 5.4 issue slots a butterfly in its SASS (a high product takes
// two), 0.113 ms (benchmarks/bench_ntt_lazy_probe.py bound_ms); moves, its
// bytes (it also reads tw, 1.6 MB).
//
// Design. stages (probe_ntt.cuh): a thread holds one class of one column,
// C = 16 residues at M = 128, and runs all 14 stages on it in registers,
// with no exchange and no barrier; the two tables (14 KB) are staged in
// shared memory once per block, and a butterfly's entry, the same for the
// warp's 32 columns of one class, is a broadcast read. A warp's loads and
// stores are 128 B rows of 32 consecutive columns. The blocks of a prime
// walk its slabs in a grid-stride loop over the resident blocks, so the
// launch has no wave tail, and a thread loads its next slab's class before
// it runs the stages of this one, so the loads overlap the integer work.
// moves must move the data, or it would only time one Shoup product: a
// block of M threads takes kRowsPerBlock rows of one prime; thread j loads
// column j, multiplies by tw and writes it to shared memory at the
// regrouped rows; thread i reads natural row i back (the ungroup) and
// writes it transposed, at regrouped rows again; thread j reads its
// natural column back (ungroup and transpose) and stores it. Three
// barriers per tile; chip_smoke.py checks for LDS and STS in its SASS. The
// regrouped row reads conflict 4-way in shared memory at M = 128 (rows
// off * 16 + blk of one warp fall on 8 banks).
#include "probe_ntt.cuh"

namespace {

using namespace nhpsi_probe;

constexpr int kRowsPerBlock = 4;  // moves: rows a block takes in turn

template <int M>
__device__ __forceinline__ int regrouped(int r) {  // row blk*8 + off -> off*(M/8) + blk
  return (r % 8) * (M / 8) + r / 8;
}

template <int M>
constexpr size_t stages_smem() {
  return 2 * ilog2(M) * M * sizeof(uint2);
}

template <int M>
__global__ void __launch_bounds__(kThreads) anatomy_stages_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y, const uint32_t* __restrict__ sa,
    const uint32_t* __restrict__ sb, const uint32_t* __restrict__ primes, int B, int L) {
  constexpr int LOG = ilog2(M), S = kStride<M>, C = kClass<M>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* ta = reinterpret_cast<uint2*>(smem);
  uint2* tb = ta + LOG * M;
  const SlabWalk w = slab_walk<M>(B, L);
  stage_table<M>(ta, sa + static_cast<size_t>(w.l) * 2 * LOG * M);
  stage_table<M>(tb, sb + static_cast<size_t>(w.l) * 2 * LOG * M);
  const CtExact ct{__ldg(primes + w.l)};
  const GsExact gs{ct.p};
  __syncthreads();
  const int c = threadIdx.x % M;
  uint32_t a[C], next[C];
  if (w.first < w.end) load_class<M>(next, x + slab_at<M>(w.first, w.l, L, c));
#pragma unroll 1
  for (int s = w.first; s < w.end; s += w.stride) {
#pragma unroll
    for (int i = 0; i < C; ++i) a[i] = next[i];
    // the next slab's loads are in flight while this one's stages run
    if (s + w.stride < w.end) load_class<M>(next, x + slab_at<M>(s + w.stride, w.l, L, c));
    const int alpha = s % S;
    run_half<M, 0>(a, ta + alpha, ct);
    run_half<M, 0>(a, tb + alpha, gs);
    uint32_t* out = y + slab_at<M>(s, w.l, L, c);
#pragma unroll
    for (int i = 0; i < C; ++i) out[i * S * M] = a[i];
  }
}

template <int M>
__global__ void __launch_bounds__(M) anatomy_moves_kernel(const uint32_t* __restrict__ x,
                                                          uint32_t* __restrict__ y,
                                                          const uint32_t* __restrict__ tw,
                                                          const uint32_t* __restrict__ primes,
                                                          int B, int L) {
  constexpr int S = M + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * kRowsPerBlock;
  const int b1 = min(B, b0 + kRowsPerBlock);
  const uint32_t p = __ldg(primes + l);
  const int j = threadIdx.x;
  uint32_t a[M];
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

template <int M>
cudaError_t launch_stages(const uint32_t* x, uint32_t* y, const uint32_t* sa, const uint32_t* sb,
                          const uint32_t* primes, int B, int L, cudaStream_t s) {
  static int found[kMaxDevices] = {};
  constexpr size_t smem = stages_smem<M>();
  static_assert(smem <= 48 * 1024, "stages needs no opt-in shared memory");
  int resident = 0;
  const cudaError_t err = resident_blocks(anatomy_stages_kernel<M>, smem, found, &resident);
  if (err != cudaSuccess) return err;
  anatomy_stages_kernel<M><<<slab_grid<M>(resident, B, L), kThreads, smem, s>>>(x, y, sa, sb,
                                                                                primes, B, L);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_moves(const uint32_t* x, uint32_t* y, const uint32_t* tw,
                         const uint32_t* primes, int B, int L, cudaStream_t s) {
  static bool attr[kMaxDevices] = {};
  constexpr size_t smem = sizeof(uint32_t) * M * (M + 1);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && smem > 48 * 1024 && !attr[dev]) {
    err = cudaFuncSetAttribute(anatomy_moves_kernel<M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    attr[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  const int grid = L * ((B + kRowsPerBlock - 1) / kRowsPerBlock);
  anatomy_moves_kernel<M><<<grid, M, smem, s>>>(x, y, tw, primes, B, L);
  return cudaGetLastError();
}

template <int M>
cudaError_t by_variant(int variant, const uint32_t* x, uint32_t* y, const uint32_t* sa,
                       const uint32_t* sb, const uint32_t* tw, const uint32_t* primes, int B,
                       int L, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_stages<M>(x, y, sa, sb, primes, B, L, s);
    case 1: return launch_moves<M>(x, y, tw, primes, B, L, s);
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
