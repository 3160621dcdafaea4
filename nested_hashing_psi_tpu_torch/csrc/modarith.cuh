// 32-bit modular arithmetic shared by the port's kernels.
//
// Residues are uint32 in [0, p) with p < 2^31 (the same bits the PyTorch side
// holds as int32). Every helper returns the canonical residue, so a kernel is
// bit-exact with the plain PyTorch version in ops/modmath.py.
#pragma once
#include <cstdint>

namespace nhpsi {

// x mod p for x < 2p, branch-free: when x < p, x - p wraps above x.
__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t p) {
  return min(x, x - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  return csub(a + b, p);  // a + b < 2p < 2^32: no wrap
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return csub(a - b + p, p);  // wraps mod 2^32 to a - b + p < 2p
}

// x * w mod p with Shoup's quotient wq = floor(w * 2^32 / p). q
// underestimates floor(x * w / p) by at most 1, so the remainder computed
// with unsigned wraparound lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t wq, uint32_t p) {
  uint32_t q = __umulhi(x, wq);
  uint32_t r = x * w - q * p;
  return csub(r, p);
}

// Montgomery reduction x * 2^-32 mod p (REDC) of x < p * 2^32, with
// pinv = -p^-1 mod 2^32: x + m p is a multiple of 2^32, its low word carries
// out unless lo == 0, and the quotient is below 2p.
__device__ __forceinline__ uint32_t redc(uint64_t x, uint32_t p, uint32_t pinv) {
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t m = lo * pinv;
  return csub(static_cast<uint32_t>(x >> 32) + __umulhi(m, p) + (lo != 0u), p);
}

// Montgomery product a * b * 2^-32 mod p.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
  return redc(static_cast<uint64_t>(a) * b, p, pinv);
}

}  // namespace nhpsi
