// fp32 operands on the fp16 tensor cores, as pairs (flat_certified.cu's fp32 body, K5;
// contrastive.cu's tensor-core body, K4).
//
// A group of fp32 values (a row, a row's slice, a tensor) is scaled by a power of two 2^e
// that puts its largest magnitude in [2^13, 2^14), and each scaled value x 2^e (exact) is
// written as hi + lo with hi = fp16(x 2^e) and lo = fp16(x 2^e - hi): x 2^e - hi is exact in
// fp32, so hi + lo carries 22 significant bits of x, and lo's rounding leaves an error of at
// most 2^-22 |x| (for values down to 2^-3 of the group's largest; below, at most 2^-25 of an
// fp16 unit, 2^-39 of the largest). That is TF32's split (11-bit halves) in half the bytes,
// and fp16 products run at twice the TF32 rate. A product a.b is taken as hi.hi + hi.lo +
// lo.hi; lo.lo, below 2^-22 of it, is left out. The scales come back out exactly (powers of
// two) in fp32.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace drt {

// The exponent e of a group whose largest |x| is m: m 2^e in [2^13, 2^14), so no scaled value
// reaches fp16's largest (65504); 0 for m = 0, clamped to [-100, 100] (2^e stays a normal
// float).
__device__ __forceinline__ int split_exp(float m) {
  const int E = (int)((__float_as_uint(m) >> 23) & 255u) - 127;  // m in [2^E, 2^(E+1))
  return m > 0.f ? max(-100, min(100, 13 - E)) : 0;
}

// 2^e as a float, for |e| <= 126
__device__ __forceinline__ float split_pow2(int e) { return __int_as_float((127 + e) << 23); }

// two scaled values -> their hi halves and their lo halves, each pair packed as a half2
// register (a in the low 16 bits)
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __half2 h = __floats2half2_rn(a, b);
  const __half2 l = __floats2half2_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

}  // namespace drt
