// Shared helpers for the hand-written Hopper kernels of denseretrievaltoolkits_torch.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16) and
// computes in fp32. `round_to<T>` reproduces a cast to the compute dtype (as the
// JAX reference's `.astype(compute_dtype)` does) while keeping the value in a
// float register.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace drt {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(signed char v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// two floats rounded to bf16 and packed into one register (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Tensor-core tile product D += A.B with A 16x16 (row-major), B 16x8 (column-major),
// bf16 inputs and fp32 accumulation (mma.sync m16n8k16). Fragment layout, with
// g = lane / 4 and t = lane % 4:
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..2t+1]   a[2] = A[g][2t+8..]   a[3] = A[g+8][2t+8..]
//   b[0] = B[2t..2t+1][g]   b[1] = B[2t+8..2t+9][g]
//   d[0..1] = D[g][2t..2t+1]   d[2..3] = D[g+8][2t..2t+1]
// (the element with the smaller k sits in the low 16 bits of each register).
__device__ __forceinline__ void mma_bf16_16x8x16(float (&d)[4], const unsigned (&a)[4],
                                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same tile product on int8 inputs with int32 accumulation (mma.sync m16n8k32):
// A 16x32, B 32x8. Each register holds four consecutive k (the smallest in the low
// byte): a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] = A[g][4t+16..],
// a[3] = A[g+8][4t+16..]; b0 = B[4t..4t+3][g], b1 = B[4t+16..4t+19][g]; d as above.
__device__ __forceinline__ void mma_s8_16x8x32(int (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four packed int4 bytes -> their four low nibbles or, with `high`, high nibbles,
// sign-extended, as four int8 in one word: (n ^ 8) - 8 per byte, no borrow across bytes.
__device__ __forceinline__ unsigned nibbles(unsigned w, bool high) {
  const unsigned n = (high ? w >> 4 : w) & 0x0F0F0F0Fu;
  return __vsub4(n ^ 0x08080808u, 0x08080808u);
}

// Four int8 (one word, k in byte order) -> four bf16 in two words (lo: bytes 0, 1; hi: bytes
// 2, 3), exactly, with no int-to-float conversion (ivf_cell.cu's int8 rows, flat_serve.cu's K6
// / K8 fragments): each biased byte u = x + 128 becomes the float 2^23 + u (its bits 0x4B000000
// | u, one byte permute), minus 2^23 + 128 leaves x, whose low 16 bits are zero (|x| <= 128),
// so its bf16 is its high half.
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned b = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (bypasses L1), grouped by commit
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of the most recent groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B fragments of two adjacent n8 tiles from a row-major [k][n] bf16 tile in shared
// memory: lane l passes the address of row k0 + (l & 7) + 8 * ((l >> 3) & 1), column
// n0 + 8 * (l >> 4). r[0], r[1] = b0, b1 of tile n0; r[2], r[3] = b0, b1 of tile n0 + 8.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8x8 bf16 matrices from shared memory without transposing: lanes 8i..8i+7
// pass the row addresses of matrix i, and thread (g, t) receives row g, columns
// 2t..2t+1 of each matrix in r[i].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two bf16 values k and k+1 rows apart in a row-major [K, N] matrix, packed as a
// B-fragment register (row k in the low half).
__device__ __forceinline__ unsigned ld_b_pair(const __nv_bfloat16* p, size_t row_stride) {
  const unsigned short lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  const unsigned short hi = __ldg(reinterpret_cast<const unsigned short*>(p + row_stride));
  return (unsigned)lo | ((unsigned)hi << 16);
}

// LayerNorm of one [H] fp32 row held in shared memory (element i at row[i * stride]),
// by one warp: two-pass mean / variance as the reference `_layer_norm`, then
// scale / bias in fp32 and a cast to T on the store.
template <typename T>
__device__ __forceinline__ void warp_layer_norm_row(const float* row, int stride, int H,
                                                    const float* ln_scale, const float* ln_bias,
                                                    float eps, T* out, int lane) {
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += row[c * stride];
  const float mean = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = row[c * stride] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / H + eps);
  for (int c = lane; c < H; c += 32)
    out[c] = from_float<T>((row[c * stride] - mean) * rstd * ln_scale[c] + ln_bias[c]);
}

}  // namespace drt
