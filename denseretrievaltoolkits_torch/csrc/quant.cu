// K7 and K9: per-row symmetric int8 and int4 quantization.
//
// K7 replaces the TPU kernel `_quantize_kernel` (denseretrievaltoolkits_tpu/ops/quant.py:20,
// launched by `quantize_int8_device`, quant.py:40). Per row of x [n_in, H] (fp32 or bf16):
// scale = absmax / 127 in fp32 (1 where that is 0), values = clip(round(x / scale), -127,
// 127) as int8. Rows n_in .. n_out-1 of the output are padding: values 0, scale 1, as a
// zero row quantizes.
//
// K9 replaces `_quantize4_kernel` (quant.py:64, launched by `quantize_int4_device`, :92):
// scale = absmax / 7 (1 where that is 0), codes = clip(round(x / scale), -7, 7), packed two
// to a byte in the column-half layout: byte j of the [H/2] packed row holds code j in its
// low nibble and code j + H/2 in its high nibble, so the search kernels unpack a byte into
// dims j and j + H/2 with two sign extensions. Padding rows are zero bytes at scale 1.
//
// Bit-equality with numpy's `quantize_int8` (index/flat.py:40-46 of the JAX package) is
// K7's contract, so saved int8 payloads interchange: the scale is an IEEE fp32 division
// by 127.0f, x / scale is an IEEE division (__fdiv_rn, not a multiply by 1/scale), and
// the rounding is half to even (rintf, as np.round), not roundf. K9 divides and rounds
// the same way (by 7.0f).
//
// What bounds them on the H100: bytes. Each element is read once (4 or 2 bytes) and
// written once (1 byte, or half a byte for K9); there is one division per element and
// nothing to reuse, so the 3.35 TB/s of device memory is the limit.
//
// Design: one warp per row, 8 rows per 256-thread block. The warp reads its row in
// 4-element vectors (float4 / 4 x bf16) for the absmax, reduces it by shuffles, then
// reads the row again (from L1: 8 rows of 3 KB per block) and writes 4 int8 per store
// (K7) or, for K9, reads 4 dims of the low half and the 4 dims H/2 further on and writes
// the 4 whole bytes that pack them.
#include <cstdint>

#include "common.cuh"

using namespace drt;

namespace {

constexpr int NT = 256;
constexpr int ROWS = NT / 32;

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ static void get(const float4& v, float (&o)[4]) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static void get(const uint2& v, float (&o)[4]) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __bfloat162float(b[e]);
  }
};

// 4 elements src[c .. c+3] as float (VEC: one vector load)
template <typename T>
__device__ __forceinline__ void load4(const T* src, int c, float (&v)[4]) {
  Vec4<T>::get(*reinterpret_cast<const typename Vec4<T>::type*>(src + c), v);
}

// the absmax of one row, reduced over the warp
template <typename T, bool VEC>
__device__ __forceinline__ float row_absmax(const T* src, int H, int lane) {
  float amax = 0.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < H; c += 128) {
      float v[4];
      load4(src, c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  } else {
    for (int c = lane; c < H; c += 32) amax = fmaxf(amax, fabsf(to_float(src[c])));
  }
  return warp_max(amax);
}

// x / scale rounded half to even and clipped to [-qmax, qmax]
__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

// codes lo (dim j) and hi (dim j + H/2) in one byte
__device__ __forceinline__ unsigned char pack4(int lo, int hi) {
  return (unsigned char)((lo & 0xF) | ((hi & 0xF) << 4));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
quantize_int8_kernel(const T* __restrict__ x, signed char* __restrict__ values,
                     float* __restrict__ scales, int n_in, int n_out, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n_out) return;
  signed char* out = values + (size_t)row * H;
  if (row >= n_in) {  // padding
    for (int c = lane; c < H; c += 32) out[c] = 0;
    if (lane == 0) scales[row] = 1.f;
    return;
  }
  const T* src = x + (size_t)row * H;
  float scale = __fdiv_rn(row_absmax<T, VEC>(src, H, lane), 127.f);
  if (scale == 0.f) scale = 1.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < H; c += 128) {
      float v[4];
      load4(src, c, v);
      char4 q;
      q.x = (signed char)quantize(v[0], scale, 127.f);
      q.y = (signed char)quantize(v[1], scale, 127.f);
      q.z = (signed char)quantize(v[2], scale, 127.f);
      q.w = (signed char)quantize(v[3], scale, 127.f);
      *reinterpret_cast<char4*>(out + c) = q;
    }
  } else {
    for (int c = lane; c < H; c += 32)
      out[c] = (signed char)quantize(to_float(src[c]), scale, 127.f);
  }
  if (lane == 0) scales[row] = scale;
}

// VEC: H % 8 == 0, so the 4-dim groups of both halves are vector-aligned
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
quantize_int4_kernel(const T* __restrict__ x, signed char* __restrict__ packed,
                     float* __restrict__ scales, int n_in, int n_out, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n_out) return;
  const int half = H >> 1;
  unsigned char* out = reinterpret_cast<unsigned char*>(packed) + (size_t)row * half;
  if (row >= n_in) {  // padding
    for (int c = lane; c < half; c += 32) out[c] = 0;
    if (lane == 0) scales[row] = 1.f;
    return;
  }
  const T* src = x + (size_t)row * H;
  float scale = __fdiv_rn(row_absmax<T, VEC>(src, H, lane), 7.f);
  if (scale == 0.f) scale = 1.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < half; c += 128) {
      float lo[4], hi[4];
      load4(src, c, lo);
      load4(src, half + c, hi);
      uchar4 b;
      b.x = pack4(quantize(lo[0], scale, 7.f), quantize(hi[0], scale, 7.f));
      b.y = pack4(quantize(lo[1], scale, 7.f), quantize(hi[1], scale, 7.f));
      b.z = pack4(quantize(lo[2], scale, 7.f), quantize(hi[2], scale, 7.f));
      b.w = pack4(quantize(lo[3], scale, 7.f), quantize(hi[3], scale, 7.f));
      *reinterpret_cast<uchar4*>(out + c) = b;
    }
  } else {
    for (int c = lane; c < half; c += 32)
      out[c] = pack4(quantize(to_float(src[c]), scale, 7.f),
                     quantize(to_float(src[half + c]), scale, 7.f));
  }
  if (lane == 0) scales[row] = scale;
}

// int4 = 0: K7 (values [n_out, H]); 1: K9 (packed [n_out, H/2])
template <typename T>
int launch(const void* x, void* values, void* scales, int n_in, int n_out, int H, int int4,
           cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) |
                          reinterpret_cast<uintptr_t>(values) % 4;
  const dim3 grid((n_out + ROWS - 1) / ROWS);
  auto* xs = static_cast<const T*>(x);
  auto* vs = static_cast<signed char*>(values);
  auto* ss = static_cast<float*>(scales);
  const bool vec = H % (int4 ? 8 : 4) == 0 && align == 0;
  if (int4 && vec)
    quantize_int4_kernel<T, true><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  else if (int4)
    quantize_int4_kernel<T, false><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  else if (vec)
    quantize_int8_kernel<T, true><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  else
    quantize_int8_kernel<T, false><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  return (int)cudaGetLastError();
}

int run(const void* x, void* values, void* scales, int n_in, int n_out, int H, int is_bf16,
        int int4, void* stream) {
  if (n_out < n_in || H < 1 || (int4 && H % 2)) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, values, scales, n_in, n_out, H, int4, st)
                 : launch<float>(x, values, scales, n_in, n_out, H, int4, st);
}

}  // namespace

// x [n_in, H] fp32 (is_bf16 = 0) or bf16 -> values [n_out, H] int8, scales [n_out] fp32,
// n_out >= n_in (the rows past n_in are padding)
extern "C" int drt_quantize_int8(const void* x, void* values, void* scales, int n_in, int n_out,
                                 int H, int is_bf16, void* stream) {
  return run(x, values, scales, n_in, n_out, H, is_bf16, 0, stream);
}

// x [n_in, H] fp32 or bf16, H even -> packed [n_out, H/2] int8 (column-half nibbles),
// scales [n_out] fp32; rows past n_in are padding
extern "C" int drt_quantize_int4(const void* x, void* packed, void* scales, int n_in, int n_out,
                                 int H, int is_bf16, void* stream) {
  return run(x, packed, scales, n_in, n_out, H, is_bf16, 1, stream);
}
