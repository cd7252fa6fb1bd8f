// K7: per-row symmetric int8 quantization.
//
// Replaces the TPU kernel `_quantize_kernel` (denseretrievaltoolkits_tpu/ops/quant.py:20,
// launched by `quantize_int8_device`, quant.py:40). Per row of x [n_in, H] (fp32 or
// bf16): scale = absmax / 127 in fp32 (1 where that is 0), values = clip(round(x /
// scale), -127, 127) as int8. Rows n_in .. n_out-1 of the output are padding: values 0,
// scale 1, as a zero row quantizes.
//
// Bit-equality with numpy's `quantize_int8` (index/flat.py:40-46 of the JAX package) is
// the contract, so saved int8 payloads interchange: the scale is an IEEE fp32 division
// by 127.0f, x / scale is an IEEE division (__fdiv_rn, not a multiply by 1/scale), and
// the rounding is half to even (rintf, as np.round), not roundf.
//
// What bounds it on the H100: bytes. Each element is read once (4 or 2 bytes) and
// written once (1 byte); there is one division per element and nothing to reuse, so
// the 3.35 TB/s of device memory is the limit.
//
// Design: one warp per row, 8 rows per 256-thread block. The warp reads its row in
// 4-element vectors (float4 / 4 x bf16) for the absmax, reduces it by shuffles, then
// reads the row again (from L1: 8 rows of 3 KB per block) and writes 4 int8 per store.
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

__device__ __forceinline__ signed char quantize(float x, float scale) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return (signed char)(int)v;
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
  using V = typename Vec4<T>::type;
  float amax = 0.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < H; c += 128) {
      float v[4];
      Vec4<T>::get(*reinterpret_cast<const V*>(src + c), v);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  } else {
    for (int c = lane; c < H; c += 32) amax = fmaxf(amax, fabsf(to_float(src[c])));
  }
  amax = warp_max(amax);
  float scale = __fdiv_rn(amax, 127.f);
  if (scale == 0.f) scale = 1.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < H; c += 128) {
      float v[4];
      Vec4<T>::get(*reinterpret_cast<const V*>(src + c), v);
      char4 q;
      q.x = quantize(v[0], scale);
      q.y = quantize(v[1], scale);
      q.z = quantize(v[2], scale);
      q.w = quantize(v[3], scale);
      *reinterpret_cast<char4*>(out + c) = q;
    }
  } else {
    for (int c = lane; c < H; c += 32) out[c] = quantize(to_float(src[c]), scale);
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
int launch(const void* x, void* values, void* scales, int n_in, int n_out, int H,
           cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) |
                          reinterpret_cast<uintptr_t>(values) % 4;
  const dim3 grid((n_out + ROWS - 1) / ROWS);
  auto* xs = static_cast<const T*>(x);
  auto* vs = static_cast<signed char*>(values);
  auto* ss = static_cast<float*>(scales);
  if (H % 4 == 0 && align == 0)
    quantize_int8_kernel<T, true><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  else
    quantize_int8_kernel<T, false><<<grid, NT, 0, stream>>>(xs, vs, ss, n_in, n_out, H);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n_in, H] fp32 (is_bf16 = 0) or bf16 -> values [n_out, H] int8, scales [n_out] fp32,
// n_out >= n_in (the rows past n_in are padding)
extern "C" int drt_quantize_int8(const void* x, void* values, void* scales, int n_in, int n_out,
                                 int H, int is_bf16, void* stream) {
  if (n_out < n_in || H < 1) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, values, scales, n_in, n_out, H, st)
                 : launch<float>(x, values, scales, n_in, n_out, H, st);
}
