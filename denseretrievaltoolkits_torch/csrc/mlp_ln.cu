// K2: fused MLP (wi -> exact gelu -> wo) + residual + LayerNorm, one kernel.
//
// Replaces the TPU kernel `_mlp_ln_kernel` (denseretrievaltoolkits_tpu/ops/attn.py:252,
// launched by `_fused_mlp_ln_impl`, attn.py:303). Semantics follow `_reference_mlp_ln`
// (attn.py:328-341): h = x.wi in fp32 + bi, exact gelu with the real erf (the TPU
// kernel approximates erf, `_erf_approx`), h cast to the compute dtype, y = x + h.wo
// (fp32 accumulation) + bo in fp32, LayerNorm in fp32, cast to the compute dtype.
//
// What bounds it on the H100: the [rows, F] gelu intermediate (4x the hidden width)
// is what the unfused chain writes and reads back; here it never leaves shared
// memory. What is left is the 4*rows*H*F products and the weights: wi and wo (4.7 MB
// each in bf16) stream from L2 into every block.
//
// Design, bf16 at H = 64 * {2,4,8,12,16} and F % 64 == 0 (bert-base): tensor cores
// through mma.sync m16n8k16 with fp32 accumulation. A block owns 32 rows; x sits in
// shared memory as bf16. F is walked in chunks of 64. The weights stream from L2
// (all blocks share their 9.4 MB) into shared memory by 16-byte cp.async: wi in
// double-buffered 64 x 64 k-slices, and the chunk's 64 x H rows of wo spread over the
// same steps, so both loads overlap the products. Warp w computes n8 column tile w of
// the chunk's [32, 64] gelu tile (B fragments by ldmatrix.trans), rounds it to bf16
// into shared memory, and then adds chunk.wo for its H/8 output columns into a
// [32, H/8] fp32 accumulator held in registers. After the last chunk the pre-LN rows
// go to shared memory as fp32 (over the wo buffer) and one warp normalises each row.
//
// Design, otherwise (fp32, whose products must stay exact fp32, and odd widths):
// CUDA-core FFMA. A block owns R=16 rows, held transposed in shared memory as fp32.
// F is walked in chunks of 256: each thread computes one gelu column of the chunk for
// all R rows (x broadcast from shared memory, wi coalesced from L2), the chunk lands in
// shared memory, and each thread adds its R x (H/256) share of chunk.wo into fp32
// registers. After the last chunk the pre-LN rows overwrite x in shared memory and one
// warp normalises each row.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace drt;

namespace {

constexpr int R = 16;       // rows per block
constexpr int NT = 256;     // threads per block; also the F-chunk width
constexpr int NCMAX = 4;    // output columns per thread: H <= NT * NCMAX

size_t smem_bytes(int H) { return sizeof(float) * ((size_t)H * R + (size_t)NT * R); }

__device__ __forceinline__ void load_col(const float* src, float (&v)[R]) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const float4 t = p[i];
    v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
  }
}

// ---- tensor-core path (bf16) --------------------------------------------------------

constexpr int MR = 32;  // rows per block
constexpr int FC = 64;  // F chunk
constexpr int KS = 64;  // k-slice of wi staged per step

template <int NTW>
constexpr size_t mma_smem_bytes() {
  constexpr int H = 64 * NTW;
  // x tile, gelu chunk, two wi k-slices, one wo chunk (reused as the fp32 pre-LN rows)
  return sizeof(__nv_bfloat16) * ((size_t)MR * (H + 8) + (size_t)MR * (FC + 8) +
                                  2 * (size_t)KS * (FC + 8) + (size_t)FC * (H + 8));
}

// NTW: n8 output tiles per warp, H = 8 warps * 8 * NTW
template <int NTW>
__global__ void __launch_bounds__(NT)
mlp_ln_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wi,
                  const __nv_bfloat16* __restrict__ bi, const __nv_bfloat16* __restrict__ wo,
                  const __nv_bfloat16* __restrict__ bo, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, __nv_bfloat16* __restrict__ out, int rows,
                  int F, float eps) {
  constexpr int H = 64 * NTW;
  constexpr int NS = H / KS;   // wi k-slices per chunk
  constexpr int LDX = H + 8;   // the 16-byte pads keep fragment loads conflict-free
  constexpr int LDH = FC + 8;
  constexpr int LDW = FC + 8;
  constexpr int LDO = H + 8;
  constexpr int LDY = H + 4;
  static_assert(MR * LDY * sizeof(float) <= FC * LDO * sizeof(__nv_bfloat16), "ys fits in wos");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [MR][LDX]
  __nv_bfloat16* hs = xs + MR * LDX;                            // [MR][LDH]
  __nv_bfloat16* wis = hs + MR * LDH;                           // [2][KS][LDW]
  __nv_bfloat16* wos = wis + 2 * KS * LDW;                      // [FC][LDO]
  float* ys = reinterpret_cast<float*>(wos);                    // [MR][LDY], after the last chunk

  const int r0 = blockIdx.x * MR;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row / column offsets of this lane within a 16 x 16 B tile
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);

  auto load_wi_slice = [&](int buf, int f0, int k0) {
    for (int idx = tid; idx < KS * FC / 8; idx += NT) {
      const int r = idx / (FC / 8), c = (idx - r * (FC / 8)) * 8;
      cp_async16(wis + (buf * KS + r) * LDW + c, wi + (size_t)(k0 + r) * F + f0 + c);
    }
  };
  auto load_wo_rows = [&](int f0, int rb, int re) {
    for (int idx = tid; idx < (re - rb) * (H / 8); idx += NT) {
      const int r = rb + idx / (H / 8), c = (idx % (H / 8)) * 8;
      cp_async16(wos + r * LDO + c, wo + (size_t)(f0 + r) * H + c);
    }
  };

  for (int idx = tid; idx < MR * H / 8; idx += NT) {
    const int r = idx / (H / 8), c = (idx - r * (H / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) v = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * H + c);
    *reinterpret_cast<uint4*>(xs + r * LDX + c) = v;
  }
  load_wi_slice(0, 0, 0);
  cp_async_commit();

  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const int col0 = warp * 8 * NTW;  // this warp's output columns
  for (int f0 = 0; f0 < F; f0 += FC) {
    float h[2][4];  // gelu chunk: n8 column tile `warp`, both m16 row tiles
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[m][e] = 0.f;
    for (int s = 0; s < NS; ++s) {
      // in flight behind this slice: the next slice, and this step's share of the wo chunk
      if (s + 1 < NS) load_wi_slice((s + 1) & 1, f0, (s + 1) * KS);
      load_wo_rows(f0, s * FC / NS, (s + 1) * FC / NS);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* wbuf = wis + (s & 1) * KS * LDW;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 32) {
        unsigned b[4];  // slice rows kk .. kk+31 at this warp's 8 columns
        ldmatrix_x4_trans(b, wbuf + (kk + lane) * LDW + warp * 8);
#pragma unroll
        for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
          for (int m = 0; m < 2; ++m) {  // the two accumulators alternate: no back-to-back chain
            const __nv_bfloat16* ap = xs + (m * 16 + g) * LDX + s * KS + kk + 16 * k16 + 2 * t;
            const unsigned a[4] = {*reinterpret_cast<const unsigned*>(ap),
                                   *reinterpret_cast<const unsigned*>(ap + 8 * LDX),
                                   *reinterpret_cast<const unsigned*>(ap + 8),
                                   *reinterpret_cast<const unsigned*>(ap + 8 * LDX + 8)};
            mma_bf16_16x8x16(h[m], a, b[2 * k16], b[2 * k16 + 1]);
          }
      }
      __syncthreads();  // this slice's buffer is refilled two steps on
    }
    if (f0 + FC < F) load_wi_slice(0, f0 + FC, 0);  // the next chunk's first slice
    cp_async_commit();
    {
      const int c = warp * 8 + 2 * t;
      const float b0 = to_float(bi[f0 + c]), b1 = to_float(bi[f0 + c + 1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + g + 8 * half;
          const float v0 = h[m][2 * half] + b0, v1 = h[m][2 * half + 1] + b1;
          __nv_bfloat162 p;
          p.x = __float2bfloat16(0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f)));
          p.y = __float2bfloat16(0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f)));
          *reinterpret_cast<__nv_bfloat162*>(hs + r * LDH + c) = p;
        }
    }
    cp_async_wait<1>();  // the wo chunk has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* ap = hs + (m * 16 + g) * LDH + kk + 2 * t;
        a[m][0] = *reinterpret_cast<const unsigned*>(ap);
        a[m][1] = *reinterpret_cast<const unsigned*>(ap + 8 * LDH);
        a[m][2] = *reinterpret_cast<const unsigned*>(ap + 8);
        a[m][3] = *reinterpret_cast<const unsigned*>(ap + 8 * LDH + 8);
      }
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, wos + (kk + lrow) * LDO + col0 + j * 8 + lcol);
        mma_bf16_16x8x16(acc[0][j], a[0], b[0], b[1]);
        mma_bf16_16x8x16(acc[1][j], a[1], b[0], b[1]);
        mma_bf16_16x8x16(acc[0][j + 1], a[0], b[2], b[3]);
        mma_bf16_16x8x16(acc[1][j + 1], a[1], b[2], b[3]);
      }
    }
    __syncthreads();  // hs and wos are rewritten by the next chunk
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int c = col0 + j * 8 + 2 * t;
      const float b0 = to_float(bo[c]), b1 = to_float(bo[c + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + 8 * half;
        ys[r * LDY + c] = (to_float(xs[r * LDX + c]) + acc[m][j][2 * half]) + b0;
        ys[r * LDY + c + 1] = (to_float(xs[r * LDX + c + 1]) + acc[m][j][2 * half + 1]) + b1;
      }
    }
  __syncthreads();
  for (int r = warp; r < MR; r += NT / 32) {
    if (r0 + r < rows)
      warp_layer_norm_row<__nv_bfloat16>(ys + r * LDY, 1, H, ln_scale, ln_bias, eps,
                                         out + (size_t)(r0 + r) * H, lane);
  }
}

template <int NTW>
int launch_mma(const void* x, const void* wi, const void* bi, const void* wo, const void* bo,
               const void* ls, const void* lb, void* out, int rows, int F, float eps,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = mma_smem_bytes<NTW>();
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_mma_kernel<NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_ln_mma_kernel<NTW><<<(rows + MR - 1) / MR, NT, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(wi), static_cast<const bf*>(bi),
      static_cast<const bf*>(wo), static_cast<const bf*>(bo), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<bf*>(out), rows, F, eps);
  return (int)cudaGetLastError();
}

// the tensor-core path, or -1 when the shape or alignment does not fit it
int try_mma(const void* x, const void* wi, const void* bi, const void* wo, const void* bo,
            const void* ls, const void* lb, void* out, int rows, int H, int F, float eps,
            cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wi) |
                         reinterpret_cast<uintptr_t>(wo);
  if (H % 64 != 0 || F % FC != 0 || (ptrs & 15) != 0) return -1;  // 16-byte copies
  switch (H / 64) {
    case 2: return launch_mma<2>(x, wi, bi, wo, bo, ls, lb, out, rows, F, eps, stream);
    case 4: return launch_mma<4>(x, wi, bi, wo, bo, ls, lb, out, rows, F, eps, stream);
    case 8: return launch_mma<8>(x, wi, bi, wo, bo, ls, lb, out, rows, F, eps, stream);
    case 12: return launch_mma<12>(x, wi, bi, wo, bo, ls, lb, out, rows, F, eps, stream);
    case 16: return launch_mma<16>(x, wi, bi, wo, bo, ls, lb, out, rows, F, eps, stream);
    default: return -1;
  }
}

// ---- CUDA-core path ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_ln_kernel(const T* __restrict__ x, const T* __restrict__ wi, const T* __restrict__ bi,
              const T* __restrict__ wo, const T* __restrict__ bo,
              const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
              T* __restrict__ out, int rows, int H, int F, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xT = reinterpret_cast<float*>(smem);  // [H][R]: x, then the pre-LN rows
  float* hT = xT + (size_t)H * R;               // [NT][R]: one gelu chunk

  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < R * H; idx += NT) {
    const int r = idx / H, c = idx - r * H;
    const int row = r0 + r;
    xT[c * R + r] = row < rows ? to_float(x[(size_t)row * H + c]) : 0.f;
  }

  float acc[NCMAX][R];
#pragma unroll
  for (int i = 0; i < NCMAX; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[i][r] = 0.f;

  for (int f0 = 0; f0 < F; f0 += NT) {
    const int cf = min(NT, F - f0);
    __syncthreads();  // xT is filled / the previous chunk's hT readers are done
    if (tid < cf) {
      const int f = f0 + tid;
      float h[R];
#pragma unroll
      for (int r = 0; r < R; ++r) h[r] = 0.f;
      for (int k = 0; k < H; ++k) {
        float xv[R];
        load_col(xT + k * R, xv);
        const float w = to_float(wi[(size_t)k * F + f]);
#pragma unroll
        for (int r = 0; r < R; ++r) h[r] = fmaf(xv[r], w, h[r]);
      }
      const float b = to_float(bi[f]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = h[r] + b;
        hT[tid * R + r] = round_to<T>(0.5f * v * (1.0f + erff(v * 0.70710678118654752f)));
      }
    }
    __syncthreads();
    for (int f = 0; f < cf; ++f) {
      float hv[R];
      load_col(hT + f * R, hv);
      const T* wrow = wo + (size_t)(f0 + f) * H;
#pragma unroll
      for (int i = 0; i < NCMAX; ++i) {
        const int col = tid + NT * i;
        if (col < H) {
          const float w = to_float(wrow[col]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[i][r] = fmaf(hv[r], w, acc[i][r]);
        }
      }
    }
  }
  __syncthreads();  // all chunk reads of xT are done; overwrite it with the pre-LN rows
#pragma unroll
  for (int i = 0; i < NCMAX; ++i) {
    const int col = tid + NT * i;
    if (col < H) {
      const float b = to_float(bo[col]);
#pragma unroll
      for (int r = 0; r < R; ++r) xT[col * R + r] = (xT[col * R + r] + acc[i][r]) + b;
    }
  }
  __syncthreads();
  for (int r = warp; r < R; r += NT / 32) {
    const int row = r0 + r;
    if (row < rows)
      warp_layer_norm_row<T>(xT + r, R, H, ln_scale, ln_bias, eps, out + (size_t)row * H, lane);
  }
}

template <typename T>
int launch(const void* x, const void* wi, const void* bi, const void* wo, const void* bo,
           const void* ls, const void* lb, void* out, int rows, int H, int F, float eps,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int code = try_mma(x, wi, bi, wo, bo, ls, lb, out, rows, H, F, eps, stream);
    if (code >= 0) return code;
  }
  if (H > NT * NCMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (rows + R - 1) / R;
  mlp_ln_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(bi),
      static_cast<const T*>(wo), static_cast<const T*>(bo), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<T*>(out), rows, H, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int drt_mlp_ln(const void* x, const void* wi, const void* bi, const void* wo,
                          const void* bo, const void* ls, const void* lb, void* out, int rows,
                          int H, int F, float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, wi, bi, wo, bo, ls, lb, out, rows, H, F, eps, st)
                 : launch<float>(x, wi, bi, wo, bo, ls, lb, out, rows, H, F, eps, st);
}
