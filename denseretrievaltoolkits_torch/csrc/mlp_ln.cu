// K2: fused MLP (wi -> exact gelu -> wo) + residual + LayerNorm.
//
// Replaces the TPU kernel `_mlp_ln_kernel` (denseretrievaltoolkits_tpu/ops/attn.py:252,
// launched by `_fused_mlp_ln_impl`, attn.py:303). Semantics follow `_reference_mlp_ln`
// (attn.py:328-341): h = x.wi in fp32 + bi, exact gelu with the real erf (the TPU
// kernel approximates erf, `_erf_approx`), h cast to the compute dtype, y = x + h.wo
// (fp32 accumulation) + bo in fp32, LayerNorm in fp32, cast to the compute dtype.
//
// What bounds it on the H100: the 4 * rows * H * F operations of the two products. At
// bert-base (H = 768, F = 3072) and 9,984 rows that is 94.2 GFLOP, 0.095 ms at the bf16
// peak; the bytes it must move (x, the weights, out: 40 MB) take 0.012 ms.
//
// Design, bf16 at H = 64 * {2,4,8,12,16} and F % 64 == 0 (bert-base): two launches of
// one wgmma + TMA body (`mlp_ln_wgmma`, launched as the kernels `mlp_ln_stage_a` and
// `mlp_ln_stage_b`), the Hopper form of a GEMM with a fused epilogue.
// The launch plan (tile rows, grids, cluster width, scratch) is `ops/attn.py:mlp_ln_plan`;
// the wrapper passes its tile rows here.
//   Stage A: h = bf16(gelu(x.wi + bi)) into a [rows, F] bf16 scratch the wrapper
//     allocates. Writing h and reading it back costs 4 * rows * F bytes (123 MB at 9,984
//     rows), which leaves about 640 operations per byte, above the card's ridge (295):
//     the products still bound the kernel, and no block has to hold a [rows, H] fp32 sum
//     beside the first product's accumulator, as the TPU kernel's VMEM did. Tiles of 128
//     columns, two CTAs an SM, so that the exact gelu (erff) of one CTA's epilogue runs
//     under the other CTA's products.
//   Stage B: out = LN((x + h.wo) + bo). A thread-block cluster of H / 256 CTAs (one CTA
//     of 128 columns at H = 128) spans a row block's H columns; each CTA adds x and bo to
//     its 256 columns in registers and the cluster exchanges per-row partial sums through
//     distributed shared memory, once for the mean and once for the squared deviations,
//     then each CTA normalizes and stores its columns. One CTA an SM.
// A CTA computes 128 rows (two consumer warpgroups of 64) or, where 128-row tiles would
// leave more than half the SMs idle, 64 (one). A producer warp brings 64-deep k-slices
// of both operands by TMA (128-byte swizzle; rows and columns past the matrix read as
// zeros) into a ring of stages (3 in stage A, 4 in stage B) guarded by `full` / `empty`
// mbarriers; each consumer warpgroup issues wgmma m64nBNk16 on them (A K-major, B
// MN-major: the row-major weights as they lie), keeps one slice's products in flight and
// returns the stage before to the producer. What this does about the limits of the
// first body (mma.sync, 32-row blocks; 1.23 ms at 9,984 rows on an H100):
//   1. weights re-read from L2: a tile of 128 rows reads each weight element once per
//      128 rows, not per 32;
//   2. one block an SM at 2.4 waves: stage A runs two CTAs an SM, 24 x 78 tiles at 9,984
//      rows; stage B one, 3 x 78, each CTA with a 48-slice k-loop;
//   3. mma.sync fed by 32-bit shared loads: wgmma reads both operands from shared memory
//      by descriptor;
//   4. two barriers per 64 x 64 slice: none in the k-loop, only the ring's mbarriers, so
//      TMA brings the next slices while the current one's products run;
//   5. cp.async by every thread: one thread issues TMA; the others spend no registers or
//      instructions on copies.
//
// nvcc -Xptxas -v (sm_90a; `kernel_ab.py --ptxas`): registers / dynamic shared memory
// bytes, no spills, no stack:
//   stage A <2 warpgroups, 128 columns> 90 / 100,400; <1, 128> 96 / 75,312;
//   stage B <2, 256> 168 / 198,720; <1, 256> 255 / 165,440; <2, 128> 145 / 133,184;
//   <1, 128> 145 / 99,904.
//
// The body and its launch are in wgmma_ln.cuh, which csrc/attn_ln.cu includes too: K1's
// second launch, `attn_ln_stage_b`, is stage B with the depth F set to H.
//
// Design, otherwise (fp32, whose products must stay exact fp32; odd widths; operands
// not 16-byte aligned, which TMA cannot read): CUDA-core FFMA, no path launches it. A
// block owns R=16 rows, held transposed in shared memory as fp32. F is walked in chunks
// of 256: each thread computes one gelu column of the chunk for all R rows (x broadcast
// from shared memory, wi coalesced from L2), the chunk lands in shared memory, and each
// thread adds its R x (H/256) share of chunk.wo into fp32 registers. After the last chunk
// the pre-LN rows overwrite x in shared memory and one warp normalises each row.
#include <cstdint>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_ln.cuh"

using namespace drt;
using namespace drt::wgmma_ln;

namespace {

// ---- tensor-core path (bf16): wgmma + TMA (the body is wgmma_ln.cuh's) ----------------

// The two stages as kernels of their own names, so that a profile tells them apart; one
// signature, stage A ignoring x, the LN parameters and eps.
template <int NWG, int BN>
__global__ void __launch_bounds__(Layout<NWG, BN, GELU>::THREADS, Layout<NWG, BN, GELU>::CTAS_PER_SM)
mlp_ln_stage_a(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
               const bf* __restrict__ bias, const bf* __restrict__ x,
               const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
               bf* __restrict__ out, int M, int N, int K, float eps) {
  mlp_ln_wgmma<NWG, BN, GELU>(tma, tmb, bias, x, ln_scale, ln_bias, out, M, N, K, eps);
}

template <int NWG, int BN>
__global__ void __launch_bounds__(Layout<NWG, BN, LAYER_NORM>::THREADS,
                                  Layout<NWG, BN, LAYER_NORM>::CTAS_PER_SM)
mlp_ln_stage_b(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
               const bf* __restrict__ bias, const bf* __restrict__ x,
               const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
               bf* __restrict__ out, int M, int N, int K, float eps) {
  mlp_ln_wgmma<NWG, BN, LAYER_NORM>(tma, tmb, bias, x, ln_scale, ln_bias, out, M, N, K, eps);
}

// the kernels launch_stage / launch_ln take
struct StageA {
  template <int NWG, int BN>
  static auto get() { return &mlp_ln_stage_a<NWG, BN>; }
};
struct StageB {
  template <int NWG, int BN>
  static auto get() { return &mlp_ln_stage_b<NWG, BN>; }
};

// Both stages at tile rows bm_a / bm_b (64 or 128, from mlp_ln_plan): h = gelu(x.wi + bi)
// into the scratch h [rows, F], then out = LN((x + h.wo) + bo).
int launch_wgmma(const void* x, const void* wi, const void* bi, const void* wo, const void* bo,
                 const void* ls, const void* lb, void* out, void* h, int rows, int H, int F,
                 float eps, int bm_a, int bm_b, cudaStream_t st) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wi) |
                         reinterpret_cast<uintptr_t>(wo) | reinterpret_cast<uintptr_t>(h);
  const int w = H / 64;
  if (rows < 1 || H % 64 != 0 || !(w == 2 || w == 4 || w == 8 || w == 12 || w == 16) ||
      F < 64 || F % 64 != 0 || (ptrs & 15) != 0 || (bm_a != 64 && bm_a != 128) ||
      (bm_b != 64 && bm_b != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, twi, th, two;
  int err;
  if ((err = matrix_map(&tx, x, rows, H, bm_a)) || (err = matrix_map(&twi, wi, H, F, 64)) ||
      (err = matrix_map(&th, h, rows, F, bm_b)) || (err = matrix_map(&two, wo, F, H, 64)))
    return err;
  err = bm_a == 128
            ? launch_stage<StageA, 2, 128, GELU>(tx, twi, bi, nullptr, nullptr, nullptr, h, rows,
                                                 F, H, eps, st)
            : launch_stage<StageA, 1, 128, GELU>(tx, twi, bi, nullptr, nullptr, nullptr, h, rows,
                                                 F, H, eps, st);
  if (err) return err;
  return launch_ln<StageB>(th, two, bo, x, ls, lb, out, rows, H, F, eps, bm_b, st);
}

// ---- CUDA-core path ------------------------------------------------------------------

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

// bm_a / bm_b: the wgmma body's tile rows (64 or 128) for bf16, with h the [rows, F] bf16
// scratch; 0 for the CUDA-core body (fp32, or what the wgmma body does not take)
extern "C" int drt_mlp_ln(const void* x, const void* wi, const void* bi, const void* wo,
                          const void* bo, const void* ls, const void* lb, void* out, void* h,
                          int rows, int H, int F, float eps, int is_bf16, int bm_a, int bm_b,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch<float>(x, wi, bi, wo, bo, ls, lb, out, rows, H, F, eps, st);
  if (bm_a == 0 && bm_b == 0)
    return launch<bf>(x, wi, bi, wo, bo, ls, lb, out, rows, H, F, eps, st);
  return launch_wgmma(x, wi, bi, wo, bo, ls, lb, out, h, rows, H, F, eps, bm_a, bm_b, st);
}
