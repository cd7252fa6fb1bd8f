// K2's Hopper body, shared with K1's second launch: C = A.B by wgmma + TMA for one tile
// of 64 or 128 rows, with a GELU or a LAYER_NORM epilogue (the design is described in
// csrc/mlp_ln.cu), and the host side that launches it.
//
// Each source runs the body under kernel names of its own, so that a profile tells the
// launches apart: csrc/mlp_ln.cu as `mlp_ln_stage_a` / `mlp_ln_stage_b` (K2), csrc/attn_ln.cu
// as `attn_ln_stage_b` (K1). It defines them as __global__ templates over <NWG, BN> that
// call `mlp_ln_wgmma`, and hands them to `launch_stage` / `launch_ln` through a type
// `Kernels` whose `get<NWG, BN>()` returns the kernel for those arguments.
#pragma once

#include <cstdint>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace drt {
namespace wgmma_ln {

using bf = __nv_bfloat16;

constexpr int KS = 64;                 // k-slice: one 128-byte swizzle atom of bf16
constexpr uint32_t BOX_B = 64 * 128;   // one 64 x 64 box of B, bytes
constexpr size_t SMEM_MAX = 232448;

enum Epilogue { GELU, LAYER_NORM };

template <int NWG, int BN, int EPI>
struct Layout {
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;  // consumer warpgroups and a producer warp
  // stage A: two CTAs an SM (three stages each, 64 accumulator registers a thread), so
  // that one CTA's gelu epilogue runs under the other's products
  static constexpr int CTAS_PER_SM = EPI == GELU ? 2 : 1;
  static constexpr int NST = EPI == GELU ? 3 : 4;  // stages of the operand ring
  static constexpr uint32_t A_BYTES = BM * 128;
  static constexpr uint32_t STAGE = A_BYTES + (BN / 64) * BOX_B;
  static constexpr uint32_t RED = 2 * BM * 4;  // per-row partials: sums, then squared deviations
  static constexpr uint32_t BARS = 2 * NST * 8;
  static constexpr size_t SMEM = 1024 + NST * STAGE + RED + BARS;  // + alignment
  static_assert(SMEM * CTAS_PER_SM <= SMEM_MAX, "shared memory");
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// C = A.B for one BM x BN tile: A [M, K] bf16 (K-major), B [K, N] bf16 (row-major) by TMA;
// N % 64 == 0 and K % 64 == 0. EPI says what becomes of C:
//   GELU: out[M, N] = bf16(gelu(C + bias)) (stage A: A = x, B = wi, out = h);
//   LAYER_NORM: y = (x + C) + bias in fp32 and out = bf16(LN(y) * ln_scale + ln_bias), the
//     row statistics over N = gridDim.x * BN columns, the grid's x being one cluster
//     (stage B: A = h, B = wo).
// The tensor maps are the kernel's __grid_constant__ parameters, passed on by reference.
template <int NWG, int BN, int EPI>
__device__ __forceinline__ void
mlp_ln_wgmma(const CUtensorMap& tma, const CUtensorMap& tmb, const bf* __restrict__ bias,
             const bf* __restrict__ x, const float* __restrict__ ln_scale,
             const float* __restrict__ ln_bias, bf* __restrict__ out, int M, int N, int K,
             float eps) {
  using L = Layout<NWG, BN, EPI>;
  constexpr int BM = L::BM, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t red = base + NST * L::STAGE;  // [2][BM] floats
  float* red_g = reinterpret_cast<float*>(smem_raw + (red - raw));
  const uint32_t bars = red + L::RED;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };
  auto a_s = [&](int s) { return base + s * L::STAGE; };
  auto b_s = [&](int s) { return base + s * L::STAGE + L::A_BYTES; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = K / KS;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer
    if (lane == 0) {
      const int nbox = min(BN, N - n0) / 64;  // B boxes inside the matrix
      const uint32_t bytes = L::A_BYTES + nbox * BOX_B;
      int stage = 0;
      unsigned phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), bytes);
        tma_load_2d(a_s(stage), &tma, kb * KS, m0, full(stage));
        for (int c = 0; c < nbox; ++c)
          tma_load_2d(b_s(stage) + c * BOX_B, &tmb, n0 + 64 * c, kb * KS, full(stage));
        if (++stage == NST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (EPI == LAYER_NORM) {  // the consumers' three cluster barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63, its warp wi rows 16 wi .. + 15
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_off = wg * 64 * 128;
  int stage = 0, prev = 0;
  unsigned phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(full(stage), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const uint64_t da = sw128_desc(a_s(stage) + a_off + kk * 32, 16);
      const uint64_t db = sw128_desc(b_s(stage) + kk * 2048, BOX_B);
      if constexpr (BN == 256)
        wgmma_ss_n256_mn(acc, da, db, 1);
      else
        wgmma_ss_n128_mn(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the slice before is done: its stage goes back to the producer
    if (kb > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(prev));
    }
    prev = stage;
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rl[2] = {wg * 64 + wi * 16 + g, wg * 64 + wi * 16 + g + 8};  // rows in the tile
  if constexpr (EPI == GELU) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      if (col < N) {
        const float b0 = to_float(bias[col]), b1 = to_float(bias[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + rl[i];
          if (row < M)
            *reinterpret_cast<unsigned*>(out + (size_t)row * N + col) =
                pack_bf16(gelu_erf(acc[4 * n + 2 * i] + b0), gelu_erf(acc[4 * n + 2 * i + 1] + b1));
        }
      }
    }
  } else {
    // y = (x + C) + bias in place, and the row sums of this CTA's columns
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      const float b0 = to_float(bias[col]), b1 = to_float(bias[col + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + rl[i];
        float x0 = 0.f, x1 = 0.f;
        if (row < M) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * N + col);
          x0 = __low2float(xv);
          x1 = __high2float(xv);
        }
        float& y0 = acc[4 * n + 2 * i];
        float& y1 = acc[4 * n + 2 * i + 1];
        y0 = (x0 + y0) + b0;
        y1 = (x1 + y1) + b1;
        s[i] += y0 + y1;
      }
    }
    const unsigned nc = gridDim.x;  // the cluster: every CTA of a row block
    float mean[2], rstd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
      if (t == 0) red_g[rl[i]] = s[i];
    }
    cluster_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tot = 0.f;
      for (unsigned r = 0; r < nc; ++r) tot += ld_cluster_f32(red + 4u * rl[i], r);
      mean[i] = tot / N;
      s[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[4 * n + 2 * i + e] - mean[i];
          s[i] += d * d;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
      if (t == 0) red_g[BM + rl[i]] = s[i];
    }
    cluster_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tot = 0.f;
      for (unsigned r = 0; r < nc; ++r) tot += ld_cluster_f32(red + 4u * (BM + rl[i]), r);
      rstd[i] = rsqrtf(tot / N + eps);
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      const float s0 = ln_scale[col], s1 = ln_scale[col + 1];
      const float c0 = ln_bias[col], c1 = ln_bias[col + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + rl[i];
        if (row < M)
          *reinterpret_cast<unsigned*>(out + (size_t)row * N + col) =
              pack_bf16((acc[4 * n + 2 * i] - mean[i]) * rstd[i] * s0 + c0,
                        (acc[4 * n + 2 * i + 1] - mean[i]) * rstd[i] * s1 + c1);
      }
    }
    cluster_sync();  // no CTA leaves while another may still read its partials
  }
}

// The tensor map of a row-major [rows, cols] bf16 matrix (hopper.cuh's cached maps):
// boxes of 64 columns x box_rows rows; elements past the matrix read as zeros.
inline int matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return tiled_map(map, base, 2, {(cuuint64_t)cols, (cuuint64_t)rows, 1},
                   {(cuuint64_t)cols * sizeof(bf), 0}, box_rows);
}

// One stage: Kernels::get<NWG, BN>(), a kernel that runs mlp_ln_wgmma<NWG, BN, EPI>, on a
// grid (N / BN, M / BM), the grid's x one cluster when EPI is LAYER_NORM.
template <class Kernels, int NWG, int BN, int EPI>
int launch_stage(const CUtensorMap& ta, const CUtensorMap& tb, const void* bias, const void* x,
                 const void* ls, const void* lb, void* out, int M, int N, int K, float eps,
                 cudaStream_t st) {
  using L = Layout<NWG, BN, EPI>;
  const auto kernel = Kernels::template get<NWG, BN>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + L::BM - 1) / L::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = EPI == LAYER_NORM ? grid.x : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, static_cast<const bf*>(bias),
                           static_cast<const bf*>(x), static_cast<const float*>(ls),
                           static_cast<const float*>(lb), static_cast<bf*>(out), M, N, K, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The LAYER_NORM stage at tile rows bm (64 or 128): out = LN((x + a.w) + bias) over [rows,
// H], a [rows, K] by the map ta, w [K, H] by tw, launched as Kernels' kernel
template <class Kernels>
int launch_ln(const CUtensorMap& ta, const CUtensorMap& tw, const void* bias, const void* x,
              const void* ls, const void* lb, void* out, int rows, int H, int K, float eps, int bm,
              cudaStream_t st) {
  if (H == 128)
    return bm == 128 ? launch_stage<Kernels, 2, 128, LAYER_NORM>(ta, tw, bias, x, ls, lb, out,
                                                                 rows, H, K, eps, st)
                     : launch_stage<Kernels, 1, 128, LAYER_NORM>(ta, tw, bias, x, ls, lb, out,
                                                                 rows, H, K, eps, st);
  return bm == 128 ? launch_stage<Kernels, 2, 256, LAYER_NORM>(ta, tw, bias, x, ls, lb, out, rows,
                                                               H, K, eps, st)
                   : launch_stage<Kernels, 1, 256, LAYER_NORM>(ta, tw, bias, x, ls, lb, out, rows,
                                                               H, K, eps, st);
}

}  // namespace wgmma_ln
}  // namespace drt
