// K1: fused attention + output projection + residual + LayerNorm.
//
// Replaces the TPU kernel `_attn_block_kernel` (denseretrievaltoolkits_tpu/ops/attn.py:110,
// launched by `_fused_attention_ln_impl`, attn.py:163). Semantics follow
// `_reference_attention_ln` (attn.py:190-202): per head softmax((q.k^T)*scale + bias)
// with fp32 scores and softmax, probs cast to the compute dtype, ctx = probs.v in fp32
// cast to the compute dtype, then ctx.o_kernel accumulated in fp32, + residual x
// + o_bias in fp32, LayerNorm in fp32, cast to the compute dtype.
//
// What bounds it on the H100: the [B,nh,S,S] scores are the bytes the unfused chain
// moves (fp32, 12 heads x S^2 per sequence); every body keeps them on chip, so device
// memory sees qkv, x, o_kernel and the output (77 MB at B=64, S=156: 0.023 ms at 3.35
// TB/s), against 2*S*H^2 + 4*S^2*H products a sequence.
//
// Design, bf16 at hd = 64 or 128, H = 64 * {2,4,8,12,16}, 1 <= S <= 256 (MAX_KEYS) and
// 16-byte aligned qkv, x and o_kernel (the launch plan is `ops/attn.py:attn_ln_plan`):
// two launches, in the Hopper form, with a [rows, H] bf16 scratch for ctx between them
// (writing it and reading it back adds 4 * rows * H bytes, 30.7 MB at B=64, S=156).
//   Stage A, `attn_ln_stage_a`: a CTA of one consumer warpgroup takes one (sequence,
//     head). Its thread 0 brings the head's Q, K and V for the whole sequence by TMA
//     (a 3-D map over qkv [B][S][3H], 64 x 64 boxes, 128-byte swizzle, rows past S
//     zero-filled) into shared memory: at most 3 x 32 KB at hd 64. For each 64-row
//     query tile below S the warpgroup computes the scores of every key at once by wgmma
//     m64n64k16 (Q and K from shared memory, K-major), one n64 product per 64 keys, into
//     fp32 registers (S padded to 64 keys x NKT), then in fp32: the scale, -1e9 where the
//     mask is 0, -inf past S (zero probability; an all-pad sequence averages over its S
//     keys), the row max, exp, the row sum, the division (the IEEE quotient, as the
//     reference divides), and only then the rounding of P to bf16, the reference's order
//     (no online softmax: every key is on chip). ctx =
//     P.V by wgmma with P from registers and V MN-major (F-fwd's RS form), rounded to
//     bf16 into the scratch. Two to four CTAs an SM by shared memory and registers.
//   Stage B, `attn_ln_stage_b`: out = LN((x + ctx.o_kernel) + o_bias), K2's stage-B
//     body (wgmma_ln.cuh) with its depth set to H: tiles of 128 (or 64) rows, o_kernel and
//     ctx by TMA into an mbarrier ring, wgmma, and the LayerNorm of a row block's H
//     columns over a cluster of H / 256 CTAs through distributed shared memory.
// What this does about the limits of the mma.sync body below (0.439 ms at B=64, S=156 on
// an H100; 19x its bound):
//   1. 16 query rows a block, 624 blocks at B=64, S=156: stage A's CTA owns a whole
//      (sequence, head), 64 rows a wgmma tile; stage B 128-row tiles;
//   2. each head's K/V loaded by every 16-row block (about 10 times a sequence): once
//      per (sequence, head), by TMA;
//   3. o_kernel (1.18 MB in bf16) streamed through every 16-row block, 736 MB of L2
//      reads a call: once per 128-row tile of stage B, 92 MB;
//   4. mma.sync fed by 32-bit shared loads and cp.async by every thread: wgmma from
//      shared-memory descriptors and registers, TMA issued by one thread.
//
// Design, bf16 otherwise up to S = 512 at bert-base widths (the S=512 `fused` encode):
// `attn_ln_mma_kernel`, a block owns R=16 query rows of one sequence. LayerNorm needs
// whole H-wide rows, and o_kernel cannot sit in 227 KB of shared memory, so the block
// loops over heads with that head's K/V ([S,hd]) in shared memory, keeps the [R,H]
// context in shared memory, and then streams o_kernel through shared memory while it
// accumulates the projection in fp32. One warp normalises each row.
//
// - bf16 at H = 64 * {2,4,8,12,16} and hd % 16 == 0 (bert-base): tensor cores
//   (mma.sync m16n8k16, fp32 accumulation) for q.k^T, p.v and the projection. S pads
//   to a multiple of 32 with -inf scores (exactly zero probability). o_kernel arrives
//   in double-buffered 16-row slices by 16-byte cp.async, B fragments by ldmatrix,
//   each warp owning H/8 output columns. The slices, and then the fp32 pre-LN rows,
//   reuse the shared memory of the attention phase.
//   A bf16 sequence whose K/V does not fit (S > 512 at bert-base) takes the next path.
// - otherwise (fp32, whose products must stay exact fp32, and odd widths): CUDA-core
//   FFMA, the context held transposed as fp32, each thread accumulating R x (H/256)
//   projection outputs while o_kernel streams from L2. Its attention has two bodies:
//   resident (one head's K/V and the block's [R,S] scores in shared memory, the
//   normalized probabilities rounded before p.v) wherever that fits (fp32 S <= 306 at
//   bert-base), and streamed above it: K/V pass in 64-key tiles with the online softmax,
//   so shared memory does not grow with S and any S is taken. The streamed body rounds
//   exp(s - running max) in bf16, which only shapes the resident body refuses meet.
//
// All-pad sequences (mask all 0) give every score -1e9 + s; max subtraction turns
// that into a uniform softmax, so their outputs stay finite.
#include <algorithm>
#include <cstdint>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_ln.cuh"

using namespace drt;

namespace {

using bf = __nv_bfloat16;

// ---- bf16 on Hopper, stage A: attention into the ctx scratch (wgmma + TMA) -------------

constexpr int MAX_KEYS = 256;  // keys on chip: the whole sequence, S <= 256
constexpr int WG = 128;        // threads of stage A's CTA: one consumer warpgroup

// Shared memory of stage A: Q, K and V of one (sequence, head), each [NKT tiles][CH chunks]
// [64 rows][64 columns] in TMA boxes (CH = HD / 64 chunks of one 128-byte swizzle atom);
// then the keys' additive mask [64 NKT] and two mbarriers (Q and K; V).
template <int HD, int NKT>
struct StageA {
  static constexpr int CH = HD / 64;
  static constexpr uint32_t BOX = 64 * 128;  // one TMA box: 64 rows x 128 B
  static constexpr uint32_t OPERAND = NKT * CH * BOX;
  static constexpr uint32_t BIAS = NKT * 64 * 4;
  static constexpr size_t SMEM = 1024 + 3 * OPERAND + BIAS + 16;  // + alignment
  // CTAs an SM the registers are held to (255 a thread at two, 168 at three, 128 at
  // four); shared memory allows 8 / 4 / 3 / 2 at hd 64 and NKT 1-4
  static constexpr int MIN_CTAS = HD == 128 ? 1 : NKT == 1 ? 4 : NKT == 4 ? 2 : 3;
  static_assert(SMEM <= 232448, "shared memory");
};

template <int HD, int NKT>
__global__ void __launch_bounds__(WG, StageA<HD, NKT>::MIN_CTAS)
attn_ln_stage_a(const __grid_constant__ CUtensorMap tm, const int* __restrict__ mask,
                bf* __restrict__ ctx, int S, int nh, float scale) {
  using L = StageA<HD, NKT>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::OPERAND, v_s = base + 2 * L::OPERAND;
  float* bias = reinterpret_cast<float*>(smem_raw + (base - raw) + 3 * L::OPERAND);
  const uint32_t qk_bar = base + 3 * L::OPERAND + L::BIAS, v_bar = qk_bar + 8;

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, H = nh * HD;
  if (tid == 0) {
    mbar_init(qk_bar, 1);
    mbar_init(v_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // Q and K first, so that the scores start while V arrives
    mbar_expect_tx(qk_bar, 2 * L::OPERAND);
    for (int j = 0; j < NKT; ++j)
      for (int c = 0; c < CH; ++c) {
        const int col = h * HD + 64 * c;
        tma_load_3d(q_s + (j * CH + c) * L::BOX, &tm, col, 64 * j, b, qk_bar);
        tma_load_3d(k_s + (j * CH + c) * L::BOX, &tm, H + col, 64 * j, b, qk_bar);
      }
    mbar_expect_tx(v_bar, L::OPERAND);
    for (int j = 0; j < NKT; ++j)
      for (int c = 0; c < CH; ++c)
        tma_load_3d(v_s + (j * CH + c) * L::BOX, &tm, 2 * H + h * HD + 64 * c, 64 * j, b, v_bar);
  }
  // the reference's additive mask, (1 - mask) * -1e9; keys past S -inf
  const int* mseq = mask + (size_t)b * S;
  for (int j = tid; j < NKT * 64; j += WG)
    bias[j] = j < S ? (1.0f - (float)mseq[j]) * -1e9f : -INFINITY;
  __syncthreads();
  mbar_wait(qk_bar, 0);

  // warp wi owns rows 16 wi + g and 16 wi + g + 8 of each query tile; score d[4n + e] of
  // key chunk c lies at key 64 c + 8 n + 2 t + (e & 1), row g + 8 (e >> 1)
  for (int qt = 0; qt < NKT; ++qt) {  // NKT = ceil(S / 64): every tile holds a row below S
    float s[NKT][32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NKT; ++c)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(s[c], sw128_desc(q_s + (qt * CH + kk / 4) * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(k_s + (c * CH + kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < NKT; ++c) {
      fence_regs(s[c]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // s * scale + bias, rounded twice as the reference rounds it (no FMA)
          float& x = s[c][4 * n + e];
          x = __fadd_rn(__fmul_rn(x, scale), bias[64 * c + 8 * n + 2 * t + (e & 1)]);
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int c = 0; c < NKT; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float& x = s[c][e];
        x = expf(x - mx[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += x;
      }
    float rcp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      rcp[i] = __frcp_rn(sum[i]);
    }
    // P = e / sum rounded as the reference's softmax divides (the IEEE quotient, by one
    // FMA correction of e * RN(1 / sum), far cheaper than div.rn), then rounded to bf16:
    // the A fragments of k16 step kk of chunk c are the n-tiles 2 kk and 2 kk + 1
    auto quotient = [&](float x, int i) {
      const float q = x * rcp[i];
      return fmaf(fmaf(-q, sum[i], x), rcp[i], q);
    };
    unsigned pa[NKT][4][4];
#pragma unroll
    for (int c = 0; c < NKT; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* x = s[c] + 4 * n;
        pa[c][n >> 1][2 * (n & 1)] = pack_bf16(quotient(x[0], 0), quotient(x[1], 0));
        pa[c][n >> 1][2 * (n & 1) + 1] = pack_bf16(quotient(x[2], 1), quotient(x[3], 1));
      }
    if (qt == 0) mbar_wait(v_bar, 0);
    float acc[HD / 2];
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NKT; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(v_s + c * CH * L::BOX + kk * 2048, L::BOX);
        if constexpr (HD == 64)
          wgmma_rs_n64_mn(acc, pa[c][kk], dv);
        else
          wgmma_rs_n128_mn(acc, pa[c][kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 64 * qt + 16 * wi + g + 8 * i;
      if (row >= S) continue;
      bf* dst = ctx + ((size_t)b * S + row) * H + h * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + 8 * n) =
            pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

template <int HD, int NKT>
int launch_stage_a(const CUtensorMap& tm, const int* mask, void* ctx, int B, int S, int nh,
                   float scale, cudaStream_t st) {
  using L = StageA<HD, NKT>;
  cudaError_t err = cudaFuncSetAttribute(attn_ln_stage_a<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  attn_ln_stage_a<HD, NKT><<<dim3(nh, B), WG, L::SMEM, st>>>(tm, mask, static_cast<bf*>(ctx), S,
                                                              nh, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper, stage B: the projection and the LayerNorm (wgmma_ln.cuh) ----------

template <int NWG, int BN>
__global__ void __launch_bounds__(wgmma_ln::Layout<NWG, BN, wgmma_ln::LAYER_NORM>::THREADS,
                                  wgmma_ln::Layout<NWG, BN, wgmma_ln::LAYER_NORM>::CTAS_PER_SM)
attn_ln_stage_b(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                const bf* __restrict__ bias, const bf* __restrict__ x,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                bf* __restrict__ out, int M, int N, int K, float eps) {
  wgmma_ln::mlp_ln_wgmma<NWG, BN, wgmma_ln::LAYER_NORM>(tma, tmb, bias, x, ln_scale, ln_bias,
                                                        out, M, N, K, eps);
}

struct StageB {  // the kernel wgmma_ln::launch_ln takes
  template <int NWG, int BN>
  static auto get() { return &attn_ln_stage_b<NWG, BN>; }
};

// both stages: ctx = attention(qkv) into the [B*S, H] scratch in q_tiles 64-row query tiles
// a CTA, then out = LN((x + ctx.ok) + ob) at stage B's tile rows bm_b (64 or 128), both from
// attn_ln_plan
int launch_wgmma(const void* qkv, const void* x, const void* mask, const void* ok,
                 const void* ob, const void* ls, const void* lb, void* out, void* ctx, int B,
                 int S, int nh, int hd, float sm_scale, float eps, int q_tiles, int bm_b,
                 cudaStream_t st) {
  const int H = nh * hd, w = H / 64;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(ok) | reinterpret_cast<uintptr_t>(ctx);
  if (B < 1 || S < 1 || S > MAX_KEYS || (hd != 64 && hd != 128) || H % 64 != 0 ||
      !(w == 2 || w == 4 || w == 8 || w == 12 || w == 16) || (ptrs & 15) != 0 ||
      q_tiles != (S + 63) / 64 || (bm_b != 64 && bm_b != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;  // qkv as [B][S][3H]: q, k, v at columns 0, H, 2H
  int err = tiled_map(&tm, qkv, 3, {(cuuint64_t)(3 * H), (cuuint64_t)S, (cuuint64_t)B},
                      {(cuuint64_t)(3 * H) * sizeof(bf), (cuuint64_t)S * 3 * H * sizeof(bf)}, 64);
  if (err) return err;
  const int* m = static_cast<const int*>(mask);
  switch ((hd / 64) * 8 + q_tiles) {
#define DRT_CASE(HD, NKT) \
  case (HD / 64) * 8 + NKT: err = launch_stage_a<HD, NKT>(tm, m, ctx, B, S, nh, sm_scale, st); break;
    DRT_CASE(64, 1) DRT_CASE(64, 2) DRT_CASE(64, 3) DRT_CASE(64, 4)
    DRT_CASE(128, 1) DRT_CASE(128, 2) DRT_CASE(128, 3) DRT_CASE(128, 4)
#undef DRT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  CUtensorMap tc, tok;
  if ((err = wgmma_ln::matrix_map(&tc, ctx, B * S, H, bm_b)) ||
      (err = wgmma_ln::matrix_map(&tok, ok, H, H, 64)))
    return err;
  return wgmma_ln::launch_ln<StageB>(tc, tok, ob, x, ls, lb, out, B * S, H, H, eps, bm_b, st);
}

// ---- tensor-core path (bf16, mma.sync) --------------------------------------------------

constexpr int R = 16;       // query rows per block
constexpr int NT = 256;     // threads per block
constexpr int NCMAX = 4;    // CUDA-core path: output columns per thread, H <= NT * NCMAX
constexpr int KT = 64;      // CUDA-core path: keys per streamed K/V tile
constexpr int OKS = 16;     // tensor-core path: o_kernel rows per staged slice
constexpr size_t SMEM_MAX = 232448;

int pad32(int S) { return (S + 31) / 32 * 32; }

// shared memory: the bf16 context [R][H+8], then one region used in turn by the
// attention phase, the o_kernel slices and the fp32 pre-LN rows
size_t mma_smem_bytes(int Sp, int H, int hd) {
  const size_t attn = sizeof(float) * ((size_t)R * (Sp + 4) + Sp) +
                      sizeof(__nv_bfloat16) * (2 * (size_t)Sp * (hd + 8) + (size_t)R * (hd + 8) +
                                               (size_t)R * (Sp + 8));
  const size_t slices = sizeof(__nv_bfloat16) * 2 * (size_t)OKS * (H + 8);
  const size_t rows = sizeof(float) * (size_t)R * (H + 4);
  return sizeof(__nv_bfloat16) * (size_t)R * (H + 8) + std::max(attn, std::max(slices, rows));
}

template <int NTW>
__global__ void __launch_bounds__(NT)
attn_ln_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ mask, const __nv_bfloat16* __restrict__ ok,
                   const __nv_bfloat16* __restrict__ ob, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, __nv_bfloat16* __restrict__ out, int S,
                   int Sp, int nh, int hd, float sm_scale, float eps) {
  using bf = __nv_bfloat16;
  constexpr int H = 64 * NTW;
  constexpr int LDC = H + 8;  // the 16-byte pads keep fragment loads conflict-free
  constexpr int LDY = H + 4;
  const int LDK = hd + 8, LDP = Sp + 8, LDS = Sp + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* ctxb = reinterpret_cast<bf*>(smem);                  // [R][LDC] context
  unsigned char* region = smem + sizeof(bf) * R * LDC;
  float* Ps = reinterpret_cast<float*>(region);            // [R][LDS] scores
  float* bias = Ps + R * LDS;                              // [Sp]
  bf* Ks = reinterpret_cast<bf*>(bias + Sp);               // [Sp][LDK]
  bf* Vs = Ks + Sp * LDK;                                  // [Sp][LDK]
  bf* Qs = Vs + Sp * LDK;                                  // [R][LDK]
  bf* Pb = Qs + R * LDK;                                   // [R][LDP] probs
  bf* oks = reinterpret_cast<bf*>(region);                 // [2][OKS][LDC], after attention
  float* ys = reinterpret_cast<float*>(region);            // [R][LDY], after the projection

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t seq = (size_t)b * S;
  const size_t row3 = 3 * (size_t)H;
  const int hd8 = hd / 8;

  for (int j = tid; j < Sp; j += NT)
    bias[j] = j < S ? (1.0f - (float)mask[seq + j]) * -1e9f : -INFINITY;

  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // the previous head is done with Ks / Vs / Qs / Pb
    for (int idx = tid; idx < Sp * hd8; idx += NT) {
      const int j = idx / hd8, c = (idx - j * hd8) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;  // pad rows: zero, never NaN
      if (j < S) {
        const bf* src = qkv + (seq + j) * row3 + h * hd + c;
        kv = *reinterpret_cast<const uint4*>(src + H);
        vv = *reinterpret_cast<const uint4*>(src + 2 * H);
      }
      *reinterpret_cast<uint4*>(Ks + j * LDK + c) = kv;
      *reinterpret_cast<uint4*>(Vs + j * LDK + c) = vv;
    }
    for (int idx = tid; idx < R * hd8; idx += NT) {
      const int r = idx / hd8, c = (idx - r * hd8) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0);
      if (r0 + r < S) qv = *reinterpret_cast<const uint4*>(qkv + (seq + r0 + r) * row3 + h * hd + c);
      *reinterpret_cast<uint4*>(Qs + r * LDK + c) = qv;
    }
    __syncthreads();
    // scores: warp w takes the n8 column tiles w, w+8, ...
    for (int nt = warp; nt < Sp / 8; nt += NT / 32) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < hd; k0 += 16) {
        const bf* ap = Qs + g * LDK + k0 + 2 * t;
        const unsigned a[4] = {*reinterpret_cast<const unsigned*>(ap),
                               *reinterpret_cast<const unsigned*>(ap + 8 * LDK),
                               *reinterpret_cast<const unsigned*>(ap + 8),
                               *reinterpret_cast<const unsigned*>(ap + 8 * LDK + 8)};
        const bf* bp = Ks + (nt * 8 + g) * LDK + k0 + 2 * t;
        mma_bf16_16x8x16(d, a, *reinterpret_cast<const unsigned*>(bp),
                         *reinterpret_cast<const unsigned*>(bp + 8));
      }
      const int j = nt * 8 + 2 * t;
      Ps[g * LDS + j] = d[0] * sm_scale + bias[j];
      Ps[g * LDS + j + 1] = d[1] * sm_scale + bias[j + 1];
      Ps[(g + 8) * LDS + j] = d[2] * sm_scale + bias[j];
      Ps[(g + 8) * LDS + j + 1] = d[3] * sm_scale + bias[j + 1];
    }
    __syncthreads();
    for (int r = warp; r < R; r += NT / 32) {
      const float* p = Ps + r * LDS;
      float m = -INFINITY;
      for (int j = lane; j < Sp; j += 32) m = fmaxf(m, p[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < Sp; j += 32) sum += expf(p[j] - m);
      const float inv = 1.0f / warp_sum(sum);
      for (int j = lane; j < Sp; j += 32) Pb[r * LDP + j] = __float2bfloat16(expf(p[j] - m) * inv);
    }
    __syncthreads();
    // ctx = p.v: warp w takes the n8 tiles w, w+8, ... of the head's hd columns
    for (int nt = warp; nt < hd8; nt += NT / 32) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < Sp; k0 += 32) {
        unsigned a[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const bf* ap = Pb + g * LDP + k0 + 16 * s + 2 * t;
          a[s][0] = *reinterpret_cast<const unsigned*>(ap);
          a[s][1] = *reinterpret_cast<const unsigned*>(ap + 8 * LDP);
          a[s][2] = *reinterpret_cast<const unsigned*>(ap + 8);
          a[s][3] = *reinterpret_cast<const unsigned*>(ap + 8 * LDP + 8);
        }
        unsigned bv[4];  // rows k0 .. k0+31 of V at this tile's 8 columns
        ldmatrix_x4_trans(bv, Vs + (k0 + lane) * LDK + nt * 8);
        mma_bf16_16x8x16(d, a[0], bv[0], bv[1]);
        mma_bf16_16x8x16(d, a[1], bv[2], bv[3]);
      }
      const int c = h * hd + nt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(ctxb + g * LDC + c) = __floats2bfloat162_rn(d[0], d[1]);
      *reinterpret_cast<__nv_bfloat162*>(ctxb + (g + 8) * LDC + c) = __floats2bfloat162_rn(d[2], d[3]);
    }
  }
  __syncthreads();  // the context is complete; the attention region is free

  // output projection: o_kernel in double-buffered 16-row slices
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  const int col0 = warp * 8 * NTW;
  auto load_slice = [&](int buf, int k0) {
    for (int idx = tid; idx < OKS * H / 8; idx += NT) {
      const int r = idx / (H / 8), c = (idx - r * (H / 8)) * 8;
      cp_async16(oks + (buf * OKS + r) * LDC + c, ok + (size_t)(k0 + r) * H + c);
    }
  };
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  load_slice(0, 0);
  cp_async_commit();
  for (int s = 0; s < H / OKS; ++s) {
    if (s + 1 < H / OKS) load_slice((s + 1) & 1, (s + 1) * OKS);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf* sl = oks + (s & 1) * OKS * LDC;
    const bf* ap = ctxb + g * LDC + s * OKS + 2 * t;
    const unsigned a[4] = {*reinterpret_cast<const unsigned*>(ap),
                           *reinterpret_cast<const unsigned*>(ap + 8 * LDC),
                           *reinterpret_cast<const unsigned*>(ap + 8),
                           *reinterpret_cast<const unsigned*>(ap + 8 * LDC + 8)};
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      unsigned bb[4];
      ldmatrix_x4_trans(bb, sl + lrow * LDC + col0 + j * 8 + lcol);
      mma_bf16_16x8x16(acc[j], a, bb[0], bb[1]);
      mma_bf16_16x8x16(acc[j + 1], a, bb[2], bb[3]);
    }
    __syncthreads();  // this slice's buffer is refilled two steps on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int c = col0 + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half, row = r0 + r;
      if (row < S)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ys[r * LDY + c + e] =
              (to_float(x[(seq + row) * H + c + e]) + acc[j][2 * half + e]) + to_float(ob[c + e]);
    }
  }
  __syncthreads();
  for (int r = warp; r < R; r += NT / 32) {
    const int row = r0 + r;
    if (row < S)
      warp_layer_norm_row<bf>(ys + r * LDY, 1, H, ln_scale, ln_bias, eps, out + (seq + row) * H, lane);
  }
}

template <int NTW>
int launch_mma(const void* qkv, const void* x, const void* mask, const void* ok, const void* ob,
               const void* ls, const void* lb, void* out, int B, int S, int nh, int hd,
               float sm_scale, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int Sp = pad32(S);
  const size_t smem = mma_smem_bytes(Sp, nh * hd, hd);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_ln_mma_kernel<NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + R - 1) / R, B);
  attn_ln_mma_kernel<NTW><<<grid, NT, smem, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(x), static_cast<const int*>(mask),
      static_cast<const bf*>(ok), static_cast<const bf*>(ob), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<bf*>(out), S, Sp, nh, hd, sm_scale, eps);
  return (int)cudaGetLastError();
}

// widths the tensor-core path is instantiated for
bool mma_width(int H, int hd) {
  const int n = H / 64;
  return H % 64 == 0 && hd % 16 == 0 && (n == 2 || n == 4 || n == 8 || n == 12 || n == 16);
}

// the tensor-core path, or -1 when the shape or alignment does not fit it
int try_mma(const void* qkv, const void* x, const void* mask, const void* ok, const void* ob,
            const void* ls, const void* lb, void* out, int B, int S, int nh, int hd,
            float sm_scale, float eps, cudaStream_t stream) {
  const int H = nh * hd;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(ok);
  if (!mma_width(H, hd) || (ptrs & 15) != 0) return -1;  // 16-byte loads
  if (mma_smem_bytes(pad32(S), H, hd) > SMEM_MAX) return -1;  // one head's K/V must fit
  switch (H / 64) {
#define DRT_CASE(n) \
  case n: return launch_mma<n>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, stream);
    DRT_CASE(2) DRT_CASE(4) DRT_CASE(8) DRT_CASE(12) DRT_CASE(16)
#undef DRT_CASE
    default: return -1;
  }
}

// ---- CUDA-core path ------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int k_stride(int hd) {
  // +1 word per K row keeps the per-thread j-strided score reads conflict-free
  return hd + (sizeof(T) == 4 ? 1 : 2);
}

// shared memory of the resident body: one head's K/V and the block's score rows [R][S]
template <typename T>
size_t resident_smem_bytes(int S, int H, int hd) {
  return sizeof(float) * ((size_t)H * R + (size_t)R * S + (size_t)R * hd + S) +
         sizeof(T) * ((size_t)S * k_stride<T>(hd) + (size_t)S * hd);
}

// shared memory of the streamed body: independent of S, K/V pass through in KT-key tiles
template <typename T>
size_t streamed_smem_bytes(int H, int hd) {
  return sizeof(float) * ((size_t)H * R + (size_t)R * KT + (size_t)R * hd + KT + 3 * R) +
         sizeof(T) * ((size_t)KT * k_stride<T>(hd) + (size_t)KT * hd);
}

// Resident body: one head's K/V [S,hd] and the scores [R,S] in shared memory; the
// normalized probabilities are rounded to T before p.v. Writes ctxT [H][R] (as T values).
template <typename T>
__device__ __forceinline__ void attend_resident(const T* __restrict__ qkv,
                                                const int* __restrict__ mask, float* ctxT,
                                                float* scratch, int S, int nh, int hd,
                                                float sm_scale, int r0, size_t seq) {
  const int H = nh * hd;
  const int KST = k_stride<T>(hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row3 = 3 * (size_t)H;
  float* Ps = scratch;                    // [R][S] scores -> probs
  float* Qs = Ps + (size_t)R * S;         // [R][hd]
  float* bias = Qs + (size_t)R * hd;      // [S]
  T* Ks = reinterpret_cast<T*>(bias + S); // [S][KST]
  T* Vs = Ks + (size_t)S * KST;           // [S][hd]

  for (int j = tid; j < S; j += NT) bias[j] = (1.0f - (float)mask[seq + j]) * -1e9f;

  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // previous head's Ps / Ks / Vs readers are done
    for (int idx = tid; idx < S * hd; idx += NT) {
      const int j = idx / hd, d = idx - j * hd;
      const T* src = qkv + (seq + j) * row3 + h * hd + d;
      Ks[j * KST + d] = src[H];
      Vs[j * hd + d] = src[2 * H];
    }
    for (int idx = tid; idx < R * hd; idx += NT) {
      const int r = idx / hd, d = idx - r * hd;
      const int row = r0 + r;
      Qs[idx] = row < S ? to_float(qkv[(seq + row) * row3 + h * hd + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < R * S; idx += NT) {
      const int r = idx / S, j = idx - r * S;
      const float* q = Qs + r * hd;
      const T* k = Ks + j * KST;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(q[d], to_float(k[d]), acc);
      Ps[idx] = acc * sm_scale + bias[j];
    }
    __syncthreads();
    for (int r = warp; r < R; r += NT / 32) {
      float* p = Ps + r * S;
      float m = -INFINITY;
      for (int j = lane; j < S; j += 32) m = fmaxf(m, p[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < S; j += 32) {
        const float e = expf(p[j] - m);
        p[j] = e;
        sum += e;
      }
      const float inv = 1.0f / warp_sum(sum);
      for (int j = lane; j < S; j += 32) p[j] = round_to<T>(p[j] * inv);
    }
    __syncthreads();
    for (int idx = tid; idx < R * hd; idx += NT) {
      const int r = idx / hd, d = idx - r * hd;
      const float* p = Ps + r * S;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(p[j], to_float(Vs[j * hd + d]), acc);
      ctxT[(h * hd + d) * R + r] = round_to<T>(acc);
    }
  }
}

// Streamed body: K/V pass through shared memory in KT-key tiles with the online
// softmax (running max and sum per row, the context rescaled per tile and divided by
// the sum at the head's end, as the flash kernels of csrc/flash_attn.cu do). In bf16
// it rounds exp(s - running max) before p.v, where the resident body rounds the
// normalized probabilities. Writes ctxT [H][R] (as T values).
template <typename T>
__device__ __forceinline__ void attend_streamed(const T* __restrict__ qkv,
                                                const int* __restrict__ mask, float* ctxT,
                                                float* scratch, int S, int nh, int hd,
                                                float sm_scale, int r0, size_t seq) {
  const int H = nh * hd;
  const int KST = k_stride<T>(hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row3 = 3 * (size_t)H;
  float* Ps = scratch;                       // [R][KT] scores -> probs of one key tile
  float* Qs = Ps + (size_t)R * KT;           // [R][hd]
  float* bias = Qs + (size_t)R * hd;         // [KT]
  float* m_s = bias + KT;                    // [R] running max
  float* l_s = m_s + R;                      // [R] running sum
  float* alpha_s = l_s + R;                  // [R] rescale of the context by this tile
  T* Ks = reinterpret_cast<T*>(alpha_s + R); // [KT][KST]
  T* Vs = Ks + (size_t)KT * KST;             // [KT][hd]

  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // the previous head's readers of Qs / m_s / l_s are done
    for (int idx = tid; idx < R * hd; idx += NT) {
      const int r = idx / hd, d = idx - r * hd;
      const int row = r0 + r;
      Qs[idx] = row < S ? to_float(qkv[(seq + row) * row3 + h * hd + d]) : 0.f;
      ctxT[(h * hd + d) * R + r] = 0.f;
    }
    for (int r = tid; r < R; r += NT) {
      m_s[r] = -INFINITY;
      l_s[r] = 0.f;
    }
    for (int j0 = 0; j0 < S; j0 += KT) {
      const int n = min(KT, S - j0);
      __syncthreads();  // the previous tile's readers of Ks / Vs / Ps are done
      for (int idx = tid; idx < n * hd; idx += NT) {
        const int j = idx / hd, d = idx - j * hd;
        const T* src = qkv + (seq + j0 + j) * row3 + h * hd + d;
        Ks[j * KST + d] = src[H];
        Vs[j * hd + d] = src[2 * H];
      }
      for (int j = tid; j < n; j += NT) bias[j] = (1.0f - (float)mask[seq + j0 + j]) * -1e9f;
      __syncthreads();
      for (int idx = tid; idx < R * n; idx += NT) {
        const int r = idx / n, j = idx - r * n;
        const float* q = Qs + r * hd;
        const T* k = Ks + j * KST;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(q[d], to_float(k[d]), acc);
        Ps[r * KT + j] = acc * sm_scale + bias[j];
      }
      __syncthreads();
      // online softmax: every key before S has a finite score, so the max is finite
      for (int r = warp; r < R; r += NT / 32) {
        float* p = Ps + r * KT;
        float mx = -INFINITY;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p[j]);
        const float m_new = fmaxf(m_s[r], warp_max(mx));
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float e = expf(p[j] - m_new);
          p[j] = round_to<T>(e);
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_s[r] - m_new);
          alpha_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < R * hd; idx += NT) {
        const int r = idx / hd, d = idx - r * hd;
        const float* p = Ps + r * KT;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(p[j], to_float(Vs[j * hd + d]), acc);
        float* c = ctxT + (h * hd + d) * R + r;
        *c = *c * alpha_s[r] + acc;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * hd; idx += NT) {
      const int r = idx / hd, d = idx - r * hd;
      float* c = ctxT + (h * hd + d) * R + r;
      *c = round_to<T>(*c / l_s[r]);
    }
  }
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(NT)
attn_ln_kernel(const T* __restrict__ qkv, const T* __restrict__ x, const int* __restrict__ mask,
               const T* __restrict__ ok, const T* __restrict__ ob,
               const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
               T* __restrict__ out, int S, int nh, int hd, float sm_scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = nh * hd;
  float* ctxT = reinterpret_cast<float*>(smem);  // [H][R]: context, then pre-LN rows

  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t seq = (size_t)blockIdx.y * S;

  if constexpr (STREAM)
    attend_streamed<T>(qkv, mask, ctxT, ctxT + (size_t)H * R, S, nh, hd, sm_scale, r0, seq);
  else
    attend_resident<T>(qkv, mask, ctxT, ctxT + (size_t)H * R, S, nh, hd, sm_scale, r0, seq);
  __syncthreads();

  // o-projection: thread owns columns tid + NT*i, all R rows; o_kernel streams from L2
  float acc[NCMAX][R];
#pragma unroll
  for (int i = 0; i < NCMAX; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[i][r] = 0.f;
  for (int k = 0; k < H; ++k) {
    float c[R];
    const float4* src = reinterpret_cast<const float4*>(ctxT + k * R);
#pragma unroll
    for (int v = 0; v < R / 4; ++v) {
      const float4 t = src[v];
      c[4 * v] = t.x; c[4 * v + 1] = t.y; c[4 * v + 2] = t.z; c[4 * v + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < NCMAX; ++i) {
      const int col = tid + NT * i;
      if (col < H) {
        const float w = to_float(ok[(size_t)k * H + col]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[i][r] = fmaf(c[r], w, acc[i][r]);
      }
    }
  }
  __syncthreads();  // every thread is done reading ctxT; reuse it for the pre-LN rows
#pragma unroll
  for (int i = 0; i < NCMAX; ++i) {
    const int col = tid + NT * i;
    if (col < H) {
      const float bo = to_float(ob[col]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r0 + r;
        if (row < S) ctxT[col * R + r] = (to_float(x[(seq + row) * H + col]) + acc[i][r]) + bo;
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < R; r += NT / 32) {
    const int row = r0 + r;
    if (row < S)
      warp_layer_norm_row<T>(ctxT + r, R, H, ln_scale, ln_bias, eps, out + (seq + row) * H, lane);
  }
}

template <typename T, bool STREAM>
int launch_body(const void* qkv, const void* x, const void* mask, const void* ok, const void* ob,
                const void* ls, const void* lb, void* out, int B, int S, int nh, int hd,
                float sm_scale, float eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_ln_kernel<T, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + R - 1) / R, B);
  attn_ln_kernel<T, STREAM><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(x), static_cast<const int*>(mask),
      static_cast<const T*>(ok), static_cast<const T*>(ob), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<T*>(out), S, nh, hd, sm_scale, eps);
  return (int)cudaGetLastError();
}

// the resident body where one head's K/V fits in shared memory, else the streamed one
template <typename T>
int launch(const void* qkv, const void* x, const void* mask, const void* ok, const void* ob,
           const void* ls, const void* lb, void* out, int B, int S, int nh, int hd,
           float sm_scale, float eps, cudaStream_t stream) {
  const int H = nh * hd;
  if (H > NT * NCMAX) return (int)cudaErrorInvalidValue;
  const size_t resident = resident_smem_bytes<T>(S, H, hd);
  if (resident <= SMEM_MAX)
    return launch_body<T, false>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale,
                                 eps, resident, stream);
  const size_t streamed = streamed_smem_bytes<T>(H, hd);
  if (streamed > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return launch_body<T, true>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps,
                              streamed, stream);
}

}  // namespace

// ctx, q_tiles, bm_b: the [B*S, H] bf16 scratch, stage A's 64-row query tiles (ceil(S / 64))
// and stage B's tile rows (64 or 128) of the Hopper body, which the wrapper chooses by shape
// (`ops/attn.py:attn_ln_plan`); q_tiles and bm_b 0 for the other bodies: bf16 takes the
// mma.sync path where its width, alignment and sequence fit (S <= 512 at bert-base
// widths), else the CUDA-core path, which takes any S.
extern "C" int drt_attn_ln(const void* qkv, const void* x, const void* mask, const void* ok,
                           const void* ob, const void* ls, const void* lb, void* out, void* ctx,
                           int B, int S, int nh, int hd, float sm_scale, float eps, int is_bf16,
                           int q_tiles, int bm_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch<float>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
  if (bm_b != 0)
    return launch_wgmma(qkv, x, mask, ok, ob, ls, lb, out, ctx, B, S, nh, hd, sm_scale, eps,
                        q_tiles, bm_b, st);
  const int code = try_mma(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
  if (code >= 0) return code;
  return launch<__nv_bfloat16>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
}

extern "C" const char* drt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
