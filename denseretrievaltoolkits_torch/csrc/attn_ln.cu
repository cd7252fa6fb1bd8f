// K1: fused attention + output projection + residual + LayerNorm, one kernel.
//
// Replaces the TPU kernel `_attn_block_kernel` (denseretrievaltoolkits_tpu/ops/attn.py:110,
// launched by `_fused_attention_ln_impl`, attn.py:163). Semantics follow
// `_reference_attention_ln` (attn.py:190-202): per head softmax((q.k^T)*scale + bias)
// with fp32 scores and softmax, probs cast to the compute dtype, ctx = probs.v in fp32
// cast to the compute dtype, then ctx.o_kernel accumulated in fp32, + residual x
// + o_bias in fp32, LayerNorm in fp32, cast to the compute dtype.
//
// What bounds it on the H100: the [B,nh,S,S] scores are the bytes the unfused chain
// moves (fp32, 12 heads x S^2 per sequence); this kernel keeps them in shared memory,
// so device memory sees only qkv, x, the o_kernel stream and the output. What is left
// is the o_kernel stream (1.18 MB in bf16, read by every block from L2) and the
// 2*S*H^2 + 4*S^2*H products.
//
// Design: a block owns R=16 query rows of one sequence. LayerNorm needs whole H-wide
// rows, and o_kernel cannot sit in 227 KB of shared memory, so the block loops over
// heads with that head's K/V ([S,hd]) in shared memory, keeps the [R,H] context in
// shared memory, and then streams o_kernel through shared memory while it accumulates
// the projection in fp32. One warp normalises each row.
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

#include "common.cuh"

using namespace drt;

namespace {

constexpr int R = 16;       // query rows per block
constexpr int NT = 256;     // threads per block
constexpr int NCMAX = 4;    // CUDA-core path: output columns per thread, H <= NT * NCMAX
constexpr int KT = 64;      // CUDA-core path: keys per streamed K/V tile
constexpr int OKS = 16;     // tensor-core path: o_kernel rows per staged slice
constexpr size_t SMEM_MAX = 232448;

// ---- tensor-core path (bf16) --------------------------------------------------------

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

// bf16 takes the tensor-core path where its width, alignment and sequence fit (S <= 512
// at bert-base widths), else the CUDA-core path, which takes any S.
extern "C" int drt_attn_ln(const void* qkv, const void* x, const void* mask, const void* ok,
                           const void* ob, const void* ls, const void* lb, void* out, int B,
                           int S, int nh, int hd, float sm_scale, float eps, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch<float>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
  const int code = try_mma(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
  if (code >= 0) return code;
  return launch<__nv_bfloat16>(qkv, x, mask, ok, ob, ls, lb, out, B, S, nh, hd, sm_scale, eps, st);
}

extern "C" const char* drt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
