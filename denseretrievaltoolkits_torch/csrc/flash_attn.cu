// Flash attention: forward, dK/dV and dQ backward kernels; the forward also serves K18.
//
// Replaces three TPU kernels of the stock Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// denseretrievaltoolkits_tpu/models/bert.py:159 (`_flash_attention`) reaches under
// attention='flash':
//   - `_flash_attention_kernel` (:331, called at :758): the forward, which saves the
//     row statistics l and m for the backward;
//   - `_flash_attention_dkv_kernel` (:796, called at :1121 by `_flash_attention_bwd_dkv`);
//   - `_flash_attention_dq_kernel` (:1146, called at :1456 by `_flash_attention_bwd_dq`).
// and K18, `_attn_qkv_kernel` (denseretrievaltoolkits_tpu/ops/attn.py:47, called at :95
// by `_fused_attention_impl`): the same forward with an additive -1e9 bias on pad keys.
//
// Semantics. Scores q.k^T are fp32 and scaled by sm_scale, then masked:
//   - segment mode (the flash path): key j is visible to query i iff mask[i] == mask[j]
//     (the stock kernel's segment ids); every row sees itself, so no row is empty;
//   - bias mode (K18): (1 - mask[j]) * -1e9 is added after the scale, as
//     `_reference_attention` (attn.py:370-384) does.
// Softmax in fp32 with the running max and sum of the stock kernel; the probabilities are
// rounded to the compute dtype before p.v, which accumulates in fp32 (bf16: exp(s - m)
// is rounded before the division by the row sum, as the stock kernel rounds it). The
// forward saves lse = m + log(l) per row, fp32 [B, nh, S]. The backward recomputes
// P = exp(s - lse) and, with D = rowsum(dO * O) computed outside (as flash_attention.py
// :273-275 does), dV = P^T.dO, dP = dO.V^T, dS = P * (dP - D) * sm_scale, dK = dS^T.Q,
// dQ = dS.K; P and dS are rounded to the compute dtype before their products, as there.
//
// Layout. q, k and v are read in place from the [B, S, 3H] QKV projection through
// strides (batch stride, row stride; heads contiguous, hd elements each): none of the
// [B, nh, S, hd] transposes or the 128-row padding the TPU path made. Any S >= 1; rows
// past S are zero in shared memory and masked, never written. O and dO are [B, S, H];
// dq, dk and dv are written through strides into one [B, S, 3H] gradient laid out like
// qkv.
//
// What bounds them on the H100: at bert-base (hd = 64) and S = 512 the forward does
// 4 B nh S^2 hd operations against 2 bytes per element of qkv read and ctx written,
// about 256 operations per byte: near the bf16 ridge (295), so both bounds are close;
// the backward does 2.5x the forward's operations on twice its bytes. The [B, nh, S, S]
// scores, 1.6 GB in fp32 at B = 64, S = 512, never reach device memory.
//
// Design (simple first: mma.sync and cp.async; wgmma and TMA are later work):
//   - bf16, hd % 16 == 0, hd <= 128: four warps, 64 query (or key) rows per block, each
//     warp owning 16 rows; tiles of 64 keys (queries) double-buffered in shared memory by
//     16-byte cp.async. Products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation). Scores stay in registers: the accumulator fragment of s = q.k^T is
//     reused as the A fragment of p.v (FA2's layout identity), and likewise for
//     P^T.dO, dS^T.Q and dS.K. B fragments of row-major [k][n] tiles come by
//     ldmatrix.trans, those of [n][k] tiles by 32-bit loads.
//   - fp32 (products must stay exact fp32; no TF32): 256 threads, the same tiles in
//     shared memory, each thread a 4 x 4 register tile of scores and a 4 x (hd/16)
//     tile of the output; FFMA.
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace drt;

namespace {

using bf = __nv_bfloat16;

constexpr int BM = 64;          // query rows (dK/dV: key rows) per block
constexpr int BN = 64;          // keys (dK/dV: queries) per tile
constexpr int KEY_PAST = INT_MIN;       // segment id of a key past S: never visible
constexpr int QUERY_PAST = INT_MIN + 1;  // segment id of a query past S: sees nothing
constexpr size_t SMEM_MAX = 232448;

// the masked, scaled score of one (query, key) pair
template <bool BIAS>
__device__ __forceinline__ float masked(float s, float scale, int kseg, int qseg) {
  if (kseg == KEY_PAST) return -INFINITY;
  if (BIAS) return s * scale + (1.0f - (float)kseg) * -1e9f;
  return kseg == qseg ? s * scale : -INFINITY;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragments of a 16 x 64 probability-like tile held as accumulator fragments
// c[8][4] (n-tile nt covers columns 8 nt .. 8 nt + 7): k-step kk takes n-tiles 2 kk, 2 kk + 1.
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// A fragments (16 rows x HD) of rows `rows` of a [.][LD] bf16 tile
template <int HD>
__device__ __forceinline__ void load_a(unsigned (&a)[HD / 16][4], const bf* rows, int LD, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf* p = rows + g * LD + kk * 16 + 2 * t;
    a[kk][0] = *reinterpret_cast<const unsigned*>(p);
    a[kk][1] = *reinterpret_cast<const unsigned*>(p + 8 * LD);
    a[kk][2] = *reinterpret_cast<const unsigned*>(p + 8);
    a[kk][3] = *reinterpret_cast<const unsigned*>(p + 8 * LD + 8);
  }
}

// c[8][4] += A (16 x HD, fragments) . T^T, T = the 64 rows of a [64][LD] tile ([n][k])
template <int HD>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const unsigned (&a)[HD / 16][4],
                                        const bf* tile, int LD, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf* p = tile + (nt * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16_16x8x16(c[nt], a[kk], *reinterpret_cast<const unsigned*>(p),
                       *reinterpret_cast<const unsigned*>(p + 8));
    }
}

// acc[HD/8][4] += P (16 x 64, accumulator fragments) . T, T a [64][LD] row-major [k][n] tile
template <int HD>
__device__ __forceinline__ void mma_pt(float (&acc)[HD / 8][4], const float (&p)[8][4],
                                       const bf* tile, int LD, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    c_to_a(a, p, kk);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      unsigned b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + np * 16 +
                               8 * (lane >> 4));
      mma_bf16_16x8x16(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16x8x16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// 64 rows of HD bf16 from global (row r at src + r * stride, rows >= n zero) into a
// [64][LD] tile by 16-byte cp.async; NT threads
template <int HD, int NT>
__device__ __forceinline__ void stage_rows(bf* dst, int LD, const bf* src, size_t stride, int n,
                                           int tid) {
  constexpr int CH = HD / 8;
  for (int idx = tid; idx < 64 * CH; idx += NT) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    if (r < n)
      cp_async16(dst + r * LD + c, src + (size_t)r * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }  // 16-byte pad: conflict-free loads

// ---- bf16 forward --------------------------------------------------------------------

template <int HD>
size_t fwd_mma_smem() {
  return sizeof(bf) * (BM + 4 * BN) * mma_ld<HD>() + sizeof(int) * 2 * BN;
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
              const int* __restrict__ mask, bf* __restrict__ o, float* __restrict__ lse, int S,
              int nh, long long bstride, int rstride, float scale) {
  constexpr int LD = mma_ld<HD>(), NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);   // [BM][LD]
  bf* Ks = Qs + BM * LD;                  // [2][BN][LD]
  bf* Vs = Ks + 2 * BN * LD;              // [2][BN][LD]
  int* kseg = reinterpret_cast<int*>(Vs + 2 * BN * LD);  // [2][BN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * bstride + (size_t)h * HD;
  const size_t seq = (size_t)b * S;

  stage_rows<HD, 128>(Qs, LD, q + head + (size_t)q0 * rstride, rstride, S - q0, tid);
  auto load_kv = [&](int buf, int j0) {
    stage_rows<HD, 128>(Ks + buf * BN * LD, LD, k + head + (size_t)j0 * rstride, rstride, S - j0,
                        tid);
    stage_rows<HD, 128>(Vs + buf * BN * LD, LD, v + head + (size_t)j0 * rstride, rstride, S - j0,
                        tid);
    for (int r = tid; r < BN; r += 128) kseg[buf * BN + r] = j0 + r < S ? mask[seq + j0 + r] : KEY_PAST;
  };
  load_kv(0, 0);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qseg[i] = row[i] < S ? mask[seq + row[i]] : QUERY_PAST;
  unsigned qa[HD / 16][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = (S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) load_a<HD>(qa, Qs + warp * 16 * LD, LD, g, t);
    const bf* Kb = Ks + (j & 1) * BN * LD;
    const bf* Vb = Vs + (j & 1) * BN * LD;
    const int* sk = kseg + (j & 1) * BN;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_abt<HD>(s, qa, Kb, LD, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = sk[n * 8 + 2 * t + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[n][2 * i + e] = masked<BIAS>(s[n][2 * i + e], scale, ks, qseg[i]);
          mx[i] = fmaxf(mx[i], s[n][2 * i + e]);
        }
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      alpha[i] = expf(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * i + e] - mu[i]);
          s[n][2 * i + e] = p;
          l[i] += p;
        }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma_pt<HD>(acc, s, Vb, LD, lane);
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int H = nh * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float inv = 1.0f / l[i];
    bf* dst = o + (seq + row[i]) * H + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0) lse[((size_t)b * nh + h) * S + row[i]] = m[i] + logf(l[i]);
  }
}

// ---- bf16 backward: dQ -----------------------------------------------------------------

template <int HD>
size_t dq_mma_smem() {
  return sizeof(bf) * (2 * BM + 4 * BN) * mma_ld<HD>() + sizeof(int) * 2 * BN;
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_dq_mma(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
             const int* __restrict__ mask, const float* __restrict__ lse,
             const float* __restrict__ Dd, const bf* __restrict__ dout, bf* __restrict__ dq,
             int S, int nh, long long bstride, int rstride, long long gbstride, int grstride,
             float scale) {
  constexpr int LD = mma_ld<HD>(), NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);   // [BM][LD]
  bf* dOs = Qs + BM * LD;                 // [BM][LD]
  bf* Ks = dOs + BM * LD;                 // [2][BN][LD]
  bf* Vs = Ks + 2 * BN * LD;              // [2][BN][LD]
  int* kseg = reinterpret_cast<int*>(Vs + 2 * BN * LD);  // [2][BN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * HD;
  const size_t head = (size_t)b * bstride + (size_t)h * HD;
  const size_t seq = (size_t)b * S;

  stage_rows<HD, 128>(Qs, LD, q + head + (size_t)q0 * rstride, rstride, S - q0, tid);
  stage_rows<HD, 128>(dOs, LD, dout + (seq + q0) * H + h * HD, H, S - q0, tid);
  auto load_kv = [&](int buf, int j0) {
    stage_rows<HD, 128>(Ks + buf * BN * LD, LD, k + head + (size_t)j0 * rstride, rstride, S - j0,
                        tid);
    stage_rows<HD, 128>(Vs + buf * BN * LD, LD, v + head + (size_t)j0 * rstride, rstride, S - j0,
                        tid);
    for (int r = tid; r < BN; r += 128) kseg[buf * BN + r] = j0 + r < S ? mask[seq + j0 + r] : KEY_PAST;
  };
  load_kv(0, 0);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qseg[2];
  float rlse[2], rD[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    qseg[i] = in ? mask[seq + row[i]] : QUERY_PAST;
    rlse[i] = in ? lse[((size_t)b * nh + h) * S + row[i]] : 0.f;
    rD[i] = in ? Dd[((size_t)b * nh + h) * S + row[i]] : 0.f;
  }
  unsigned qa[HD / 16][4], da[HD / 16][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = (S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      load_a<HD>(qa, Qs + warp * 16 * LD, LD, g, t);
      load_a<HD>(da, dOs + warp * 16 * LD, LD, g, t);
    }
    const bf* Kb = Ks + (j & 1) * BN * LD;
    const bf* Vb = Vs + (j & 1) * BN * LD;
    const int* sk = kseg + (j & 1) * BN;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<HD>(s, qa, Kb, LD, g, t);
    mma_abt<HD>(dp, da, Vb, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = sk[n * 8 + 2 * t + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sc = masked<false>(s[n][2 * i + e], scale, ks, qseg[i]);
          const float p = sc == -INFINITY ? 0.f : expf(sc - rlse[i]);
          s[n][2 * i + e] = p * (dp[n][2 * i + e] - rD[i]) * scale;  // dS
        }
      }
    mma_pt<HD>(acc, s, Kb, LD, lane);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf* dst = dq + (size_t)b * gbstride + (size_t)row[i] * grstride + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) = pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---- bf16 backward: dK, dV --------------------------------------------------------------

template <int HD>
size_t dkv_mma_smem() {
  return sizeof(bf) * (2 * BN + 4 * BM) * mma_ld<HD>() + sizeof(int) * 2 * BM +
         sizeof(float) * 4 * BM;
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_dkv_mma(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
              const int* __restrict__ mask, const float* __restrict__ lse,
              const float* __restrict__ Dd, const bf* __restrict__ dout, bf* __restrict__ dk,
              bf* __restrict__ dv, int S, int nh, long long bstride, int rstride,
              long long gbstride, int grstride, float scale) {
  constexpr int LD = mma_ld<HD>(), NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ks = reinterpret_cast<bf*>(smem);   // [BN][LD]
  bf* Vs = Ks + BN * LD;                  // [BN][LD]
  bf* Qs = Vs + BN * LD;                  // [2][BM][LD]
  bf* dOs = Qs + 2 * BM * LD;             // [2][BM][LD]
  int* qsegs = reinterpret_cast<int*>(dOs + 2 * BM * LD);  // [2][BM]
  float* lses = reinterpret_cast<float*>(qsegs + 2 * BM);  // [2][BM]
  float* Ds = lses + 2 * BM;                               // [2][BM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * HD;
  const size_t head = (size_t)b * bstride + (size_t)h * HD;
  const size_t seq = (size_t)b * S;
  const size_t stat = ((size_t)b * nh + h) * S;

  stage_rows<HD, 128>(Ks, LD, k + head + (size_t)k0 * rstride, rstride, S - k0, tid);
  stage_rows<HD, 128>(Vs, LD, v + head + (size_t)k0 * rstride, rstride, S - k0, tid);
  auto load_q = [&](int buf, int i0) {
    stage_rows<HD, 128>(Qs + buf * BM * LD, LD, q + head + (size_t)i0 * rstride, rstride, S - i0,
                        tid);
    stage_rows<HD, 128>(dOs + buf * BM * LD, LD, dout + (seq + i0) * H + h * HD, H, S - i0, tid);
    for (int r = tid; r < BM; r += 128) {
      const bool in = i0 + r < S;
      qsegs[buf * BM + r] = in ? mask[seq + i0 + r] : QUERY_PAST;
      lses[buf * BM + r] = in ? lse[stat + i0 + r] : 0.f;
      Ds[buf * BM + r] = in ? Dd[stat + i0 + r] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();

  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = krow[i] < S ? mask[seq + krow[i]] : KEY_PAST;
  unsigned ka[HD / 16][4], va[HD / 16][4];
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_tiles = (S + BM - 1) / BM;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_q((j + 1) & 1, (j + 1) * BM);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      load_a<HD>(ka, Ks + warp * 16 * LD, LD, g, t);
      load_a<HD>(va, Vs + warp * 16 * LD, LD, g, t);
    }
    const bf* Qb = Qs + (j & 1) * BM * LD;
    const bf* dOb = dOs + (j & 1) * BM * LD;
    const int* sq = qsegs + (j & 1) * BM;
    const float* sl = lses + (j & 1) * BM;
    const float* sd = Ds + (j & 1) * BM;
    float st[8][4], dpt[8][4];  // [16 keys][64 queries]: S^T, then P^T; dP^T, then dS^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    mma_abt<HD>(st, ka, Qb, LD, g, t);
    mma_abt<HD>(dpt, va, dOb, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        const int qs = sq[c];
        const float ql = sl[c], qd = sd[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sc = masked<false>(st[n][2 * i + e], scale, kseg[i], qs);
          const float p = sc == -INFINITY ? 0.f : expf(sc - ql);
          st[n][2 * i + e] = p;
          dpt[n][2 * i + e] = p * (dpt[n][2 * i + e] - qd) * scale;
        }
      }
    mma_pt<HD>(dva, st, dOb, LD, lane);
    mma_pt<HD>(dka, dpt, Qb, LD, lane);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= S) continue;
    const size_t off = (size_t)b * gbstride + (size_t)krow[i] * grstride + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<unsigned*>(dk + off + n * 8) = pack_bf16(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<unsigned*>(dv + off + n * 8) = pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- fp32 (CUDA cores) ------------------------------------------------------------------
//
// 256 threads as a 16 x 16 grid (tr, tc): a thread owns rows 4 tr .. 4 tr + 3 of every
// 64-row tile product, columns tc + 16 c of the 64-wide score tiles (c < 4) and of the
// hd-wide outputs (c < 8, hd <= 128). Tiles are [64][hd + 1] in shared memory: the odd
// stride keeps a warp's 16 column reads on distinct banks.

constexpr int FT = 256;
constexpr int LDP = 65;  // score tiles [64][65]

__host__ __device__ constexpr int f32_ld(int hd) { return hd + 1; }

// 64 rows of hd floats (row r at src + r * stride, rows >= n zero) into a [64][ld] tile
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, size_t stride,
                                          int n, int hd, int tid) {
  for (int idx = tid; idx < 64 * hd; idx += FT) {
    const int r = idx / hd, c = idx - r * hd;
    dst[r * ld + c] = r < n ? src[(size_t)r * stride + c] : 0.f;
  }
}

// s[a][c] = sum_d A[4 tr + a][d] * B[tc + 16 c][d] over [64][ld] tiles
__device__ __forceinline__ void tile_abt(float (&s)[4][4], const float* A, const float* B, int ld,
                                         int hd, int tr, int tc) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(4 * tr + a) * ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = B[(tc + 16 * c) * ld + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(x[a], y[c], s[a][c]);
  }
}

// acc[a][c] += sum_j P[4 tr + a][j] * B[j][tc + 16 c], P a [64][LDP] tile, B [64][ld]
__device__ __forceinline__ void tile_pb(float (&acc)[4][8], const float* P, const float* B, int ld,
                                        int hd, int tr, int tc) {
  for (int j = 0; j < 64; ++j) {
    float x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = P[(4 * tr + a) * LDP + j];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tc + 16 * c;
      if (col < hd) {
        const float y = B[j * ld + col];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(x[a], y, acc[a][c]);
      }
    }
  }
}

size_t fwd_f32_smem(int hd) {
  return sizeof(float) * (3 * (size_t)64 * f32_ld(hd) + 64 * LDP + 2 * 64) + sizeof(int) * 128;
}

template <bool BIAS>
__global__ void __launch_bounds__(FT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ mask, float* __restrict__ o,
              float* __restrict__ lse, int S, int nh, int hd, long long bstride, int rstride,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(hd);
  float* Qs = reinterpret_cast<float*>(smem);  // [64][ld]
  float* Ks = Qs + 64 * ld;                    // [64][ld]
  float* Vs = Ks + 64 * ld;                    // [64][ld]
  float* Ps = Vs + 64 * ld;                    // [64][LDP]
  float* alpha_s = Ps + 64 * LDP;              // [64]
  float* l_s = alpha_s + 64;                   // [64]
  int* kseg = reinterpret_cast<int*>(l_s + 64);  // [64]
  int* qseg = kseg + 64;                         // [64]
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int sr = tid >> 2, sq = tid & 3;  // softmax: row sr, keys 16 sq .. 16 sq + 15
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * bstride + (size_t)h * hd;
  const size_t seq = (size_t)b * S;

  stage_f32(Qs, ld, q + head + (size_t)q0 * rstride, rstride, S - q0, hd, tid);
  for (int r = tid; r < 64; r += FT) qseg[r] = q0 + r < S ? mask[seq + q0 + r] : QUERY_PAST;
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  float m = -INFINITY, l = 0.f;  // row sr's running max and sum (same in its 4 threads)

  for (int j0 = 0; j0 < S; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    stage_f32(Ks, ld, k + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
    stage_f32(Vs, ld, v + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
    for (int r = tid; r < 64; r += FT) kseg[r] = j0 + r < S ? mask[seq + j0 + r] : KEY_PAST;
    __syncthreads();
    float s[4][4];
    tile_abt(s, Qs, Ks, ld, hd, tr, tc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(4 * tr + a) * LDP + tc + 16 * c] =
            masked<BIAS>(s[a][c], scale, kseg[tc + 16 * c], qseg[4 * tr + a]);
    __syncthreads();
    float* pr = Ps + sr * LDP + 16 * sq;
    float mx = -INFINITY;
    for (int u = 0; u < 16; ++u) mx = fmaxf(mx, pr[u]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - mu);
    float sum = 0.f;
    for (int u = 0; u < 16; ++u) {
      const float p = expf(pr[u] - mu);
      pr[u] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m = m_new;
    l = l * alpha + sum;
    if (sq == 0) alpha_s[sr] = alpha;
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = alpha_s[4 * tr + a];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] *= al;
    }
    tile_pb(acc, Ps, Vs, ld, hd, tr, tc);
  }
  if (sq == 0) {
    l_s[sr] = l;
    if (lse != nullptr && q0 + sr < S) lse[((size_t)b * nh + h) * S + q0 + sr] = m + logf(l);
  }
  __syncthreads();
  const int H = nh * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * tr + a;
    if (q0 + r >= S) continue;
    const float inv = 1.0f / l_s[r];
    float* dst = o + (seq + q0 + r) * H + h * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (tc + 16 * c < hd) dst[tc + 16 * c] = acc[a][c] * inv;
  }
}

size_t dq_f32_smem(int hd) {
  return sizeof(float) * (4 * (size_t)64 * f32_ld(hd) + 64 * LDP + 2 * 64) + sizeof(int) * 128;
}

__global__ void __launch_bounds__(FT)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ mask,
             const float* __restrict__ lse, const float* __restrict__ Dd,
             const float* __restrict__ dout, float* __restrict__ dq, int S, int nh, int hd,
             long long bstride, int rstride, long long gbstride, int grstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(hd);
  float* Qs = reinterpret_cast<float*>(smem);  // [64][ld]
  float* dOs = Qs + 64 * ld;
  float* Ks = dOs + 64 * ld;
  float* Vs = Ks + 64 * ld;
  float* dS = Vs + 64 * ld;       // [64][LDP]
  float* lses = dS + 64 * LDP;    // [64]
  float* Ds = lses + 64;          // [64]
  int* kseg = reinterpret_cast<int*>(Ds + 64);
  int* qseg = kseg + 64;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * hd;
  const size_t head = (size_t)b * bstride + (size_t)h * hd;
  const size_t seq = (size_t)b * S;
  const size_t stat = ((size_t)b * nh + h) * S;

  stage_f32(Qs, ld, q + head + (size_t)q0 * rstride, rstride, S - q0, hd, tid);
  stage_f32(dOs, ld, dout + (seq + q0) * H + h * hd, H, S - q0, hd, tid);
  for (int r = tid; r < 64; r += FT) {
    const bool in = q0 + r < S;
    qseg[r] = in ? mask[seq + q0 + r] : QUERY_PAST;
    lses[r] = in ? lse[stat + q0 + r] : 0.f;
    Ds[r] = in ? Dd[stat + q0 + r] : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int j0 = 0; j0 < S; j0 += BN) {
    __syncthreads();
    stage_f32(Ks, ld, k + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
    stage_f32(Vs, ld, v + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
    for (int r = tid; r < 64; r += FT) kseg[r] = j0 + r < S ? mask[seq + j0 + r] : KEY_PAST;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt(s, Qs, Ks, ld, hd, tr, tc);
    tile_abt(dp, dOs, Vs, ld, hd, tr, tc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * tr + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float sc = masked<false>(s[a][c], scale, kseg[tc + 16 * c], qseg[r]);
        const float p = sc == -INFINITY ? 0.f : expf(sc - lses[r]);
        dS[r * LDP + tc + 16 * c] = p * (dp[a][c] - Ds[r]) * scale;
      }
    }
    __syncthreads();
    tile_pb(acc, dS, Ks, ld, hd, tr, tc);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * tr + a;
    if (q0 + r >= S) continue;
    float* dst = dq + (size_t)b * gbstride + (size_t)(q0 + r) * grstride + h * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (tc + 16 * c < hd) dst[tc + 16 * c] = acc[a][c];
  }
}

size_t dkv_f32_smem(int hd) {
  return sizeof(float) * (4 * (size_t)64 * f32_ld(hd) + 2 * 64 * LDP + 2 * 64) +
         sizeof(int) * 128;
}

__global__ void __launch_bounds__(FT)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ mask,
              const float* __restrict__ lse, const float* __restrict__ Dd,
              const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
              int S, int nh, int hd, long long bstride, int rstride, long long gbstride,
              int grstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(hd);
  float* Ks = reinterpret_cast<float*>(smem);  // [64][ld]
  float* Vs = Ks + 64 * ld;
  float* Qs = Vs + 64 * ld;
  float* dOs = Qs + 64 * ld;
  float* PT = dOs + 64 * ld;     // [64 keys][LDP]
  float* dST = PT + 64 * LDP;    // [64 keys][LDP]
  float* lses = dST + 64 * LDP;  // [64]
  float* Ds = lses + 64;
  int* kseg = reinterpret_cast<int*>(Ds + 64);
  int* qseg = kseg + 64;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int H = nh * hd;
  const size_t head = (size_t)b * bstride + (size_t)h * hd;
  const size_t seq = (size_t)b * S;
  const size_t stat = ((size_t)b * nh + h) * S;

  stage_f32(Ks, ld, k + head + (size_t)k0 * rstride, rstride, S - k0, hd, tid);
  stage_f32(Vs, ld, v + head + (size_t)k0 * rstride, rstride, S - k0, hd, tid);
  for (int r = tid; r < 64; r += FT) kseg[r] = k0 + r < S ? mask[seq + k0 + r] : KEY_PAST;
  float dka[4][8], dva[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int i0 = 0; i0 < S; i0 += BM) {
    __syncthreads();
    stage_f32(Qs, ld, q + head + (size_t)i0 * rstride, rstride, S - i0, hd, tid);
    stage_f32(dOs, ld, dout + (seq + i0) * H + h * hd, H, S - i0, hd, tid);
    for (int r = tid; r < 64; r += FT) {
      const bool in = i0 + r < S;
      qseg[r] = in ? mask[seq + i0 + r] : QUERY_PAST;
      lses[r] = in ? lse[stat + i0 + r] : 0.f;
      Ds[r] = in ? Dd[stat + i0 + r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // rows: keys 4 tr + a; columns: queries tc + 16 c
    tile_abt(st, Ks, Qs, ld, hd, tr, tc);
    tile_abt(dpt, Vs, dOs, ld, hd, tr, tc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kr = 4 * tr + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tc + 16 * c;
        const float sc = masked<false>(st[a][c], scale, kseg[kr], qseg[qc]);
        const float p = sc == -INFINITY ? 0.f : expf(sc - lses[qc]);
        PT[kr * LDP + qc] = p;
        dST[kr * LDP + qc] = p * (dpt[a][c] - Ds[qc]) * scale;
      }
    }
    __syncthreads();
    tile_pb(dva, PT, dOs, ld, hd, tr, tc);
    tile_pb(dka, dST, Qs, ld, hd, tr, tc);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * tr + a;
    if (k0 + r >= S) continue;
    const size_t off = (size_t)b * gbstride + (size_t)(k0 + r) * grstride + h * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (tc + 16 * c < hd) {
        dk[off + tc + 16 * c] = dka[a][c];
        dv[off + tc + 16 * c] = dva[a][c];
      }
  }
}

// ---- launchers ------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_of(int B, int S, int nh) { return dim3((S + 63) / 64, nh, B); }

template <int HD>
int fwd_mma(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
            int B, int S, int nh, long long bs, int rs, float scale, int bias,
            cudaStream_t st) {
  const size_t smem = fwd_mma_smem<HD>();
  auto kernel = bias ? flash_fwd_mma<HD, true> : flash_fwd_mma<HD, false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid_of(B, S, nh), 128, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask,
      static_cast<bf*>(o), lse, S, nh, bs, rs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int dq_mma(const void* q, const void* k, const void* v, const int* mask, const float* lse,
           const float* D, const void* dout, void* dq, int B, int S, int nh, long long bs, int rs,
           long long gbs, int grs, float scale, cudaStream_t st) {
  const size_t smem = dq_mma_smem<HD>();
  int err = set_smem(flash_dq_mma<HD>, smem);
  if (err) return err;
  flash_dq_mma<HD><<<grid_of(B, S, nh), 128, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask, lse,
      D, static_cast<const bf*>(dout), static_cast<bf*>(dq), S, nh, bs, rs, gbs, grs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_mma(const void* q, const void* k, const void* v, const int* mask, const float* lse,
            const float* D, const void* dout, void* dk, void* dv, int B, int S, int nh,
            long long bs, int rs, long long gbs, int grs, float scale, cudaStream_t st) {
  const size_t smem = dkv_mma_smem<HD>();
  int err = set_smem(flash_dkv_mma<HD>, smem);
  if (err) return err;
  flash_dkv_mma<HD><<<grid_of(B, S, nh), 128, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask, lse,
      D, static_cast<const bf*>(dout), static_cast<bf*>(dk), static_cast<bf*>(dv), S, nh, bs, rs,
      gbs, grs, scale);
  return (int)cudaGetLastError();
}

// what the kernels take: bf16 hd % 16 == 0 with 16-byte aligned rows, fp32 hd % 8 == 0
bool shape_ok(int B, int S, int nh, int hd, int is_bf16) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || nh > 65535 || hd < 8 || hd > 128) return false;
  return is_bf16 ? hd % 16 == 0 : hd % 8 == 0;
}

#define DRT_HD_SWITCH(CALL)                                                        \
  switch (hd) {                                                                    \
    case 16: return CALL(16);                                                      \
    case 32: return CALL(32);                                                      \
    case 48: return CALL(48);                                                      \
    case 64: return CALL(64);                                                      \
    case 80: return CALL(80);                                                      \
    case 96: return CALL(96);                                                      \
    case 112: return CALL(112);                                                    \
    case 128: return CALL(128);                                                    \
    default: return (int)cudaErrorInvalidValue;                                    \
  }

}  // namespace

// q, k, v: the head-0 element of row 0 of sequence 0, rows `rstride` and sequences
// `bstride` elements apart, heads hd apart; mask [B, S] int32; o [B, S, nh * hd];
// lse [B, nh, S] fp32 or null. bias = 1: K18's additive pad-key bias, else segments.
extern "C" int drt_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int S, int nh, int hd, long long bstride,
                             int rstride, float scale, int bias, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, nh, hd, is_bf16)) return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
#define DRT_CALL(HD) fwd_mma<HD>(q, k, v, m, o, l, B, S, nh, bstride, rstride, scale, bias, st)
    DRT_HD_SWITCH(DRT_CALL)
#undef DRT_CALL
  }
  const size_t smem = fwd_f32_smem(hd);
  auto kernel = bias ? flash_fwd_f32<true> : flash_fwd_f32<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid_of(B, S, nh), FT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), m,
      static_cast<float*>(o), l, S, nh, hd, bstride, rstride, scale);
  return (int)cudaGetLastError();
}

// dout [B, S, nh * hd] contiguous; lse, D [B, nh, S] fp32; dq rows `grstride` and
// sequences `gbstride` elements apart (the [B, S, 3H] gradient)
extern "C" int drt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* lse, const void* D, const void* dout, void* dq,
                                int B, int S, int nh, int hd, long long bstride, int rstride,
                                long long gbstride, int grstride, float scale, int is_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, nh, hd, is_bf16)) return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
  if (is_bf16) {
#define DRT_CALL(HD) \
  dq_mma<HD>(q, k, v, m, l, d, dout, dq, B, S, nh, bstride, rstride, gbstride, grstride, scale, st)
    DRT_HD_SWITCH(DRT_CALL)
#undef DRT_CALL
  }
  const size_t smem = dq_f32_smem(hd);
  int err = set_smem(flash_dq_f32, smem);
  if (err) return err;
  flash_dq_f32<<<grid_of(B, S, nh), FT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), m,
      l, d, static_cast<const float*>(dout), static_cast<float*>(dq), S, nh, hd, bstride, rstride,
      gbstride, grstride, scale);
  return (int)cudaGetLastError();
}

extern "C" int drt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                 const void* lse, const void* D, const void* dout, void* dk,
                                 void* dv, int B, int S, int nh, int hd, long long bstride,
                                 int rstride, long long gbstride, int grstride, float scale,
                                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, nh, hd, is_bf16)) return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
  if (is_bf16) {
#define DRT_CALL(HD)                                                                    \
  dkv_mma<HD>(q, k, v, m, l, d, dout, dk, dv, B, S, nh, bstride, rstride, gbstride, grstride, \
              scale, st)
    DRT_HD_SWITCH(DRT_CALL)
#undef DRT_CALL
  }
  const size_t smem = dkv_f32_smem(hd);
  int err = set_smem(flash_dkv_f32, smem);
  if (err) return err;
  flash_dkv_f32<<<grid_of(B, S, nh), FT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), m,
      l, d, static_cast<const float*>(dout), static_cast<float*>(dk), static_cast<float*>(dv), S,
      nh, hd, bstride, rstride, gbstride, grstride, scale);
  return (int)cudaGetLastError();
}
