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
// P = exp(s - lse) and, with D = rowsum(dO * O), dV = P^T.dO, dP = dO.V^T,
// dS = P * (dP - D) * sm_scale, dK = dS^T.Q, dQ = dS.K; P and dS are rounded to the
// compute dtype before their products, as there. The dQ kernel, launched first, computes
// D for its rows (the stock VJP computes it outside its kernels, flash_attention.py
// :273-275) and writes it for the dK/dV kernel.
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
// Design of the forward (which body a launch takes depends on dtype and hd alone):
//   - bf16, hd = 64 or 128: the Hopper body `flash_fwd_wgmma` (its note below): 128
//     query rows per CTA as two consumer warpgroups and a producer warp; K / V tiles by
//     TMA into a ring of mbarrier-guarded stages; S = Q.K^T and O += P.V by wgmma;
//     fully masked (query tile, key tile) pairs skipped. The TMA tensor maps are encoded
//     on the host (`cuTensorMapEncodeTiled`, reached through the runtime's
//     `cudaGetDriverEntryPoint[ByVersion]`, so the library links no libcuda) and passed
//     as `__grid_constant__` parameters; the last few are cached.
//   - bf16, other hd (multiples of 16 up to 112): `flash_fwd_mma`, four warps on
//     mma.sync m16n8k16, 64 query rows per block, 64-key tiles double-buffered by
//     cp.async; the scores' accumulator fragments are reused as the A fragments of P.V
//     (FA2's layout identity).
//   - fp32 (products stay exact fp32, no TF32): `flash_fwd_f32`, FFMA on 4 x 8 register
//     tiles of scores with the same tile skipping (its note below).
// Design of the backward (which body a launch takes depends on dtype and hd alone, as
// for the forward):
//   - bf16, hd = 64 or 128: `flash_dq_wgmma` and `flash_dkv_wgmma` (their note below),
//     the forward's shape: 128 rows per CTA as two consumer warpgroups and a producer
//     warp (dK/dV at hd 128: 64 rows, one warpgroup), the streamed operands by TMA into
//     mbarrier stages, the four (dK/dV) or three (dQ) tile products by wgmma, fully
//     masked tile pairs skipped;
//   - bf16, other hd: `flash_dq_mma` / `flash_dkv_mma` on mma.sync and cp.async, the
//     accumulator fragments reused for P^T.dO, dS^T.Q and dS.K, B fragments of row-major
//     [k][n] tiles by ldmatrix.trans, of [n][k] tiles by 32-bit loads;
//   - fp32: 256 threads, a 4 x 4 register tile of scores and a 4 x (hd/16) tile of the
//     output each.
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 forward on mma.sync (head dims other than 64 and 128) ----------------------

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

// ---- tile summaries: which (query tile, key tile) pairs can see each other ---------------
//
// A tile's summary ORs one bit per row (rows < S): SEG_ZERO for mask 0, SEG_ONE for 1,
// SEG_OTHER for any other value, and SEG_PAST for a row past S. One warp ballot per 64
// rows. The rule (`ops/flash.py:_visible_tiles` is its plain version):
//   - segment mode: the tiles' value sets intersect (two SEG_OTHER tiles count as
//     intersecting: never skipped, exact on the 0/1 masks the model passes);
//   - bias mode: the key tile has a key of mask != 0, or the sequence has no key of mask 1.
//     A skipped tile's keys are all 0 (bias -1e9) and the row sees a key of bias 0, so
//     each skipped score contributes exp(-1e9 - m) = 0 exactly in fp32.
// A skipped score is exactly 0 in the unskipped kernel too, so skipping changes no bit.

constexpr unsigned SEG_ZERO = 1, SEG_ONE = 2, SEG_OTHER = 4, SEG_PAST = 8;
constexpr unsigned SEG_VALUES = SEG_ZERO | SEG_ONE | SEG_OTHER;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the SFU (flush to zero: a probability below 2^-126 becomes 0, invisible next
// to a row sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned seg_bit(int v) {
  return v == 0 ? SEG_ZERO : v == 1 ? SEG_ONE : SEG_OTHER;
}

// the mask of rows r0 + lane and r0 + 32 + lane (KEY_PAST past S), for tile_summary
__device__ __forceinline__ int2 tile_mask(const int* __restrict__ mseq, int r0, int S, int lane) {
  const int a = r0 + lane, c = a + 32;
  return make_int2(a < S ? __ldg(mseq + a) : KEY_PAST, c < S ? __ldg(mseq + c) : KEY_PAST);
}

// summary of the 64 rows whose mask tile_mask read, by one whole warp
__device__ __forceinline__ unsigned tile_summary(int2 v) {
  const unsigned bits = (v.x == KEY_PAST ? SEG_PAST : seg_bit(v.x)) |
                        (v.y == KEY_PAST ? SEG_PAST : seg_bit(v.y));
  return __reduce_or_sync(0xffffffffu, bits);
}

__device__ __forceinline__ unsigned tile_summary(const int* __restrict__ mseq, int r0, int S,
                                                 int lane) {
  return tile_summary(tile_mask(mseq, r0, S, lane));
}

// whether the sequence has a key of mask 1 (bias mode), by one whole warp
__device__ __forceinline__ bool has_one_key(const int* __restrict__ mseq, int S, int lane) {
  bool one = false;
#pragma unroll 4
  for (int r = lane; r < S; r += 32) one |= __ldg(mseq + r) == 1;  // independent loads
  return __any_sync(0xffffffffu, one);
}

template <bool BIAS>
__device__ __forceinline__ bool tile_visible(unsigned qs, unsigned ks, bool has_one) {
  if (!(qs & SEG_VALUES)) return false;  // no query row below S
  return BIAS ? (ks & (SEG_ONE | SEG_OTHER)) != 0 || !has_one : (qs & ks & SEG_VALUES) != 0;
}

// ---- bf16 forward on Hopper: wgmma + TMA (hd = 64 and 128) ------------------------------
//
// One CTA: 128 query rows of one (sequence, head), as two consumer warpgroups of 64 rows,
// and one producer warp. The producer walks the key tiles, skips those no row of the CTA
// can see, and brings each other K / V tile by TMA (128-byte swizzle, 64-column boxes of
// a 3-D tensor map over [B][S][H]: rows past S arrive as zeros) into a ring of NST
// stages, completing on a `full` mbarrier; it writes the tile's index, summary and key
// mask beside it. Each consumer warpgroup computes S = Q.K^T by wgmma (Q and K in shared
// memory, K-major), skips a tile its own 64 rows cannot see, masks score by score only
// where a row or key of the pair of tiles is not of the one shared segment, runs the
// online softmax in base 2 on prescaled scores (quad shuffles per row), rounds P to bf16
// in registers (the accumulator layout of S is the A-fragment layout of the next
// product) and adds P.V by wgmma with V in shared memory, MN-major. Then it releases
// the stage on its `empty` mbarrier. lse is stored in natural log.

constexpr int WG_ROWS = 128;     // query rows per CTA
constexpr int WG_THREADS = 288;  // two consumer warpgroups and one producer warp
constexpr int PRODUCER_WARP = 8;

// Shared memory of the wgmma forward: Q [CH][128 rows][64], then NST stages of K and V
// ([CH][64 rows][64] each; CH = HD / 64 chunks of 64 columns, one 128-byte swizzle atom
// wide), then per stage {tile, summary, mask of its 64 keys}, then the barriers.
template <int HD>
struct WgLayout {
  static constexpr int CH = HD / 64;
  static constexpr int NST = HD == 64 ? 3 : 2;
  static constexpr uint32_t BOX = 64 * 128;          // one TMA box: 64 rows x 128 B
  static constexpr uint32_t Q_BYTES = 2 * CH * BOX;  // 128 rows
  static constexpr uint32_t KV_BYTES = CH * BOX;     // K (or V) of one stage
  static constexpr uint32_t STAGE = 2 * KV_BYTES;
  static constexpr uint32_t META = NST * (2 + BN) * 4;
  static constexpr uint32_t BARS = (2 * NST + 1) * 8;
  static constexpr size_t SMEM = 1024 + Q_BYTES + NST * STAGE + META + BARS;  // + alignment
};

template <int HD, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS, HD == 64 ? 2 : 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const int* __restrict__ mask,
                bf* __restrict__ o, float* __restrict__ lse, int S, int nh, float scale) {
  using L = WgLayout<HD>;
  constexpr int CH = L::CH, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t q_s = base, kv_s = base + L::Q_BYTES;
  int* meta = reinterpret_cast<int*>(gbase + L::Q_BYTES + NST * L::STAGE);  // [NST][2 + BN]
  const uint32_t bars = kv_s + NST * L::STAGE + L::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };
  const uint32_t qbar = bars + 16u * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * WG_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int* mseq = mask + (size_t)b * S;
  const int n_tiles = (S + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    const int2 mq0 = tile_mask(mseq, q0, S, lane), mq1 = tile_mask(mseq, q0 + 64, S, lane);
    int2 mk = tile_mask(mseq, 0, S, lane);  // the next key tile's mask, read ahead
    if (lane == 0) {  // Q first: it needs no summary
      const int q_boxes = q0 + 64 < S ? 2 : 1;  // a second box only where rows remain
      mbar_expect_tx(qbar, q_boxes * CH * L::BOX);
      for (int half = 0; half < q_boxes; ++half)
        for (int c = 0; c < CH; ++c)
          tma_load_3d(q_s + (c * 2 + half) * L::BOX, &tmq, h * HD + c * 64, q0 + 64 * half, b,
                      qbar);
    }
    const unsigned qs0 = tile_summary(mq0), qs1 = tile_summary(mq1);
    const bool has_one = BIAS ? has_one_key(mseq, S, lane) : true;
    int stage = 0;
    unsigned phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int2 cur = mk;
      const unsigned ks = tile_summary(cur);
      if (j + 1 < n_tiles) mk = tile_mask(mseq, (j + 1) * BN, S, lane);
      if (!tile_visible<BIAS>(qs0, ks, has_one) && !tile_visible<BIAS>(qs1, ks, has_one)) continue;
      mbar_wait(empty(stage), phase ^ 1);
      int* m = meta + stage * (2 + BN);
      m[2 + lane] = cur.x;
      m[2 + 32 + lane] = cur.y;
      if (lane == 0) {
        m[0] = j;
        m[1] = (int)ks;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t ks_s = kv_s + stage * L::STAGE, vs_s = ks_s + L::KV_BYTES;
        mbar_expect_tx(full(stage), L::STAGE);
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(ks_s + c * L::BOX, &tmk, h * HD + c * 64, j * BN, b, full(stage));
          tma_load_3d(vs_s + c * L::BOX, &tmv, h * HD + c * 64, j * BN, b, full(stage));
        }
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty(stage), phase ^ 1);
    if (lane == 0) {
      meta[stage * (2 + BN)] = -1;  // the end of the tiles
      mbar_arrive(full(stage));
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; its warp wi rows 16 wi .. + 15
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const unsigned qs = tile_summary(mseq, r0, S, lane);
  const int row[2] = {r0 + wi * 16 + g, r0 + wi * 16 + g + 8};
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qseg[i] = row[i] < S ? mseq[row[i]] : QUERY_PAST;
  const float scale2 = scale * LOG2E;
  const int H = nh * HD;
  float acc[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa_s = q_s + wg * L::BOX;  // rows 64 wg .. of each 128-row Q chunk
  bool q_ready = false;
  int stage = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(full(stage), phase);
    const int* mt = meta + stage * (2 + BN);
    const int j = mt[0];
    const unsigned ks = (unsigned)mt[1];
    if (j >= 0 && (BIAS ? (qs & SEG_VALUES) != 0 : (qs & ks & SEG_VALUES) != 0)) {
      if (!q_ready) {
        mbar_wait(qbar, 0);
        q_ready = true;
      }
      const uint32_t ks_s = kv_s + stage * L::STAGE, vs_s = ks_s + L::KV_BYTES;
      float s[32];
#pragma unroll
      for (int n = 0; n < 32; ++n) s[n] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(s, sw128_desc(qa_s + (kk / 4) * 2 * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(ks_s + (kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      // every pair visible and unbiased: the raw scores, the scale folded into the
      // exponent's FFMA (c); else the masked, biased, scaled scores (c = 1)
      const bool dense = BIAS ? ks == SEG_ONE : qs == ks && (ks == SEG_ZERO || ks == SEG_ONE);
      const float c = dense ? scale2 : 1.f;
      if (!dense) {
        const int* kseg = mt + 2;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kv = kseg[n * 8 + 2 * t + e];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * n + 2 * i + e];
              x = masked<BIAS>(x, scale, kv, qseg[i]) * LOG2E;
            }
          }
      }
      float mx[2] = {-INFINITY, -INFINITY}, mu[2], alpha[2];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mx[i] = fmaxf(mx[i], fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * c);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
        alpha[i] = ex2(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      unsigned pa[4][4];  // P rounded to bf16: the A fragments of k16 steps 0..3
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(s[4 * n + e], c, -mu[e >> 1]));
          l[e >> 1] += p[e];
        }
        pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HD == 64)
          wgmma_rs_n64_mn(acc, pa[kk], sw128_desc(vs_s + kk * 2048, L::BOX));
        else
          wgmma_rs_n128_mn(acc, pa[kk], sw128_desc(vs_s + kk * 2048, L::BOX));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (j < 0) break;  // the end of the tiles
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float inv = 1.0f / l[i];
    bf* dst = o + ((size_t)b * S + row[i]) * H + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * nh + h) * S + row[i]] = (m[i] + log2f(l[i])) * LN2;
  }
}

// ---- D = rowsum(dO * O) ------------------------------------------------------------------
//
// Every dQ body computes D = sum_d O * dO in fp32 for its own rows, from O and dO as
// stored (the stock VJP's formula, flash_attention.py:273-275, which runs it outside its
// kernels), uses it, and writes it to the [B, nh, S] buffer the dK/dV kernel reads.

// D of rows r0 .. r0 + 15 of one (sequence, head) by one warp (bf16, HD a multiple of 16;
// rows >= S: 0): two lanes a row, each 16-byte loads of half its columns. Writes each
// row's D at d_out[row]; returns the D of rows r0 + g (x) and r0 + g + 8 (y), g = lane / 4.
template <int HD>
__device__ __forceinline__ float2 warp_rows_D(const bf* __restrict__ o, const bf* __restrict__ dout,
                                              float* __restrict__ d_out, int H, int r0, int S,
                                              int lane) {
  const int r = r0 + (lane >> 1);
  float d = 0.f;
  if (r < S) {
    const size_t off = (size_t)r * H + (lane & 1) * (HD / 2);
    const uint4* a = reinterpret_cast<const uint4*>(o + off);
    const uint4* c = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
    for (int i = 0; i < HD / 16; ++i) {
      const uint4 x = __ldg(a + i), y = __ldg(c + i);
      const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // two bf16 a word: low half, then high half
        d = fmaf(__uint_as_float(xs[u] << 16), __uint_as_float(ys[u] << 16), d);
        d = fmaf(__uint_as_float(xs[u] & 0xffff0000u), __uint_as_float(ys[u] & 0xffff0000u), d);
      }
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (r < S && (lane & 1) == 0) d_out[r] = d;
  const int g = lane >> 2;
  return make_float2(__shfl_sync(0xffffffffu, d, 2 * g), __shfl_sync(0xffffffffu, d, 2 * g + 16));
}

// ---- bf16 backward on mma.sync: dQ (head dims other than 64 and 128) ----------------------

template <int HD>
size_t dq_mma_smem() {
  return sizeof(bf) * (2 * BM + 4 * BN) * mma_ld<HD>() + sizeof(int) * 2 * BN;
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_dq_mma(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
             const int* __restrict__ mask, const float* __restrict__ lse,
             const bf* __restrict__ o, const bf* __restrict__ dout, float* __restrict__ Dd,
             bf* __restrict__ dq, int S, int nh, long long bstride, int rstride,
             long long gbstride, int grstride, float scale) {
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
  const size_t stat = ((size_t)b * nh + h) * S;
  const float2 D2 = warp_rows_D<HD>(o + seq * H + h * HD, dout + seq * H + h * HD, Dd + stat, H,
                                    q0 + warp * 16, S, lane);
  int qseg[2];
  float rlse[2];
  const float rD[2] = {D2.x, D2.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    qseg[i] = in ? mask[seq + row[i]] : QUERY_PAST;
    rlse[i] = in ? lse[stat + row[i]] : 0.f;
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

// ---- bf16 backward on mma.sync: dK, dV (head dims other than 64 and 128) ---------------

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

// ---- bf16 backward on Hopper: wgmma + TMA (hd = 64 and 128) -----------------------------
//
// dQ (`flash_dq_wgmma`): one CTA per 128 query rows of one (sequence, head), as two
// consumer warpgroups of 64 rows and a producer warp, like the forward. Q and dO come in
// once by TMA; the producer walks the key tiles, skips those no row of the CTA can see
// (the forward's rule) and brings K and V into a ring of mbarrier-guarded stages, each
// with its tile's index, summary and key mask. Each consumer warp first computes D for
// its 16 rows (`warp_rows_D`) and writes it for the dK/dV kernel. Per tile, in
// registers: S = Q.K^T and dP = dO.V^T by wgmma from shared memory (both K-major);
// P = exp2(S scale log2(e) - lse log2(e)), masked score by score only where the pair of
// tiles is not one segment; dS = P (dP - D) scale rounded to bf16, whose accumulator
// layout is the A-fragment layout of dQ += dS.K, taken by wgmma with K MN-major.
//
// dK / dV (`flash_dkv_wgmma`): one CTA per 128 key rows at hd 64, as two consumer
// warpgroups of 64 keys (at hd 128 one warpgroup, 64 keys a CTA: its dK and dV
// accumulators take 128 registers a thread, and ptxas holds a CTA of two warpgroups and
// a producer warp to 168, as for three full warpgroups); K and V come in once by TMA.
// The producer streams the visible 64-query tiles of
// Q and dO by TMA, with the tile's query mask, lse and D beside them in the stage (the
// rule is symmetric in queries and keys: the key tile is the row tile). Per tile:
// S^T = K.Q^T and dP^T = V.dO^T (SS), P^T and dS^T in registers from each column's lse
// and D, then dV += P^T.dO and dK += dS^T.Q with dO and Q MN-major: the tile as TMA
// stored it is the K-major B of the first products and the MN-major B of the last.
// dQ stays out of this kernel: an fp32 atomic dQ would make the gradient depend on the
// order of the adds; the stock kernel's two-kernel split keeps it deterministic.
//
// A consumer that skips a stage still waits on its `full` barrier and arrives on its
// `empty` one. Skipping changes no bit: a skipped pair is segment-masked, its P and dS
// are 0. Pad queries see pad keys, so pad-by-pad pairs are visible and computed.

template <int HD, int NST_, int META_WORDS, int NWG_>
struct BwdLayout {
  static constexpr int CH = HD / 64;
  static constexpr int NST = NST_;
  static constexpr int NWG = NWG_;                        // consumer warpgroups
  static constexpr int ROWS = 64 * NWG;                   // resident rows per CTA
  static constexpr int THREADS = 128 * NWG + 32;          // and one producer warp
  static constexpr uint32_t BOX = 64 * 128;               // one TMA box: 64 rows x 128 B
  static constexpr uint32_t ROWS_BYTES = NWG * CH * BOX;  // the resident rows of one operand
  static constexpr uint32_t TILE_BYTES = CH * BOX;      // one streamed 64-row tile
  static constexpr uint32_t STAGE = 2 * TILE_BYTES;     // two streamed tiles
  static constexpr uint32_t META = NST * META_WORDS * 4;
  static constexpr uint32_t BARS = (2 * NST + 1) * 8;
  static constexpr size_t SMEM = 1024 + 2 * ROWS_BYTES + NST * STAGE + META + BARS;
};
// dQ: Q and dO resident, K and V streamed; a stage's meta {tile, summary, key masks}
template <int HD>
using DqLayout = BwdLayout<HD, HD == 64 ? 3 : 2, 2 + BN, 2>;
// dK / dV: K and V resident, Q and dO streamed; {tile, summary, query masks, lse log2(e), D}
template <int HD>
using DkvLayout = BwdLayout<HD, HD == 64 ? 4 : 3, 2 + 3 * BN, HD == 64 ? 2 : 1>;

// the lse (or D) of rows r0 + lane and r0 + 32 + lane of one [S] row (0 past S)
__device__ __forceinline__ float2 tile_stats(const float* __restrict__ p, int r0, int S, int lane) {
  const int a = r0 + lane, c = a + 32;
  return make_float2(a < S ? __ldg(p + a) : 0.f, c < S ? __ldg(p + c) : 0.f);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
               const int* __restrict__ mask, const float* __restrict__ lse,
               const bf* __restrict__ o, const bf* __restrict__ dout, float* __restrict__ Dd,
               bf* __restrict__ dq, int S, int nh, long long gbstride, int grstride, float scale) {
  using L = DqLayout<HD>;
  constexpr int CH = L::CH, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t q_s = base, do_s = base + L::ROWS_BYTES, kv_s = base + 2 * L::ROWS_BYTES;
  int* meta = reinterpret_cast<int*>(gbase + 2 * L::ROWS_BYTES + NST * L::STAGE);  // [NST][2 + BN]
  const uint32_t bars = kv_s + NST * L::STAGE + L::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };
  const uint32_t qbar = bars + 16u * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * WG_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int* mseq = mask + (size_t)b * S;
  const int n_tiles = (S + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    const int2 mq0 = tile_mask(mseq, q0, S, lane), mq1 = tile_mask(mseq, q0 + 64, S, lane);
    int2 mk = tile_mask(mseq, 0, S, lane);  // the next key tile's mask, read ahead
    if (lane == 0) {  // Q and dO first: they need no summary
      const int q_boxes = q0 + 64 < S ? 2 : 1;  // a second box only where rows remain
      mbar_expect_tx(qbar, 2 * q_boxes * CH * L::BOX);
      for (int half = 0; half < q_boxes; ++half)
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(q_s + (c * 2 + half) * L::BOX, &tmq, h * HD + c * 64, q0 + 64 * half, b,
                      qbar);
          tma_load_3d(do_s + (c * 2 + half) * L::BOX, &tmdo, h * HD + c * 64, q0 + 64 * half, b,
                      qbar);
        }
    }
    const unsigned qs0 = tile_summary(mq0), qs1 = tile_summary(mq1);
    int stage = 0;
    unsigned phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int2 cur = mk;
      const unsigned ks = tile_summary(cur);
      if (j + 1 < n_tiles) mk = tile_mask(mseq, (j + 1) * BN, S, lane);
      if (!tile_visible<false>(qs0, ks, true) && !tile_visible<false>(qs1, ks, true)) continue;
      mbar_wait(empty(stage), phase ^ 1);
      int* m = meta + stage * (2 + BN);
      m[2 + lane] = cur.x;
      m[2 + 32 + lane] = cur.y;
      if (lane == 0) {
        m[0] = j;
        m[1] = (int)ks;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t ks_s = kv_s + stage * L::STAGE, vs_s = ks_s + L::TILE_BYTES;
        mbar_expect_tx(full(stage), L::STAGE);
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(ks_s + c * L::BOX, &tmk, h * HD + c * 64, j * BN, b, full(stage));
          tma_load_3d(vs_s + c * L::BOX, &tmv, h * HD + c * 64, j * BN, b, full(stage));
        }
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty(stage), phase ^ 1);
    if (lane == 0) {
      meta[stage * (2 + BN)] = -1;  // the end of the tiles
      mbar_arrive(full(stage));
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; its warp wi rows 16 wi .. + 15
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int H = nh * HD;
  const size_t seq = (size_t)b * S, stat = ((size_t)b * nh + h) * S;
  const unsigned qs = tile_summary(mseq, r0, S, lane);
  const int row[2] = {r0 + wi * 16 + g, r0 + wi * 16 + g + 8};
  const float scale2 = scale * LOG2E;
  int qseg[2];
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    qseg[i] = in ? mseq[row[i]] : QUERY_PAST;
    lse2[i] = in ? lse[stat + row[i]] * LOG2E : 0.f;
  }
  const float2 D2 = warp_rows_D<HD>(o + seq * H + h * HD, dout + seq * H + h * HD, Dd + stat, H,
                                    r0 + wi * 16, S, lane);
  const float rD[2] = {D2.x, D2.y};
  float acc[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
  const uint32_t qa_s = q_s + wg * L::BOX, da_s = do_s + wg * L::BOX;  // this warpgroup's rows
  bool q_ready = false;
  int stage = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(full(stage), phase);
    const int* mt = meta + stage * (2 + BN);
    const int j = mt[0];
    const unsigned ks = (unsigned)mt[1];
    if (j >= 0 && (qs & ks & SEG_VALUES) != 0) {
      if (!q_ready) {
        mbar_wait(qbar, 0);
        q_ready = true;
      }
      const uint32_t ks_s = kv_s + stage * L::STAGE, vs_s = ks_s + L::TILE_BYTES;
      float s[32], dp[32];
#pragma unroll
      for (int n = 0; n < 32; ++n) s[n] = dp[n] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(s, sw128_desc(qa_s + (kk / 4) * 2 * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(ks_s + (kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, sw128_desc(da_s + (kk / 4) * 2 * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(vs_s + (kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP may still run
      fence_regs(s);
      if (qs == ks && (ks == SEG_ZERO || ks == SEG_ONE)) {  // one segment, no row past S
#pragma unroll
        for (int n = 0; n < 32; ++n) s[n] = ex2(fmaf(s[n], scale2, -lse2[(n >> 1) & 1]));
      } else {
        const int* kseg = mt + 2;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kv = kseg[n * 8 + 2 * t + e];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * n + 2 * i + e];
              x = ex2(fmaf(masked<false>(x, scale, kv, qseg[i]), LOG2E, -lse2[i]));
            }
          }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      unsigned da[4][4];  // dS rounded to bf16: the A fragments of k16 steps 0..3
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = s[4 * n + e] * (dp[4 * n + e] - rD[e >> 1]) * scale;
        da[n >> 1][2 * (n & 1)] = pack_bf16(x[0], x[1]);
        da[n >> 1][2 * (n & 1) + 1] = pack_bf16(x[2], x[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HD == 64)
          wgmma_rs_n64_mn(acc, da[kk], sw128_desc(ks_s + kk * 2048, L::BOX));
        else
          wgmma_rs_n128_mn(acc, da[kk], sw128_desc(ks_s + kk * 2048, L::BOX));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (j < 0) break;  // the end of the tiles
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf* dst = dq + (size_t)b * gbstride + (size_t)row[i] * grstride + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(DkvLayout<HD>::THREADS, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
                const int* __restrict__ mask, const float* __restrict__ lse,
                const float* __restrict__ Dd, bf* __restrict__ dk, bf* __restrict__ dv, int S,
                int nh, long long gbstride, int grstride, float scale) {
  using L = DkvLayout<HD>;
  constexpr int CH = L::CH, NST = L::NST, NWG = L::NWG, MW = 2 + 3 * BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t k_s = base, v_s = base + L::ROWS_BYTES, qd_s = base + 2 * L::ROWS_BYTES;
  int* meta = reinterpret_cast<int*>(gbase + 2 * L::ROWS_BYTES + NST * L::STAGE);  // [NST][MW]
  const uint32_t bars = qd_s + NST * L::STAGE + L::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };
  const uint32_t kvbar = bars + 16u * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * L::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int* mseq = mask + (size_t)b * S;
  const size_t stat = ((size_t)b * nh + h) * S;
  const int n_tiles = (S + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer
    // summaries of the CTA's one or two 64-key halves (a second one of NWG == 1 is empty)
    const int2 mk0 = tile_mask(mseq, k0, S, lane),
               mk1 = tile_mask(mseq, NWG == 2 ? k0 + 64 : S, S, lane);
    // the next query tile's mask, lse and D, read ahead
    int2 mq = tile_mask(mseq, 0, S, lane);
    float2 lq = tile_stats(lse + stat, 0, S, lane), dq2 = tile_stats(Dd + stat, 0, S, lane);
    if (lane == 0) {  // K and V first: they need no summary
      const int k_boxes = NWG == 2 && k0 + 64 < S ? 2 : 1;  // a second box only where rows remain
      mbar_expect_tx(kvbar, 2 * k_boxes * CH * L::BOX);
      for (int half = 0; half < k_boxes; ++half)
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(k_s + (c * NWG + half) * L::BOX, &tmk, h * HD + c * 64, k0 + 64 * half, b,
                      kvbar);
          tma_load_3d(v_s + (c * NWG + half) * L::BOX, &tmv, h * HD + c * 64, k0 + 64 * half, b,
                      kvbar);
        }
    }
    const unsigned ks0 = tile_summary(mk0), ks1 = tile_summary(mk1);
    int stage = 0;
    unsigned phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int2 cur = mq;
      const float2 cl = lq, cd = dq2;
      const unsigned qsum = tile_summary(cur);
      if (j + 1 < n_tiles) {
        mq = tile_mask(mseq, (j + 1) * BN, S, lane);
        lq = tile_stats(lse + stat, (j + 1) * BN, S, lane);
        dq2 = tile_stats(Dd + stat, (j + 1) * BN, S, lane);
      }
      if (!(ks0 & qsum & SEG_VALUES) && !(ks1 & qsum & SEG_VALUES)) continue;
      mbar_wait(empty(stage), phase ^ 1);
      int* m = meta + stage * MW;
      float* f = reinterpret_cast<float*>(m + 2 + BN);  // [BN] lse log2(e), then [BN] D
      m[2 + lane] = cur.x == KEY_PAST ? QUERY_PAST : cur.x;
      m[2 + 32 + lane] = cur.y == KEY_PAST ? QUERY_PAST : cur.y;
      f[lane] = cl.x * LOG2E;
      f[32 + lane] = cl.y * LOG2E;
      f[BN + lane] = cd.x;
      f[BN + 32 + lane] = cd.y;
      if (lane == 0) {
        m[0] = j;
        m[1] = (int)qsum;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t qt_s = qd_s + stage * L::STAGE, dot_s = qt_s + L::TILE_BYTES;
        mbar_expect_tx(full(stage), L::STAGE);
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(qt_s + c * L::BOX, &tmq, h * HD + c * 64, j * BN, b, full(stage));
          tma_load_3d(dot_s + c * L::BOX, &tmdo, h * HD + c * 64, j * BN, b, full(stage));
        }
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty(stage), phase ^ 1);
    if (lane == 0) {
      meta[stage * MW] = -1;  // the end of the tiles
      mbar_arrive(full(stage));
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63; its warp wi keys 16 wi .. + 15
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + 64 * wg;
  const unsigned ks = tile_summary(mseq, kr0, S, lane);
  const int krow[2] = {kr0 + wi * 16 + g, kr0 + wi * 16 + g + 8};
  const float scale2 = scale * LOG2E;
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = krow[i] < S ? mseq[krow[i]] : KEY_PAST;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dka[n] = dva[n] = 0.f;
  const uint32_t ka_s = k_s + wg * L::BOX, va_s = v_s + wg * L::BOX;  // this warpgroup's keys
  bool kv_ready = false;
  int stage = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(full(stage), phase);
    const int* mt = meta + stage * MW;
    const int j = mt[0];
    const unsigned qsum = (unsigned)mt[1];
    if (j >= 0 && (ks & qsum & SEG_VALUES) != 0) {
      if (!kv_ready) {
        mbar_wait(kvbar, 0);
        kv_ready = true;
      }
      const uint32_t qt_s = qd_s + stage * L::STAGE, dot_s = qt_s + L::TILE_BYTES;
      const float* fl = reinterpret_cast<const float*>(mt + 2 + BN);  // lse log2(e) by column
      const float* fd = fl + BN;                                      // D by column
      float st[32], dpt[32];  // [64 keys][64 queries]: S^T, then P^T; dP^T
#pragma unroll
      for (int n = 0; n < 32; ++n) st[n] = dpt[n] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(st, sw128_desc(ka_s + (kk / 4) * NWG * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(qt_s + (kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpt, sw128_desc(va_s + (kk / 4) * NWG * L::BOX + (kk % 4) * 32, 16),
                     sw128_desc(dot_s + (kk / 4) * L::BOX + (kk % 4) * 32, 16), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T may still run
      fence_regs(st);
      const bool dense = ks == qsum && (ks == SEG_ZERO || ks == SEG_ONE);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e;
          const float l2 = fl[c];
          const int qv = mt[2 + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = st[4 * n + 2 * i + e];
            x = dense ? ex2(fmaf(x, scale2, -l2))
                      : ex2(fmaf(masked<false>(x, scale, kseg[i], qv), LOG2E, -l2));
          }
        }
      wgmma_wait<0>();
      fence_regs(dpt);
      unsigned pa[4][4], sa[4][4];  // P^T and dS^T rounded to bf16: A fragments, k16 steps 0..3
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = st[4 * n + e] * (dpt[4 * n + e] - fd[n * 8 + 2 * t + (e & 1)]) * scale;
        pa[n >> 1][2 * (n & 1)] = pack_bf16(st[4 * n], st[4 * n + 1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(st[4 * n + 2], st[4 * n + 3]);
        sa[n >> 1][2 * (n & 1)] = pack_bf16(x[0], x[1]);
        sa[n >> 1][2 * (n & 1) + 1] = pack_bf16(x[2], x[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HD == 64) {
          wgmma_rs_n64_mn(dva, pa[kk], sw128_desc(dot_s + kk * 2048, L::BOX));
          wgmma_rs_n64_mn(dka, sa[kk], sw128_desc(qt_s + kk * 2048, L::BOX));
        } else {
          wgmma_rs_n128_mn(dva, pa[kk], sw128_desc(dot_s + kk * 2048, L::BOX));
          wgmma_rs_n128_mn(dka, sa[kk], sw128_desc(qt_s + kk * 2048, L::BOX));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dva);
      fence_regs(dka);
    }
    if (j < 0) break;  // the end of the tiles
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= S) continue;
    const size_t off = (size_t)b * gbstride + (size_t)krow[i] * grstride + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<unsigned*>(dk + off + n * 8) =
          pack_bf16(dka[4 * n + 2 * i], dka[4 * n + 2 * i + 1]);
      *reinterpret_cast<unsigned*>(dv + off + n * 8) =
          pack_bf16(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
    }
  }
}

// ---- fp32 backward (CUDA cores) ---------------------------------------------------------
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

size_t dq_f32_smem(int hd) {
  return sizeof(float) * (4 * (size_t)64 * f32_ld(hd) + 64 * LDP + 2 * 64) + sizeof(int) * 128;
}

__global__ void __launch_bounds__(FT)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ mask,
             const float* __restrict__ lse, const float* __restrict__ o,
             const float* __restrict__ dout, float* __restrict__ Dd, float* __restrict__ dq,
             int S, int nh, int hd, long long bstride, int rstride, long long gbstride,
             int grstride, float scale) {
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
  }
  // D of the tile's rows (rows >= S: 0), a warp a row; read after the loop's first barrier
  for (int r = tid >> 5; r < 64; r += FT / 32) {
    const int lane = tid & 31;
    float d = 0.f;
    if (q0 + r < S) {
      const size_t off = (seq + q0 + r) * H + (size_t)h * hd;
      for (int c = lane; c < hd; c += 32) d = fmaf(o[off + c], dout[off + c], d);
    }
    d = warp_sum(d);
    if (lane == 0) {
      Ds[r] = d;
      if (q0 + r < S) Dd[stat + q0 + r] = d;
    }
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

// ---- fp32 forward (CUDA cores) -------------------------------------------------------
//
// 128 threads as a 16 x 8 grid (tr, tc) over a 64 x 64 score tile: a thread owns rows
// tr + 16 a (a < 4) and keys tc + 8 c (c < 8), and the output columns of the float4
// groups tc + 8 i (i < NG, NG = ceil(hd / 32)). Q, K and V rows sit in shared memory at
// a stride of hd + 4 floats (an odd number of 16-byte units: the 8 keys a quarter-warp
// reads as float4 fall on distinct banks); each step of 4 dims takes 12 float4 loads for
// 128 FFMA. K and V come by cp.async (16-byte where every row is 16-byte aligned, else
// 4-byte), staggered in one buffer each: the next K tile loads during this tile's P.V,
// this V tile during Q.K^T and the softmax, so that three CTAs fit an SM (hd <= 64);
// only key tiles the query tile can see are staged. The row max and sum go by shuffles
// among the 8 threads of a row; P goes through shared memory for P.V, read as float4
// along the keys. Two barriers per tile.

constexpr int F32_THREADS = 128;
constexpr int F32_LDP = 68;  // P tile [64][68]

__host__ __device__ constexpr int f32_fwd_ld(int hd) { return hd + 4; }

size_t fwd_f32_smem(int hd) {
  return sizeof(float) * (3 * (size_t)64 * f32_fwd_ld(hd) + 64 * F32_LDP) + sizeof(int) * 64;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// 64 rows of hd floats (row r at src + r * stride, rows >= n zero) into a [64][ld] tile
template <bool VEC>
__device__ __forceinline__ void stage_f32_async(float* dst, int ld, const float* src,
                                                size_t stride, int n, int hd, int tid) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = hd / W;
  for (int idx = tid; idx < 64 * per_row; idx += F32_THREADS) {
    const int r = idx / per_row, c = (idx - r * per_row) * W;
    float* d = dst + r * ld + c;
    if (r >= n) {
#pragma unroll
      for (int u = 0; u < W; ++u) d[u] = 0.f;
    } else if (VEC) {
      cp_async16(d, src + (size_t)r * stride + c);
    } else {
      cp_async4(d, src + (size_t)r * stride + c);
    }
  }
}

template <int NG, bool BIAS, bool VEC>
__global__ void __launch_bounds__(F32_THREADS, NG <= 2 ? 3 : 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ mask, float* __restrict__ o,
              float* __restrict__ lse, int S, int nh, int hd, long long bstride, int rstride,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_fwd_ld(hd);
  float* Qs = reinterpret_cast<float*>(smem);  // [64][ld]
  float* Ks = Qs + 64 * ld;                    // [64][ld]
  float* Vs = Ks + 64 * ld;                    // [64][ld]
  float* Ps = Vs + 64 * ld;                    // [64][F32_LDP]
  int* kseg = reinterpret_cast<int*>(Ps + 64 * F32_LDP);  // [64]
  const int tid = threadIdx.x, lane = tid & 31, tr = tid >> 3, tc = tid & 7;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * bstride + (size_t)h * hd;
  const int* mseq = mask + (size_t)b * S;
  const int n_tiles = (S + BN - 1) / BN;

  const unsigned qs = tile_summary(mseq, q0, S, lane);
  const bool has_one = BIAS ? has_one_key(mseq, S, lane) : true;
  auto next_tile = [&](int j) {  // the first key tile from j on that the query tile sees
    while (j < n_tiles && !tile_visible<BIAS>(qs, tile_summary(mseq, j * BN, S, lane), has_one))
      ++j;
    return j;
  };
  auto load_k = [&](int j) {
    const int j0 = j * BN;
    stage_f32_async<VEC>(Ks, ld, k + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
    for (int r = tid; r < BN; r += F32_THREADS) kseg[r] = j0 + r < S ? mseq[j0 + r] : KEY_PAST;
  };
  auto load_v = [&](int j) {
    const int j0 = j * BN;
    stage_f32_async<VEC>(Vs, ld, v + head + (size_t)j0 * rstride, rstride, S - j0, hd, tid);
  };
  stage_f32_async<VEC>(Qs, ld, q + head + (size_t)q0 * rstride, rstride, S - q0, hd, tid);
  int j = next_tile(0);
  if (j < n_tiles) load_k(j);
  cp_async_commit();

  int qseg[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) qseg[a] = q0 + tr + 16 * a < S ? mseq[q0 + tr + 16 * a] : QUERY_PAST;
  float4 acc[4][NG];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NG; ++i) acc[a][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }

  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    cp_async_wait<0>();
    __syncthreads();  // K of tile j (and Q) staged; every thread is done with the last P.V
    load_v(j);
    cp_async_commit();
    const float* Kb = Ks;
    const float* Vb = Vs;
    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      float4 x[4], y[8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        x[a] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * a) * ld + d);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        y[c] = *reinterpret_cast<const float4*>(Kb + (tc + 8 * c) * ld + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[a][c] = fmaf(x[a].x, y[c].x, s[a][c]);
          s[a][c] = fmaf(x[a].y, y[c].y, s[a][c]);
          s[a][c] = fmaf(x[a].z, y[c].z, s[a][c]);
          s[a][c] = fmaf(x[a].w, y[c].w, s[a][c]);
        }
    }
    const int* sk = kseg;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[a][c] = masked<BIAS>(s[a][c], scale, sk[tc + 8 * c], qseg[a]) * LOG2E;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      const float alpha = exp2f(m[a] - mu);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = exp2f(s[a][c] - mu);
        Ps[(tr + 16 * a) * F32_LDP + tc + 8 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      m[a] = m_new;
      l[a] = l[a] * alpha + sum;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        acc[a][i].x *= alpha;
        acc[a][i].y *= alpha;
        acc[a][i].z *= alpha;
        acc[a][i].w *= alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // P complete, V of tile j staged, every thread is done with K
    if (jn < n_tiles) load_k(jn);
    cp_async_commit();
    for (int j4 = 0; j4 < BN; j4 += 4) {
      float4 p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        p[a] = *reinterpret_cast<const float4*>(Ps + (tr + 16 * a) * F32_LDP + j4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int col = 4 * (tc + 8 * i);
          if (col >= hd) continue;
          const float4 y = *reinterpret_cast<const float4*>(Vb + (j4 + u) * ld + col);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float pa = u == 0 ? p[a].x : u == 1 ? p[a].y : u == 2 ? p[a].z : p[a].w;
            acc[a][i].x = fmaf(pa, y.x, acc[a][i].x);
            acc[a][i].y = fmaf(pa, y.y, acc[a][i].y);
            acc[a][i].z = fmaf(pa, y.z, acc[a][i].z);
            acc[a][i].w = fmaf(pa, y.w, acc[a][i].w);
          }
        }
      }
    }
    j = jn;
  }
  const int H = nh * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + tr + 16 * a;
    if (r >= S) continue;
    const float inv = 1.0f / l[a];
    float* dst = o + ((size_t)b * S + r) * H + h * hd;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int col = 4 * (tc + 8 * i);
      if (col < hd)
        *reinterpret_cast<float4*>(dst + col) = make_float4(
            acc[a][i].x * inv, acc[a][i].y * inv, acc[a][i].z * inv, acc[a][i].w * inv);
    }
    if (lse != nullptr && tc == 0) lse[((size_t)b * nh + h) * S + r] = (m[a] + log2f(l[a])) * LN2;
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

// The tensor map of one of q, k, v: dims (nh * hd, S, B), innermost first, strides in
// bytes; boxes of 64 columns x 64 rows, 128-byte swizzle (the wgmma operand layout); rows
// past S read as zeros.
int encode_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B, int S, int H,
               long long bstride, int rstride) {
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  // a single sequence's batch stride is never used: any legal value
  const long long bs = B > 1 ? bstride : (long long)rstride * S;
  const cuuint64_t strides[2] = {(cuuint64_t)rstride * sizeof(bf), (cuuint64_t)bs * sizeof(bf)};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A map depends only on its address, dims and strides, so the last few are kept: at the
// query tower's shapes the encodes would cost more host time than the kernel's run.
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, long long bstride,
             int rstride) {
  struct Entry {
    const void* base;
    int B, S, H, rstride;
    long long bstride;
    CUtensorMap map;
  };
  constexpr int N = 24;
  static Entry cache[N];
  static int filled = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.B == B && e.S == S && e.H == H && e.rstride == rstride &&
        e.bstride == bstride) {
      *map = e.map;
      return 0;
    }
  }
  EncodeTiled encode;
  int err = encode_tiled(&encode);
  if (err || (err = encode_map(map, encode, base, B, S, H, bstride, rstride))) return err;
  cache[next] = Entry{base, B, S, H, rstride, bstride, *map};
  next = (next + 1) % N;
  filled = filled < N ? filled + 1 : N;
  return 0;
}

template <int HD>
int fwd_wgmma(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
              int B, int S, int nh, long long bs, int rs, float scale, int bias,
              cudaStream_t st) {
  CUtensorMap tmq, tmk, tmv;
  const int H = nh * HD;
  int err;
  if ((err = make_map(&tmq, q, B, S, H, bs, rs)) || (err = make_map(&tmk, k, B, S, H, bs, rs)) ||
      (err = make_map(&tmv, v, B, S, H, bs, rs)))
    return err;
  const size_t smem = WgLayout<HD>::SMEM;
  auto kernel = bias ? flash_fwd_wgmma<HD, true> : flash_fwd_wgmma<HD, false>;
  if ((err = set_smem(kernel, smem))) return err;
  kernel<<<dim3((S + WG_ROWS - 1) / WG_ROWS, nh, B), WG_THREADS, smem, st>>>(
      tmq, tmk, tmv, mask, static_cast<bf*>(o), lse, S, nh, scale);
  return (int)cudaGetLastError();
}

template <int NG>
int fwd_f32(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
            int B, int S, int nh, int hd, long long bs, int rs, float scale, int bias,
            cudaStream_t st) {
  // 16-byte copies where every row starts 16-byte aligned
  const bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
                   rs % 4 == 0 && bs % 4 == 0;
  auto kernel = bias ? (vec ? flash_fwd_f32<NG, true, true> : flash_fwd_f32<NG, true, false>)
                     : (vec ? flash_fwd_f32<NG, false, true> : flash_fwd_f32<NG, false, false>);
  const size_t smem = fwd_f32_smem(hd);
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid_of(B, S, nh), F32_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(o), lse, S, nh, hd, bs, rs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int dq_mma(const void* q, const void* k, const void* v, const int* mask, const float* lse,
           const void* o, const void* dout, float* D, void* dq, int B, int S, int nh,
           long long bs, int rs, long long gbs, int grs, float scale, cudaStream_t st) {
  const size_t smem = dq_mma_smem<HD>();
  int err = set_smem(flash_dq_mma<HD>, smem);
  if (err) return err;
  flash_dq_mma<HD><<<grid_of(B, S, nh), 128, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask, lse,
      static_cast<const bf*>(o), static_cast<const bf*>(dout), D, static_cast<bf*>(dq), S, nh, bs,
      rs, gbs, grs, scale);
  return (int)cudaGetLastError();
}

// the maps of q, k, v (through strides) and of the contiguous [B, S, H] dO
int bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int S, int H, long long bs, int rs) {
  int err;
  if ((err = make_map(&maps[0], q, B, S, H, bs, rs)) || (err = make_map(&maps[1], k, B, S, H, bs, rs)) ||
      (err = make_map(&maps[2], v, B, S, H, bs, rs)) ||
      (err = make_map(&maps[3], dout, B, S, H, (long long)S * H, H)))
    return err;
  return 0;
}

template <int HD>
int dq_wgmma(const void* q, const void* k, const void* v, const int* mask, const float* lse,
             const void* o, const void* dout, float* D, void* dq, int B, int S, int nh,
             long long bs, int rs, long long gbs, int grs, float scale, cudaStream_t st) {
  CUtensorMap m[4];
  int err = bwd_maps(m, q, k, v, dout, B, S, nh * HD, bs, rs);
  if (err) return err;
  const size_t smem = DqLayout<HD>::SMEM;
  if ((err = set_smem(flash_dq_wgmma<HD>, smem))) return err;
  flash_dq_wgmma<HD><<<dim3((S + WG_ROWS - 1) / WG_ROWS, nh, B), WG_THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], mask, lse, static_cast<const bf*>(o), static_cast<const bf*>(dout),
      D, static_cast<bf*>(dq), S, nh, gbs, grs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_wgmma(const void* q, const void* k, const void* v, const int* mask, const float* lse,
              const float* D, const void* dout, void* dk, void* dv, int B, int S, int nh,
              long long bs, int rs, long long gbs, int grs, float scale, cudaStream_t st) {
  CUtensorMap m[4];
  int err = bwd_maps(m, q, k, v, dout, B, S, nh * HD, bs, rs);
  if (err) return err;
  const size_t smem = DkvLayout<HD>::SMEM;
  if ((err = set_smem(flash_dkv_wgmma<HD>, smem))) return err;
  using L = DkvLayout<HD>;
  flash_dkv_wgmma<HD><<<dim3((S + L::ROWS - 1) / L::ROWS, nh, B), L::THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], mask, lse, D, static_cast<bf*>(dk), static_cast<bf*>(dv), S, nh,
      gbs, grs, scale);
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

// the bf16 head dims of the mma.sync bodies: 64 and 128 take the wgmma ones
#define DRT_HD_SWITCH(CALL)                                                        \
  switch (hd) {                                                                    \
    case 16: return CALL(16);                                                      \
    case 32: return CALL(32);                                                      \
    case 48: return CALL(48);                                                      \
    case 80: return CALL(80);                                                      \
    case 96: return CALL(96);                                                      \
    case 112: return CALL(112);                                                    \
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
  if (is_bf16 && (hd == 64 || hd == 128))  // the Hopper body; other head dims on mma.sync
    return hd == 64 ? fwd_wgmma<64>(q, k, v, m, o, l, B, S, nh, bstride, rstride, scale, bias, st)
                    : fwd_wgmma<128>(q, k, v, m, o, l, B, S, nh, bstride, rstride, scale, bias, st);
  if (is_bf16) {
#define DRT_CALL(HD) fwd_mma<HD>(q, k, v, m, o, l, B, S, nh, bstride, rstride, scale, bias, st)
    DRT_HD_SWITCH(DRT_CALL)
#undef DRT_CALL
  }
#define DRT_CALL(NG) fwd_f32<NG>(q, k, v, m, o, l, B, S, nh, hd, bstride, rstride, scale, bias, st)
  switch ((hd + 31) / 32) {
    case 1: return DRT_CALL(1);
    case 2: return DRT_CALL(2);
    case 3: return DRT_CALL(3);
    default: return DRT_CALL(4);
  }
#undef DRT_CALL
}

// o, dout [B, S, nh * hd] contiguous (bf16: 16-byte aligned); lse [B, nh, S] fp32; D
// [B, nh, S] fp32, written (rows < S); dq rows `grstride` and sequences `gbstride`
// elements apart (the [B, S, 3H] gradient)
extern "C" int drt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* lse, const void* o, const void* dout, void* D,
                                void* dq, int B, int S, int nh, int hd, long long bstride,
                                int rstride, long long gbstride, int grstride, float scale,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, nh, hd, is_bf16)) return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (is_bf16 && (hd == 64 || hd == 128))  // the Hopper body; other head dims on mma.sync
    return hd == 64 ? dq_wgmma<64>(q, k, v, m, l, o, dout, d, dq, B, S, nh, bstride, rstride,
                                   gbstride, grstride, scale, st)
                    : dq_wgmma<128>(q, k, v, m, l, o, dout, d, dq, B, S, nh, bstride, rstride,
                                    gbstride, grstride, scale, st);
  if (is_bf16) {
#define DRT_CALL(HD)                                                                          \
  dq_mma<HD>(q, k, v, m, l, o, dout, d, dq, B, S, nh, bstride, rstride, gbstride, grstride, \
             scale, st)
    DRT_HD_SWITCH(DRT_CALL)
#undef DRT_CALL
  }
  const size_t smem = dq_f32_smem(hd);
  int err = set_smem(flash_dq_f32, smem);
  if (err) return err;
  flash_dq_f32<<<grid_of(B, S, nh), FT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), m,
      l, static_cast<const float*>(o), static_cast<const float*>(dout), d, static_cast<float*>(dq),
      S, nh, hd, bstride, rstride, gbstride, grstride, scale);
  return (int)cudaGetLastError();
}

// D [B, nh, S] fp32 as drt_flash_bwd_dq wrote it; dk and dv like dq
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
  if (is_bf16 && (hd == 64 || hd == 128))  // the Hopper body; other head dims on mma.sync
    return hd == 64 ? dkv_wgmma<64>(q, k, v, m, l, d, dout, dk, dv, B, S, nh, bstride, rstride,
                                    gbstride, grstride, scale, st)
                    : dkv_wgmma<128>(q, k, v, m, l, d, dout, dk, dv, B, S, nh, bstride, rstride,
                                     gbstride, grstride, scale, st);
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
