// K3 and K4: the fused in-batch contrastive loss (softmax CE over q.p^T with stride
// targets) and its gradient, without the [Q, P] score matrix.
//
// Replaces the TPU kernels of denseretrievaltoolkits_tpu/ops/contrastive.py:
// - K3, `_fwd_kernel` (contrastive.py:39, launched by `_fused_fwd`, :90): per query row
//   the log-sum-exp of its scores against every passage and the score of its target
//   passage, column r * stride. The loss, sum(lse - tgt) / n_q, is a torch reduction
//   outside the kernel, as the reference takes it outside its pallas_call (:112).
// - K4, `_bwd_dq_kernel` and `_bwd_dp_kernel` (contrastive.py:121, 150, launched at
//   :186, :200): with g = (exp(s - lse) - onehot) / n_q recomputed tile by tile,
//   dq = g.p and dp = g^T.q, each times the upstream scalar.
//
// fp32 in, fp32 out. K3 and K4 at the shapes their tensor-core bodies do not take compute
// their products in true fp32 on the CUDA cores (FFMA, no TF32: the reference's tolerances,
// 1e-5 on the loss and the grads, leave no room for one TF32 pass). At the grad-cache scale
// (Q=4096, P=32768, H=768) each pass is 2QPH or 4QPH flops and reads its operands from L2,
// so these bodies are bound by FFMA issue (K3: 3.077 ms, K4: 6.154 ms a pass).
//
// What the design keeps out of device memory: the [Q, P] scores, probabilities and g.
// On the TPU the passage-tile axis is a sequential grid dimension carrying m/l/t in VMEM
// scratch; here blocks run in no order, so a loop inside the block walks the other side:
// - K3 (its FFMA body, at the shapes the tensor-core body below does not take): a block owns
//   32 query rows, resident (transposed) in shared memory, and walks
//   all passages in tiles of 256, staging 32-deep k-slices (prefetched into registers
//   while the previous slice is scored). Each thread scores 8 rows x 4 columns and keeps
//   its own running max / sum of exponentials / target score per row in registers; the
//   lanes and the two warps that share a row merge once, at the end. Columns >= P never
//   enter the sums (contrastive.py:50-51 masks them).
// - K3 on the tensor cores (`contrastive_fwd_wgmma`, H % 64 == 0, 16-byte aligned rows): the
//   products as fp16 pairs (split.cuh), three fp16 products at 989 TFLOP/s, 0.625 ms at the
//   grad-cache scale. `absmax_kernel` and `split_planes_kernel` write q and p as fp16 hi and
//   lo planes into the scratch first. A CTA owns a 128-row query tile (two consumer
//   warpgroups of 64 rows, the wgmma M) and walks its part of the passages in 128-row tiles
//   (the N); a producer warp brings each 64-dim stage of both tiles' planes by TMA into a
//   ring of three. Per stage each warpgroup issues hi.lo and lo.hi, then hi.hi, as SS
//   m64n128k16 wgmma, and moves the stage's sum into an fp32 total (one rounding a stage:
//   the tensor cores truncate their sums, and a chain over all of H read 3-8x the FFMA
//   body's error against fp64; the small products first leave only the hi.hi sums to
//   truncate at the stage sum's magnitude). After a tile's last stage the epilogue runs in
//   registers: columns >= P masked, each row's max over the thread's columns and its quad
//   (shuffles), the running sum rescaled and the tile's exponentials added, the target score
//   taken by the thread that holds column r * stride. The passage axis is split into parts
//   so the grid fills the SMs (Q=4096: 32 query tiles x 4 parts; Q=32: one x 2), launched
//   part-major so a part's CTAs walk the same passage tiles at once (128 x 128 tiles read
//   6.4 GB from L2 at the grad-cache scale); each part writes its rows' (max, sum, target)
//   and the part that finishes last, by a counter, merges them in part order (results repeat
//   bit for bit). Tried and left out (PERF.md): a cluster of two query tiles multicasting the
//   passage tile (L2 reads 4.8 GB, no faster), two accumulators in turn (spilled at the 168
//   registers of a 288-thread CTA), the two warpgroups issuing in turn (slower).
// - K4 (its FFMA body, at the shapes the tensor-core body below does not take): one body,
//   two instances. dq: a block owns 32 query rows and walks the passages;
//   dp: a block owns 32 passage rows and walks the queries. Per walked tile of 256 rows
//   it recomputes the [32, 256] score tile, forms g in shared memory, and adds g.X (X the
//   walked rows, in 256-column chunks of H) into a [32, H] fp32 accumulator in shared
//   memory. Each output row belongs to one block, so there are no atomics and results
//   repeat bit for bit. Ragged Q and P are masked here: rows past the end load as zeros
//   and take g = 0 (the TPU's padding with lse = 1e30, contrastive.py:248-252, is not
//   carried over).
// - K4 on the tensor cores (`contrastive_bwd_wgmma`, H = 768, 16-byte aligned rows): both
//   products as fp16 pairs (split.cuh: each operand scaled by a power of two, hi + lo, the
//   three products hi.hi + hi.lo + lo.hi; the same 22-bit halves as a TF32 split in half the
//   bytes, at twice the rate: 3 x 4QPH at 989 TFLOP/s, 1.25 ms a pass at the grad-cache
//   scale). The scales of q and p (their largest magnitudes, `absmax_kernel`) and of g (2^13:
//   |exp(s - lse) - onehot| <= 1; 1/n_q joins the output's factor) come back out exactly.
//   Before the pass, `split_planes_kernel` writes the walked side as fp16 hi and lo planes
//   (its bytes again, in the scratch), which TMA then brings tile by tile.
//   A tile of 64 owned rows over all of H as fp16 pairs takes 196 KB, and a walked tile as
//   much again: more than a CTA's shared memory. So a cluster of four CTAs shares an owned
//   tile, each CTA one quarter of H (192 dims): its owned rows' quarter resident (48 KB,
//   split in the prologue), the walked tiles' quarters in two TMA buffers. Per walked tile
//   of 64 rows each CTA computes its quarter's partial scores (m64n64k16 SS wgmma, owned
//   rows as M); warp w's 16 rows go by one bulk copy to CTA w (reduce-scatter), which sums
//   the four partials of its 16 rows in rank order (a fixed order: results repeat bit for
//   bit), forms g for them with all four warps, and
//   sends those rows of g's planes to the other three CTAs by bulk copies (all-gather).
//   Each copy completes on the receiver's mbarrier, so a CTA waits only for the data it
//   needs (cluster barriers per tile cost twice as much; double buffers and the data's own
//   dependencies keep a buffer from being refilled before it is read). Then the gradient
//   quarter += g . walked tile (m64n192k16 SS wgmma, the walked tile MN-major: the same
//   buffers serve both products), in registers; the chain's sum goes to the output every 16
//   tiles (the tensor cores' fp32 sums are not rounded to nearest). Each output element
//   belongs to one CTA: no atomics. Where one wave of clusters would leave SMs idle (the
//   training path's Q=32, P=256; dq at Q=4096 fills 2.1 waves of 30), the walked axis is
//   split across clusters, each writing its part's sum to the scratch, which
//   `sum_splits_kernel` adds in split order.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "split.cuh"

using namespace drt;

namespace {

constexpr int NT = 256;          // threads per block: 8 warps
constexpr int OWN = 32;          // rows a block owns: 4 warp rows x 8
constexpr int WALK = 256;        // rows of a walked tile (and columns of a product chunk)
constexpr int KT = 32;           // depth of a staged slice
constexpr int LDA = OWN + 4;     // [k][row] slices of the owned side; float4-aligned rows
constexpr int LDB = WALK + 4;    // [k][col] slices of the walked side
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[i][j] += sum_k A[k][8 wr + i] * B[k][128 wc + 4 lane + j], k < KT, for A with rows
// of LDA floats and B with rows of LDB floats in shared memory: a warp reads its 8 A
// values as two broadcast float4 and its lanes one float4 of B each, per 32 FFMA.
__device__ __forceinline__ void ffma_tile(const float* __restrict__ A, const float* __restrict__ B,
                                          float (&acc)[8][4], int wr, int wc, int lane) {
  const float* a = A + 8 * wr;
  const float* b = B + 128 * wc + 4 * lane;
#pragma unroll 8
  for (int k = 0; k < KT; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * LDA + 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * LDB);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
}

// One 32 x 32 slice of the owned rows (rows row0.., columns col0.. of a [*, H] matrix),
// one float4 per thread, stored transposed as [k][row] with rows of LDA floats. Rows
// past the end and columns >= H load as zeros.
struct OwnSlice {
  float4 v;
  __device__ __forceinline__ void fetch(const float* src, int H, int row0, int nrows, int col0) {
    const int r = threadIdx.x >> 3, c = col0 + (threadIdx.x & 7) * 4;
    v = r < nrows && c < H ? ld4(src + (size_t)(row0 + r) * H + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* dst) const {
    const int r = threadIdx.x >> 3, k = (threadIdx.x & 7) * 4;
    dst[(k + 0) * LDA + r] = v.x;
    dst[(k + 1) * LDA + r] = v.y;
    dst[(k + 2) * LDA + r] = v.z;
    dst[(k + 3) * LDA + r] = v.w;
  }
};

// One slice of the walked rows, eight float4 per thread (consecutive threads read
// consecutive 16 bytes of a row), held in registers until stored:
// - TRANS: 256 rows x 32 columns, stored [k][row] (the score product's B operand);
// - !TRANS: 32 rows x 256 columns, stored as they are, [row][col] (the g.X product's B).
template <bool TRANS>
struct WalkSlice {
  float4 v[8];
  __device__ __forceinline__ static void coords(int i, int& r, int& c) {
    const int idx = threadIdx.x + i * NT;
    if (TRANS) { r = idx >> 3; c = (idx & 7) * 4; }
    else { r = idx >> 6; c = (idx & 63) * 4; }
  }
  __device__ __forceinline__ void fetch(const float* src, int H, int row0, int nrows, int col0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int r, c;
      coords(i, r, c);
      v[i] = r < nrows && col0 + c < H ? ld4(src + (size_t)(row0 + r) * H + col0 + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int r, c;
      coords(i, r, c);
      if (TRANS) {
        dst[(c + 0) * LDB + r] = v[i].x;
        dst[(c + 1) * LDB + r] = v[i].y;
        dst[(c + 2) * LDB + r] = v[i].z;
        dst[(c + 3) * LDB + r] = v[i].w;
      } else {
        *reinterpret_cast<float4*>(dst + r * LDB + c) = v[i];
      }
    }
  }
};

// [OWN, 256] scores of the owned rows (own_s: the owned slices, resident, or a staging
// buffer refilled per slice when own_src is given) against walked rows c0.., into acc.
// On entry `next` holds the walked tile's first slice; on exit the next tile's first.
__device__ __forceinline__ void score_tile(const float* own_src, int n_own, int r0, float* own_s,
                                           const float* walk, int n_walk, int c0, int H,
                                           float* bT, WalkSlice<true>& next, float (&acc)[8][4],
                                           int wr, int wc, int lane) {
  const int nk = (H + KT - 1) / KT;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  OwnSlice a;
  if (own_src) a.fetch(own_src, H, r0, n_own - r0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();  // the previous readers of the staging buffers are done
    next.store(bT);
    if (own_src) a.store(own_s);
    __syncthreads();
    // prefetch the next slice (or the next tile's first) while this one is scored
    if (kc + 1 < nk) {
      next.fetch(walk, H, c0, n_walk - c0, (kc + 1) * KT);
      if (own_src) a.fetch(own_src, H, r0, n_own - r0, (kc + 1) * KT);
    } else if (c0 + WALK < n_walk) {
      next.fetch(walk, H, c0 + WALK, n_walk - c0 - WALK, 0);
    }
    ffma_tile(own_src ? own_s : own_s + kc * KT * LDA, bT, acc, wr, wc, lane);
  }
}

// ---- K3: per query row lse and target score --------------------------------------------

size_t fwd_smem_bytes(int H) {
  const int nk = (H + KT - 1) / KT;
  return sizeof(float) * ((size_t)nk * KT * LDA + (size_t)KT * LDB + (size_t)OWN * 3);
}

__global__ void __launch_bounds__(NT)
contrastive_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                       float* __restrict__ lse, float* __restrict__ tgt, int Q, int P, int H,
                       int stride) {
  extern __shared__ __align__(16) float smem[];
  const int nk = (H + KT - 1) / KT;
  float* qT = smem;                     // [nk * KT][LDA]: the block's query rows, resident
  float* bT = qT + nk * KT * LDA;       // [KT][LDB]: a passage slice
  float* part = bT + KT * LDB;          // [OWN][3]: warp column 1's (max, sum, target)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
  const int q0 = blockIdx.x * OWN;

  for (int kc = 0; kc < nk; ++kc) {  // published by score_tile's first barrier
    OwnSlice a;
    a.fetch(q, H, q0, Q - q0, kc * KT);
    a.store(qT + kc * KT * LDA);
  }
  // per thread and row: running max, sum of exp(s - max) and target score over its columns
  float m[8], l[8], t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { m[i] = -INFINITY; l[i] = 0.f; t[i] = 0.f; }

  WalkSlice<true> next;
  next.fetch(p, H, 0, P, 0);
  for (int c0 = 0; c0 < P; c0 += WALK) {
    float acc[8][4];
    score_tile(nullptr, Q, q0, qT, p, P, c0, H, bT, next, acc, wr, wc, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long target = (long long)(q0 + 8 * wr + i) * stride;
      float s[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 128 * wc + 4 * lane + j;
        s[j] = col < P ? acc[i][j] : -INFINITY;
        mx = fmaxf(mx, s[j]);
        if (col < P && col == target) t[i] += acc[i][j];
      }
      const float mn = fmaxf(m[i], mx);
      if (mn != -INFINITY) {  // some column of this thread is real
        float sum = l[i] * expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[j] - mn);
        l[i] = sum;
        m[i] = mn;
      }
    }
  }

  // merge the lanes of a warp, then the two warps (wc = 0, 1) that share a row
  float M[8], L[8], T[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    M[i] = warp_max(m[i]);
    L[i] = warp_sum(m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - M[i]));
    T[i] = warp_sum(t[i]);
    if (wc == 1 && lane == 0) {
      float* pr = part + (8 * wr + i) * 3;
      pr[0] = M[i]; pr[1] = L[i]; pr[2] = T[i];
    }
  }
  __syncthreads();
  if (wc == 0 && lane < 8) {
    const int i = lane, row = q0 + 8 * wr + i;
    float Mi = 0.f, Li = 0.f, Ti = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (u == i) { Mi = M[u]; Li = L[u]; Ti = T[u]; }
    const float* pr = part + (8 * wr + i) * 3;
    const float mx = fmaxf(Mi, pr[0]);
    const float sum = (Mi == -INFINITY ? 0.f : Li * expf(Mi - mx)) +
                      (pr[0] == -INFINITY ? 0.f : pr[1] * expf(pr[0] - mx));
    if (row < Q) {
      lse[row] = logf(sum) + mx;
      tgt[row] = Ti + pr[2];
    }
  }
}

// ---- K4: dq (DP = false) and dp (DP = true) ---------------------------------------------

size_t bwd_smem_bytes(int H) {
  return sizeof(float) * ((size_t)OWN * H + (size_t)KT * LDA + (size_t)KT * LDB +
                          (size_t)WALK * LDA);
}

// own: the side whose gradient this computes ([n_own, H]: q for dq, p for dp); walk: the
// other side. lse is indexed by query. out = gout * sum over walked rows of g . walk.
template <bool DP>
__global__ void __launch_bounds__(NT)
contrastive_bwd_kernel(const float* __restrict__ own, const float* __restrict__ walk,
                       const float* __restrict__ lse, const float* __restrict__ gout,
                       float* __restrict__ out, int n_own, int n_walk, int H, int stride,
                       int n_q) {
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                   // [OWN][H]: the block's gradient rows
  float* aT = acc_s + OWN * H;           // [KT][LDA]: an owned slice
  float* bT = aT + KT * LDA;             // [KT][LDB]: a walked slice (either layout)
  float* gT = bT + KT * LDB;             // [WALK][LDA]: g of the tile, transposed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
  const int r0 = blockIdx.x * OWN;

  for (int idx = threadIdx.x * 4; idx < OWN * H; idx += NT * 4)
    *reinterpret_cast<float4*>(acc_s + idx) = make_float4(0.f, 0.f, 0.f, 0.f);

  WalkSlice<true> next;
  next.fetch(walk, H, 0, n_walk, 0);
  for (int c0 = 0; c0 < n_walk; c0 += WALK) {
    float acc[8][4];
    score_tile(own, n_own, r0, aT, walk, n_walk, c0, H, bT, next, acc, wr, wc, lane);
    // g = (exp(s - lse) - onehot) / n_q, 0 outside the real rows; stored as gT[col][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 128 * wc + 4 * lane + j;
      float g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + 8 * wr + i;
        const int qi = DP ? c : r, pj = DP ? r : c;
        g[i] = 0.f;
        if (r < n_own && c < n_walk) {
          const float onehot = (long long)pj == (long long)qi * stride ? 1.f : 0.f;
          g[i] = (expf(acc[i][j] - __ldg(lse + qi)) - onehot) / (float)n_q;
        }
      }
      float* dst = gT + (128 * wc + 4 * lane + j) * LDA + 8 * wr;
      *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(g[4], g[5], g[6], g[7]);
    }
    // acc_s[:, h0:h0+256] += g . walk[c0:c0+256, h0:h0+256]
    for (int h0 = 0; h0 < H; h0 += WALK) {
      float acc2[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
      WalkSlice<false> x;
      x.fetch(walk, H, c0, n_walk - c0, h0);
      for (int kc = 0; kc < WALK / KT; ++kc) {
        __syncthreads();  // gT is written; the previous readers of bT are done
        x.store(bT);
        __syncthreads();
        if (kc + 1 < WALK / KT)
          x.fetch(walk, H, c0 + (kc + 1) * KT, n_walk - c0 - (kc + 1) * KT, h0);
        ffma_tile(gT + kc * KT * LDA, bT, acc2, wr, wc, lane);
      }
      const int h = h0 + 128 * wc + 4 * lane;
      if (h < H) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4* d = reinterpret_cast<float4*>(acc_s + (8 * wr + i) * H + h);
          float4 v = *d;
          v.x += acc2[i][0]; v.y += acc2[i][1]; v.z += acc2[i][2]; v.w += acc2[i][3];
          *d = v;
        }
      }
    }
  }
  __syncthreads();
  const float gs = *gout;  // the upstream scalar (contrastive.py:254)
  for (int idx = threadIdx.x * 4; idx < OWN * H; idx += NT * 4) {
    const int r = idx / H;
    if (r0 + r < n_own) {
      float4 v = *reinterpret_cast<const float4*>(acc_s + idx);
      v.x *= gs; v.y *= gs; v.z *= gs; v.w *= gs;
      *reinterpret_cast<float4*>(out + (size_t)r0 * H + idx) = v;
    }
  }
}

// ---- K4 on the tensor cores: dq (DP = false) and dp (DP = true) -------------------------

constexpr int CL = 4;                // CTAs a cluster: quarters of H
constexpr int TH = 768;              // the H the body takes
constexpr int HQ = TH / CL;          // dims a CTA: 192
constexpr int NA = HQ / 64;          // 64-dim atoms of a quarter
constexpr int ROWS = 64;             // owned rows a cluster (the wgmma M), walked rows a tile
constexpr int WG_THREADS = 128;
constexpr uint32_t ATOM = 64 * 128;  // [64 rows][64 fp16], 128-byte swizzle
constexpr uint32_t PAIR = 2 * NA * ATOM;     // a quarter of 64 rows as hi and lo planes
constexpr uint32_t PART = 32 * 32 * 4;       // a warp's partial scores: 16 rows x 64 columns
constexpr uint32_t RECV = CL * PART;         // a CTA's 16 rows' partials, one from each CTA
constexpr uint32_t GROWS = 16 * 128;         // a CTA's 16 rows of one of g's planes
// owned pair, two walked pairs, two sets of g's planes, two receive buffers, the partials to
// send, and the mbarriers (walk, received partials, received g rows: two each)
constexpr size_t WG_SMEM = 1024 + 3 * PAIR + 2 * 2 * ATOM + 2 * RECV + CL * PART + 8 * 6;
constexpr float G_SCALE = 8192.f;            // 2^13: g (before 1/n_q) in [-1, 1]
// walked tiles whose products one accumulator chain takes: the tensor cores' fp32 sums are
// not rounded to nearest, and their error grows with the chain; every FLUSH tiles (and at
// the end) the chain's sum is added, scaled, to the output (rounded to nearest) and restarts
constexpr int FLUSH = 16;
constexpr int MAX_SPLITS = 16;       // parts of the walked axis, each its own clusters
constexpr size_t PLANES_OFFSET = 256;  // the scratch: two words of magnitudes, then the planes

// the largest |x| of a and of b (n4a, n4b float4s, 16-byte aligned), as float bits, into
// out[0] and out[1] (zeroed before)
__global__ void absmax_kernel(const float4* __restrict__ a, size_t n4a,
                              const float4* __restrict__ b, size_t n4b, unsigned* __restrict__ out) {
  const float4* x = blockIdx.y ? b : a;
  const size_t n = blockIdx.y ? n4b : n4a;
  float m = 0.f;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(x + i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(out + blockIdx.y, __float_as_uint(m));
}

// a (n4a float4s; with gridDim.y = 2 also b) scaled by the power of two of its largest
// magnitude (*amax_a) and split into fp16 planes: hi, then lo, each of a's shape (split.cuh)
__global__ void split_planes_kernel(const float4* __restrict__ a, size_t n4a,
                                    const unsigned* __restrict__ amax_a, uint2* __restrict__ planes_a,
                                    const float4* __restrict__ b, size_t n4b,
                                    const unsigned* __restrict__ amax_b, uint2* __restrict__ planes_b) {
  const float4* x = blockIdx.y ? b : a;
  const size_t n4 = blockIdx.y ? n4b : n4a;
  uint2* planes = blockIdx.y ? planes_b : planes_a;
  const float s = split_pow2(split_exp(__uint_as_float(__ldg(blockIdx.y ? amax_b : amax_a))));
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(x + i);
    uint2 h, l;
    split2(v.x * s, v.y * s, h.x, l.x);
    split2(v.z * s, v.w * s, h.y, l.y);
    planes[i] = h;
    planes[n4 + i] = l;
  }
}

// out = the sum of `splits` partial gradients (ws: [splits][n4] float4s), in split order
__global__ void sum_splits_kernel(const float4* __restrict__ ws, int splits, size_t n4,
                                  float4* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = __ldg(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 p = __ldg(ws + s * n4 + i);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    out[i] = v;
  }
}

// Chunk k (of 12) of a thread's share of the owned rows' quarter: 8 floats, row r, dims h ..
// h + 7 of the quarter (a warp reads 8 rows x 128 bytes); its 16-byte chunk in a pair of
// planes is atom h / 64, chunk (h % 64) / 8 of the row, swizzled.
__device__ __forceinline__ void quarter_chunk(int k, int& r, int& h) {
  const int idx = threadIdx.x + WG_THREADS * k, b = idx >> 8, w = idx & 255;
  r = w >> 2;
  h = 32 * b + 8 * (w & 3);
}
__device__ __forceinline__ uint32_t plane_chunk(int r, int h) {
  return (uint32_t)(h >> 6) * ATOM + (uint32_t)r * 128 + ((((h & 63) >> 3) ^ (r & 7)) << 4);
}

// own: the side whose gradient this computes ([n_own, H] fp32: q for dq, p for dp); walk: the
// other side, as fp16 planes read by TMA (tmw: [2][n_walk][H], hi then lo; boxes of 64 dims x
// 64 rows, 128-byte swizzle). lse is indexed by query; amax: the largest |q| and |p| as float
// bits. A cluster takes owned tile c / splits and walked tiles [s tps, (s + 1) tps) of split
// s = c % splits; its sum goes to out (one split) or to ws[s] ([splits][n_own][H]).
// out = gout * sum over walked rows of g . walk.
template <bool DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
contrastive_bwd_wgmma(const __grid_constant__ CUtensorMap tmw, const float* __restrict__ own,
                      const float* __restrict__ lse, const float* __restrict__ gout,
                      const unsigned* __restrict__ amax, float* __restrict__ out,
                      float* __restrict__ ws, int n_own, int n_walk, int stride, int n_q,
                      int splits, int tps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* g_base = smem_raw + (base - smem_addr(smem_raw));
  // pairs [0]: the owned rows' quarter; [1 + b]: walked tile buffer b (each hi then lo planes);
  // then g's planes [b] (hi, lo: [64 owned][64 walked], K-major), the received partials [b]
  // ([CL][8][32] float4: from each CTA, this CTA's 16 rows in a warp's accumulator layout),
  // the partials to send ([CL][8][32] float4: warp w's rows, for CTA w), and the mbarriers
  const uint32_t s_pairs = base, s_g0 = base + 3 * PAIR, s_recv0 = s_g0 + 4 * ATOM;
  const uint32_t s_send = s_recv0 + 2 * RECV, s_bars = s_send + CL * PART;
  unsigned char* g_g0 = g_base + 3 * PAIR;
  const float4* recv0 = reinterpret_cast<const float4*>(g_g0 + 4 * ATOM);
  float4* send = reinterpret_cast<float4*>(g_g0 + 4 * ATOM + 2 * RECV);
  auto bar_walk = [&](int b) { return s_bars + 8u * b; };
  auto bar_part = [&](int b) { return s_bars + 8u * (2 + b); };  // received partials
  auto bar_g = [&](int b) { return s_bars + 8u * (4 + b); };     // received rows of g

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const unsigned rank = cluster_rank();
  const int cl = blockIdx.x / CL, split = cl % splits;
  const int r0 = (cl / splits) * ROWS, hq0 = rank * HQ;
  const int t_begin = split * tps, t_end = min((split + 1) * tps, (n_walk + ROWS - 1) / ROWS);
  const int e_own = split_exp(__uint_as_float(__ldg(amax + (DP ? 1 : 0))));
  const int e_walk = split_exp(__uint_as_float(__ldg(amax + (DP ? 0 : 1))));
  const float unscale = split_pow2(-e_own - e_walk);
  const float out_f = __ldg(gout) / ((float)n_q * G_SCALE * split_pow2(e_walk));
  float* dst_base = splits > 1 ? ws + (size_t)split * n_own * TH : out;

  if (tid == 0) {
    for (int b = 0; b < 6; ++b) mbar_init(s_bars + 8u * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's mbarriers are initialized before any copy completes on them
  // thread 0: a walked tile's quarter (rows from `row`, both planes) into buffer b
  auto load_walk = [&](int row, int b) {
    const uint32_t dst = s_pairs + (1 + b) * PAIR;
    mbar_expect_tx(bar_walk(b), PAIR);
    for (int h = 0; h < 2; ++h)
      for (int a = 0; a < NA; ++a)
        tma_load_3d(dst + (h * NA + a) * ATOM, &tmw, hq0 + 64 * a, row, h, bar_walk(b));
  };
  if (tid == 0 && t_begin < t_end) load_walk(t_begin * ROWS, 0);
  // the owned rows' quarter, scaled and split (rows past n_own: zeros)
  {
    const float s_own = split_pow2(e_own);
    for (int k = 0; k < ROWS * HQ / 8 / WG_THREADS; ++k) {
      int r, h;
      quarter_chunk(k, r, h);
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
      if (r0 + r < n_own) {
        const float4* src = reinterpret_cast<const float4*>(own + (size_t)(r0 + r) * TH + hq0 + h);
        x0 = __ldg(src);
        x1 = __ldg(src + 1);
      }
      uint4 vh, vl;
      split2(x0.x * s_own, x0.y * s_own, vh.x, vl.x);
      split2(x0.z * s_own, x0.w * s_own, vh.y, vl.y);
      split2(x1.x * s_own, x1.y * s_own, vh.z, vl.z);
      split2(x1.z * s_own, x1.w * s_own, vh.w, vl.w);
      *reinterpret_cast<uint4*>(g_base + plane_chunk(r, h)) = vh;
      *reinterpret_cast<uint4*>(g_base + NA * ATOM + plane_chunk(r, h)) = vl;
    }
  }
  fence_proxy_async();
  __syncthreads();
  // lse of the CTA's 16 rows of g (dq: owned queries 16 rank + g and + 8)
  float lse_own[2] = {0.f, 0.f};
  if (!DP)
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * rank + g + 8 * i;
      lse_own[i] = row < n_own ? __ldg(lse + row) : 0.f;
    }

  float acc[96];  // the gradient quarter: row 16 w + g (+ 8), column 8 n + 2 t4 + e
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k = tile - t_begin, buf = k & 1, w0 = tile * ROWS;
    const unsigned par = (k >> 1) & 1;
    const uint32_t s_wp = s_pairs + (1 + buf) * PAIR, s_g = s_g0 + buf * 2 * ATOM;
    const uint32_t s_recv = s_recv0 + buf * RECV;
    unsigned char* g_g = g_g0 + buf * 2 * ATOM;
    const float4* recv = recv0 + buf * (RECV / 16);
    if (tid == 0) {  // this tile's partials (4 x 16 rows) and other CTAs' rows of g to come
      mbar_expect_tx(bar_part(buf), RECV);
      mbar_expect_tx(bar_g(buf), (CL - 1) * 2 * GROWS);
    }
    mbar_wait(bar_walk(buf), par);

    // partial scores over the quarter: owned rows (M) x walked rows (N)
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = a * ATOM + kk * 32;
        const uint64_t oh = sw128_desc(s_pairs + off, 16);
        const uint64_t ol = sw128_desc(s_pairs + NA * ATOM + off, 16);
        const uint64_t wh = sw128_desc(s_wp + off, 16), wl = sw128_desc(s_wp + NA * ATOM + off, 16);
        wgmma_f16_ss_n64(s, oh, wh, a > 0 || kk > 0);
        wgmma_f16_ss_n64(s, oh, wl, 1);
        wgmma_f16_ss_n64(s, ol, wh, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();  // also the previous tile's gradient products: its buffers are free
    fence_regs(s);
    fence_regs(acc);
    if (tid == 0 && tile + 1 < t_end) load_walk(w0 + ROWS, buf ^ 1);
    // reduce-scatter: warp w's rows (16 w ..) of this partial, unscaled, to CTA w's receive
    // buffer, slot `rank`, by bulk copies (thread 0 issues every copy of the CTA, and waits
    // here until the earlier ones have read their sources: `send`, and g's rows two tiles
    // back, may be rewritten)
    if (tid == 0) bulk_wait_read();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      send[(warp * 8 + j) * 32 + lane] =
          make_float4(s[4 * j] * unscale, s[4 * j + 1] * unscale, s[4 * j + 2] * unscale,
                      s[4 * j + 3] * unscale);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < CL; ++w)
        bulk_copy_cluster(s_recv + rank * PART, s_send + w * PART, PART, bar_part(buf), w);
      bulk_commit();
    }
    mbar_wait(bar_part(buf), par);
    // the CTA's 16 rows of g (rows 16 rank + g, + 8), warp w its columns 16 w .. 16 w + 15
    // (n8 tiles 2 w, 2 w + 1): the four partials summed in rank order, g x 2^13 (rows and
    // columns past the ends: 0, no branch: the exponentials' latencies overlap), hi and lo
    // into this CTA's planes (its rows 16 rank ..)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * warp + jj;
      float4 p = recv[j * 32 + lane];
#pragma unroll
      for (int c = 1; c < CL; ++c) {
        const float4 o = recv[(c * 8 + j) * 32 + lane];
        p.x += o.x;
        p.y += o.y;
        p.z += o.z;
        p.w += o.w;
      }
      const float sv[4] = {p.x, p.y, p.z, p.w};
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 16 * rank + g + 8 * (i >> 1), col = w0 + 8 * j + 2 * t4 + (i & 1);
        const int qi = DP ? col : row, pj = DP ? row : col;
        const float l = DP ? __ldg(lse + min(col, n_walk - 1)) : lse_own[i >> 1];
        const float e = (expf(sv[i] - l) - ((long long)pj == (long long)qi * stride ? 1.f : 0.f)) *
                        G_SCALE;
        v[i] = row < n_own && col < n_walk ? e : 0.f;
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = 16 * rank + g + 8 * ri, b = 2 * (8 * j + 2 * t4);
        const uint32_t o = r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
        unsigned hi, lo;
        split2(v[2 * ri], v[2 * ri + 1], hi, lo);
        *reinterpret_cast<unsigned*>(g_g + o) = hi;
        *reinterpret_cast<unsigned*>(g_g + ATOM + o) = lo;
      }
    }
    fence_proxy_async();
    __syncthreads();  // this CTA's rows of g are written
    if (tid == 0) {  // all-gather: its rows of each plane to the other CTAs
      for (int c = 1; c < CL; ++c)
        for (int h = 0; h < 2; ++h) {
          const uint32_t rows = s_g + h * ATOM + 16 * rank * 128;
          bulk_copy_cluster(rows, rows, GROWS, bar_g(buf), (rank + c) % CL);
        }
      bulk_commit();
    }
    mbar_wait(bar_g(buf), par);  // the other CTAs' rows of g have arrived

    // the gradient quarter += g . walked tile (K: the walked rows, N: the quarter's dims)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t gh = sw128_desc(s_g + kk * 32, 16), gl = sw128_desc(s_g + ATOM + kk * 32, 16);
      const uint64_t wh = sw128_desc(s_wp + kk * 2048, ATOM);
      const uint64_t wl = sw128_desc(s_wp + NA * ATOM + kk * 2048, ATOM);
      wgmma_f16_ss_n192_mn(acc, gh, wh, 1);
      wgmma_f16_ss_n192_mn(acc, gh, wl, 1);
      wgmma_f16_ss_n192_mn(acc, gl, wh, 1);
    }
    wgmma_commit();
    if (k % FLUSH == FLUSH - 1 || tile == t_end - 1) {  // the chain's sum into the output
      wgmma_wait<0>();
      fence_regs(acc);
      const bool first = k < FLUSH;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 16 * warp + g + 8 * i;
        if (row >= n_own) continue;
        float2* dst = reinterpret_cast<float2*>(dst_base + (size_t)row * TH + hq0 + 2 * t4);
#pragma unroll
        for (int n = 0; n < 24; ++n) {
          const float2 o = first ? make_float2(0.f, 0.f) : dst[4 * n];
          dst[4 * n] = make_float2(fmaf(acc[4 * n + 2 * i], out_f, o.x),
                                   fmaf(acc[4 * n + 2 * i + 1], out_f, o.y));
        }
      }
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    }
  }
  if (t_begin >= t_end) {  // an empty split: its part of the sum is 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * warp + g + 8 * i;
      if (row >= n_own) continue;
      float2* dst = reinterpret_cast<float2*>(dst_base + (size_t)row * TH + hq0 + 2 * t4);
#pragma unroll
      for (int n = 0; n < 24; ++n) dst[4 * n] = make_float2(0.f, 0.f);
    }
  }
  if (tid == 0) bulk_wait_read();
  cluster_sync();  // no CTA leaves while copies into it, or of its rows, are in flight
}

// 1 where the tensor-core body takes the shape: H = 768, 16-byte aligned rows
bool takes_wgmma(int H, const void* a, const void* b) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return H == TH && (ptrs & 15) == 0;
}

// How many clusters of the tensor-core body the card holds at once (queried once): 0, or the
// query's error
int cluster_slots(int* slots) {
  static int cached = 0;
  if (cached == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = WG_SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(contrastive_bwd_wgmma<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)WG_SMEM);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, contrastive_bwd_wgmma<false>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;  // no cluster fits on the card
    cached = n;
  }
  *slots = cached;
  return 0;
}

// The parts of the walked axis: the fewest that minimize the time in walked-tile steps, the
// waves of clusters times the tiles a cluster takes (so a small call spreads over several
// clusters, and a large one fills its last wave), plus, where split, the parts' sums written
// and read again (a tile step about 3.2 us on the H100, device memory 3 TB/s). Returns 0, or
// the occupancy query's error.
int choose_splits(int n_own, int n_walk, int* splits) {
  const int own_tiles = (n_own + ROWS - 1) / ROWS, tiles = (n_walk + ROWS - 1) / ROWS;
  int n_slots = 0;
  if (int err = cluster_slots(&n_slots)) return err;
  const long long slots = n_slots;
  constexpr double TILE_S = 3.2e-6, BYTES_S = 3e12;
  int best = 1;
  double best_cost = 0.0;
  for (int s = 1; s <= MAX_SPLITS && s <= tiles; ++s) {
    const long long waves = ((long long)own_tiles * s + slots - 1) / slots;
    double cost = (double)(waves * ((tiles + s - 1) / s));
    if (s > 1) cost += (double)s * n_own * TH * 8 / BYTES_S / TILE_S;
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  *splits = best;
  return 0;
}

size_t scratch_bytes(int n_own, int n_walk, int splits) {
  return PLANES_OFFSET + (size_t)n_walk * TH * 4 + (splits > 1 ? (size_t)splits * n_own * TH * 4 : 0);
}

template <bool DP>
int launch_bwd_wgmma(const void* q, const void* p, const void* lse, const void* gout,
                     unsigned char* scratch, void* out, int Q, int P, int stride,
                     cudaStream_t stream) {
  const int n_own = DP ? P : Q, n_walk = DP ? Q : P;
  int splits = 1;
  if (int e = choose_splits(n_own, n_walk, &splits)) return e;
  const int tps = ((n_walk + ROWS - 1) / ROWS + splits - 1) / splits;
  unsigned* amax = reinterpret_cast<unsigned*>(scratch);
  unsigned char* planes = scratch + PLANES_OFFSET;  // the walked side's hi, then lo
  float* ws = reinterpret_cast<float*>(planes + (size_t)n_walk * TH * 4);
  cudaError_t err = cudaMemsetAsync(amax, 0, 2 * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n4q = (size_t)Q * TH / 4, n4p = (size_t)P * TH / 4, n4w = DP ? n4q : n4p;
  auto blocks = [](size_t n4) { return (unsigned)(n4 / 256 + 1 < 528 ? n4 / 256 + 1 : 528); };
  const dim3 amax_grid(blocks(n4q > n4p ? n4q : n4p), 2);
  absmax_kernel<<<amax_grid, 256, 0, stream>>>(static_cast<const float4*>(q), n4q,
                                               static_cast<const float4*>(p), n4p, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned split_grid = blocks(n4w);
  split_planes_kernel<<<split_grid, 256, 0, stream>>>(
      static_cast<const float4*>(DP ? q : p), n4w, amax + (DP ? 0 : 1),
      reinterpret_cast<uint2*>(planes), nullptr, 0, nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  CUtensorMap tmw;
  const cuuint64_t dims[3] = {(cuuint64_t)TH, (cuuint64_t)n_walk, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)TH * 2, (cuuint64_t)n_walk * TH * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)ROWS, 1};
  if (int e = tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, planes, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  auto kernel = contrastive_bwd_wgmma<DP>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)WG_SMEM)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * splits * ((n_own + ROWS - 1) / ROWS));
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WG_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmw, static_cast<const float*>(DP ? p : q),
                           static_cast<const float*>(lse), static_cast<const float*>(gout),
                           static_cast<const unsigned*>(amax), static_cast<float*>(out), ws,
                           n_own, n_walk, stride, Q, splits, tps);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t n4o = (size_t)n_own * TH / 4;
    const unsigned sum_grid = blocks(n4o);
    sum_splits_kernel<<<sum_grid, 256, 0, stream>>>(reinterpret_cast<const float4*>(ws), splits,
                                                    n4o, static_cast<float4*>(out));
    return (int)cudaGetLastError();
  }
  return 0;
}

// ---- K3 on the tensor cores -------------------------------------------------------------

constexpr int FT = 128;                // query rows a CTA (two warpgroups of 64), walked rows a tile
constexpr uint32_t FTILE = FT * 128;   // a 64-dim slice of 128 rows of one fp16 plane (16 KB)
constexpr uint32_t FSTAGE = 4 * FTILE; // a ring stage: the slice of q's hi, lo, p's hi, lo planes
constexpr int FWD_NST = 3;             // ring stages
constexpr int FWD_THREADS = 2 * WG_THREADS + 32;  // two consumer warpgroups, one producer warp
// the ring, the full and empty mbarriers, and the last-part flag
constexpr size_t FWD_SMEM = 1024 + FWD_NST * FSTAGE + 8 * 2 * FWD_NST + 16;
constexpr int FWD_MAX_PARTS = 16;      // parts of the walked axis

__device__ __forceinline__ void consumers_sync_all() {  // both consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The scratch's header: the largest |q| and |p| (two words), then a counter a query tile of the
// parts that have written their partials; zeroed before the call.
size_t fwd_header_bytes(int q_tiles) { return ((size_t)16 + 4 * (size_t)q_tiles + 255) & ~(size_t)255; }

// q and p as fp16 planes (tmq: [2][Q][H], tmp: [2][P][H], hi then lo; boxes of 64 dims x 128
// rows, 128-byte swizzle, rows past the end as zeros); amax: their largest magnitudes as float
// bits. CTA b takes query tile b % q_tiles and walked tiles [s tpp, (s + 1) tpp) of part
// s = b / q_tiles (part-major: a part's CTAs walk the same tiles together). Per row it keeps the
// running max m, sum of exp(s - m) l and target score t of its part; with one part it writes
// lse = log l + m and tgt = t, else (m, l, t) to ws ([3][parts][Q]) and the part that finishes
// last (counters) merges the parts in part order.
__global__ void __launch_bounds__(FWD_THREADS, 1)
contrastive_fwd_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmp,
                      const unsigned* __restrict__ amax, unsigned* __restrict__ counters,
                      float* __restrict__ ws, float* __restrict__ lse, float* __restrict__ tgt,
                      int Q, int P, int H, int stride, int parts, int tpp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + FWD_NST * FSTAGE;
  int* last_flag = reinterpret_cast<int*>(smem_raw + (bars - smem_addr(smem_raw)) + 16 * FWD_NST);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (FWD_NST + s); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_tiles = (Q + FT - 1) / FT, part = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int q0 = qt * FT, NS = H / 64;
  const int t_begin = part * tpp, t_end = min(t_begin + tpp, (P + FT - 1) / FT);
  if (tid == 0) {
    for (int s = 0; s < FWD_NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer: each walked tile's stages in turn, q's slice beside p's
    if (lane == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int j = 0; j < NS; ++j) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), FSTAGE);
          const uint32_t dst = ring + stage * FSTAGE;
          for (int h = 0; h < 2; ++h) {
            tma_load_3d(dst + h * FTILE, &tmq, 64 * j, q0, h, full(stage));
            tma_load_3d(dst + (2 + h) * FTILE, &tmp, 64 * j, t * FT, h, full(stage));
          }
          if (++stage == FWD_NST) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // warpgroup wg: query rows q0 + 64 wg + 16 w + g (+ 8); a warpgroup with no real row only
  // passes the stages on
  const int wg = warp >> 2, wwarp = warp & 3, g = lane >> 2, t4 = lane & 3;
  // the planes' scales, taken out by two exact multiplies (their product may leave 2^+-126)
  const float unscale_q = split_pow2(-split_exp(__uint_as_float(__ldg(amax))));
  const float unscale_p = split_pow2(-split_exp(__uint_as_float(__ldg(amax + 1))));
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tv[2] = {0.f, 0.f};
  int stage = 0;
  unsigned phase = 0;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };
  auto next_stage = [&]() {
    if (++stage == FWD_NST) {
      stage = 0;
      phase ^= 1;
    }
  };
  if (q0 + 64 * wg < Q) {
    float acc[64], tot[64];
    for (int t = t_begin; t < t_end; ++t) {
      for (int j = 0; j < NS; ++j) {
        mbar_wait(full(stage), phase);
        const uint32_t st = ring + stage * FSTAGE;
        const uint32_t qh = st + wg * 64 * 128, ql = qh + FTILE;
        const uint32_t ph = st + 2 * FTILE, pl = st + 3 * FTILE;
        // the stage's small products (hi.lo, lo.hi) first: the tensor cores truncate each sum,
        // and a truncation of the running sum costs up to an ulp of it, so only the four
        // hi.hi products, added last, truncate at the stage sum's magnitude
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t o = kk * 32;
          wgmma_f16_ss_n128(acc, sw128_desc(qh + o, 16), sw128_desc(pl + o, 16), kk > 0);
          wgmma_f16_ss_n128(acc, sw128_desc(ql + o, 16), sw128_desc(ph + o, 16), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_f16_ss_n128(acc, sw128_desc(qh + kk * 32, 16), sw128_desc(ph + kk * 32, 16), 1);
        wgmma_commit();
        // the stage's sum into the fp32 total (one rounding a stage: a chain over all of H,
        // its sums truncated, was 3-8x the FFMA body's error, PERF.md)
        wgmma_wait<0>();
        fence_regs(acc);
        release(stage);
        next_stage();
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) tot[i] = acc[i];
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) tot[i] += acc[i];
        }
      }
      // the tile's scores: tot[4 n + 2 i + e] at row g + 8 i, column c0 + 8 n + 2 t4 + e;
      // columns >= P masked; per row the quad's max, then the running sum rescaled and this
      // tile's exponentials added; the target score where the tile holds it
      const int c0 = t * FT;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * n + 2 * i + e;
            tot[k] = c0 + 8 * n + 2 * t4 + e < P ? tot[k] * unscale_q * unscale_p : -INFINITY;
            mx = fmaxf(mx, tot[k]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[i], mx);  // finite: the tile's first column is real
        float sum = l[i] * expf(m[i] - mn);
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += expf(tot[4 * n + 2 * i + e] - mn);
        l[i] = sum;
        m[i] = mn;
        const long long row = q0 + 64 * wg + 16 * wwarp + g + 8 * i;
        const long long col = row * stride;
        if (row < Q && col >= c0 && col < c0 + FT && col < P && ((col >> 1) & 3) == t4) {
          const int n_t = (int)(col - c0) >> 3, e_t = (int)col & 1;
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n == n_t && e == e_t) tv[i] += tot[4 * n + 2 * i + e];
        }
      }
    }
  } else {
    for (int t = t_begin; t < t_end; ++t)
      for (int j = 0; j < NS; ++j) {
        mbar_wait(full(stage), phase);
        release(stage);
        next_stage();
      }
  }

  // the quad's sums (its m is shared), by the thread of t4 = 0
  float* ws_m = ws;
  float* ws_l = ws + (size_t)parts * Q;
  float* ws_t = ws + 2 * (size_t)parts * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float L = l[i], T = tv[i];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      L += __shfl_xor_sync(0xffffffffu, L, o);
      T += __shfl_xor_sync(0xffffffffu, T, o);
    }
    const int row = q0 + 64 * wg + 16 * wwarp + g + 8 * i;
    if (t4 == 0 && row < Q) {
      if (parts == 1) {
        lse[row] = logf(L) + m[i];
        tgt[row] = T;
      } else {
        ws_m[(size_t)part * Q + row] = m[i];
        ws_l[(size_t)part * Q + row] = L;
        ws_t[(size_t)part * Q + row] = T;
      }
    }
  }
  if (parts == 1) return;
  // the last part of this query tile to finish merges every part's rows, in part order
  __threadfence();
  consumers_sync_all();
  if (tid == 0) *last_flag = atomicAdd(counters + qt, 1u) == (unsigned)parts - 1;
  consumers_sync_all();
  if (!*last_flag) return;
  __threadfence();
  const int row = q0 + tid;
  if (tid >= FT || row >= Q) return;
  float M = -INFINITY;
  for (int s = 0; s < parts; ++s) M = fmaxf(M, __ldcg(ws_m + (size_t)s * Q + row));
  float L = 0.f, T = 0.f;
  for (int s = 0; s < parts; ++s) {
    const float ms = __ldcg(ws_m + (size_t)s * Q + row);
    if (ms != -INFINITY) L += __ldcg(ws_l + (size_t)s * Q + row) * expf(ms - M);
    T += __ldcg(ws_t + (size_t)s * Q + row);
  }
  lse[row] = logf(L) + M;
  tgt[row] = T;
}

// 1 where K3's tensor-core body takes the shape: H % 64 == 0, 16-byte aligned rows
bool fwd_takes_wgmma(int H, const void* a, const void* b) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return H >= 64 && H % 64 == 0 && (ptrs & 15) == 0;
}

// The parts of K3's walked axis: the fewest that minimize the waves of CTAs (one an SM) times
// the walked tiles a CTA takes; *tpp the tiles a part. Returns 0, or the SM count query's error.
int fwd_parts(int Q, int P, int* parts, int* tpp) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    sms = n;
  }
  const long long q_tiles = (Q + FT - 1) / FT, tiles = (P + FT - 1) / FT;
  long long best_cost = -1;
  for (int s = 1; s <= FWD_MAX_PARTS && s <= tiles; ++s) {
    const long long per = (tiles + s - 1) / s, used = (tiles + per - 1) / per;
    const long long cost = ((q_tiles * used + sms - 1) / sms) * per;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *parts = (int)used;
      *tpp = (int)per;
    }
  }
  return 0;
}

size_t fwd_scratch_bytes(int Q, int P, int H, int parts) {
  return fwd_header_bytes((Q + FT - 1) / FT) + (size_t)(Q + P) * H * 4 +
         (parts > 1 ? (size_t)3 * parts * Q * 4 : 0);
}

int launch_fwd_wgmma(const void* q, const void* p, void* lse, void* tgt, int Q, int P, int H,
                     int stride, unsigned char* scratch, cudaStream_t stream) {
  int parts = 1, tpp = 1;
  if (int e = fwd_parts(Q, P, &parts, &tpp)) return e;
  const int q_tiles = (Q + FT - 1) / FT;
  const size_t header = fwd_header_bytes(q_tiles);
  unsigned* amax = reinterpret_cast<unsigned*>(scratch);
  unsigned* counters = amax + 4;
  unsigned char* planes_q = scratch + header;
  unsigned char* planes_p = planes_q + (size_t)Q * H * 4;
  float* ws = reinterpret_cast<float*>(planes_p + (size_t)P * H * 4);
  cudaError_t err = cudaMemsetAsync(scratch, 0, header, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n4q = (size_t)Q * H / 4, n4p = (size_t)P * H / 4;
  auto blocks = [](size_t n4) { return (unsigned)(n4 / 256 + 1 < 528 ? n4 / 256 + 1 : 528); };
  const dim3 grid2(blocks(n4q > n4p ? n4q : n4p), 2);
  absmax_kernel<<<grid2, 256, 0, stream>>>(static_cast<const float4*>(q), n4q,
                                           static_cast<const float4*>(p), n4p, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  split_planes_kernel<<<grid2, 256, 0, stream>>>(
      static_cast<const float4*>(q), n4q, amax, reinterpret_cast<uint2*>(planes_q),
      static_cast<const float4*>(p), n4p, amax + 1, reinterpret_cast<uint2*>(planes_p));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  CUtensorMap tmq, tmp;
  const cuuint32_t box[3] = {64, (cuuint32_t)FT, 1};
  for (int side = 0; side < 2; ++side) {
    const cuuint64_t rows = side ? P : Q;
    const cuuint64_t dims[3] = {(cuuint64_t)H, rows, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)H * 2, rows * H * 2};
    if (int e = tensor_map(side ? &tmp : &tmq, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                           side ? planes_p : planes_q, 3, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
  }
  if ((err = cudaFuncSetAttribute(contrastive_fwd_wgmma,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM)) !=
      cudaSuccess)
    return (int)err;
  contrastive_fwd_wgmma<<<q_tiles * parts, FWD_THREADS, FWD_SMEM, stream>>>(
      tmq, tmp, amax, counters, ws, static_cast<float*>(lse), static_cast<float*>(tgt), Q, P, H,
      stride, parts, tpp);
  return (int)cudaGetLastError();
}

// What every entry checks: fp32 rows of H % 4 == 0 floats, 16-byte aligned, that fit.
bool takes(int n_rows_a, int n_rows_b, int H, const void* a, const void* b) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return n_rows_a > 0 && n_rows_b > 0 && H > 0 && H % 4 == 0 && (ptrs & 15) == 0 &&
         fwd_smem_bytes(H) <= SMEM_MAX && bwd_smem_bytes(H) <= SMEM_MAX;
}

// K4: the tensor-core body where it takes the shape (scratch of
// drt_contrastive_scratch_bytes: the operands' largest magnitudes and fp16 planes; *body = 1),
// else the FFMA body (*body = 0)
template <bool DP>
int launch_bwd(const void* q, const void* p, const void* lse, const void* gout, void* out, int Q,
               int P, int H, int stride, void* scratch, int* body, cudaStream_t stream) {
  if (body != nullptr) *body = 0;
  if (!takes(Q, P, H, q, p) || stride < 1) return (int)cudaErrorInvalidValue;
  if (scratch != nullptr && takes_wgmma(H, q, p)) {
    if (body != nullptr) *body = 1;
    return launch_bwd_wgmma<DP>(q, p, lse, gout, static_cast<unsigned char*>(scratch), out, Q,
                                P, stride, stream);
  }
  const size_t smem = bwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(contrastive_bwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_own = DP ? P : Q, n_walk = DP ? Q : P;
  contrastive_bwd_kernel<DP><<<(n_own + OWN - 1) / OWN, NT, smem, stream>>>(
      static_cast<const float*>(DP ? p : q), static_cast<const float*>(DP ? q : p),
      static_cast<const float*>(lse), static_cast<const float*>(gout), static_cast<float*>(out),
      n_own, n_walk, H, stride, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// The parts K3's tensor-core body splits the walked axis into at this shape: 0 where the FFMA
// body runs it, minus a cudaError_t where the card's SM count could not be read.
extern "C" int drt_contrastive_fwd_parts(int Q, int P, int H) {
  if (H < 64 || H % 64 != 0 || Q < 1 || P < 1) return 0;
  int parts = 0, tpp = 0;
  if (int err = fwd_parts(Q, P, &parts, &tpp)) return -err;
  return parts;
}

// The scratch bytes K3's tensor-core body needs at this shape (0: the FFMA body runs it; minus
// a cudaError_t as drt_contrastive_fwd_parts): the operands' largest magnitudes and a counter a
// 128-row query tile, q and p as fp16 hi and lo planes ((Q + P) x H x 4 bytes), and where the
// walked axis is split, each part's (max, sum, target) a row.
extern "C" long long drt_contrastive_fwd_scratch_bytes(int Q, int P, int H) {
  const int parts = drt_contrastive_fwd_parts(Q, P, H);
  if (parts <= 0) return parts;
  return (long long)fwd_scratch_bytes(Q, P, H, parts);
}

// K3: lse[Q] and tgt[Q] of fp32 q [Q, H] against fp32 p [P, H]; target of row r is r * stride.
// scratch: drt_contrastive_fwd_scratch_bytes(Q, P, H) bytes, 16-byte aligned, for the
// tensor-core body (null: the FFMA body); `body`, where not null, is set to 1 where the
// tensor-core body ran, else 0.
extern "C" int drt_contrastive_fwd(const void* q, const void* p, void* lse, void* tgt, int Q,
                                   int P, int H, int stride, void* scratch, int* body,
                                   void* stream) {
  if (body != nullptr) *body = 0;
  if (!takes(Q, P, H, q, p) || stride < 1) return (int)cudaErrorInvalidValue;
  if (scratch != nullptr && fwd_takes_wgmma(H, q, p)) {
    if (body != nullptr) *body = 1;
    return launch_fwd_wgmma(q, p, lse, tgt, Q, P, H, stride, static_cast<unsigned char*>(scratch),
                            static_cast<cudaStream_t>(stream));
  }
  const size_t smem = fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(contrastive_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contrastive_fwd_kernel<<<(Q + OWN - 1) / OWN, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), static_cast<float*>(lse),
      static_cast<float*>(tgt), Q, P, H, stride);
  return (int)cudaGetLastError();
}

// The parts the tensor-core body splits the walked axis of dq (dp = 0) or dp (1) into at this
// shape: 0 where the FFMA body runs it, minus a cudaError_t where the card's cluster
// occupancy could not be read.
extern "C" int drt_contrastive_splits(int Q, int P, int H, int dp) {
  if (H != TH || Q < 1 || P < 1) return 0;
  int splits = 0;
  if (int err = choose_splits(dp ? P : Q, dp ? Q : P, &splits)) return -err;
  return splits;
}

// The scratch bytes K4's tensor-core body needs for dq (dp = 0) or dp (1) at this shape (0:
// the FFMA body runs it; minus a cudaError_t as drt_contrastive_splits): the operands' largest
// magnitudes, the walked side as fp16 hi and lo planes (its rows x H x 4 bytes), and where the
// walked axis is split, the parts' sums.
extern "C" long long drt_contrastive_scratch_bytes(int Q, int P, int H, int dp) {
  const int splits = drt_contrastive_splits(Q, P, H, dp);
  if (splits <= 0) return splits;
  return (long long)scratch_bytes(dp ? P : Q, dp ? Q : P, splits);
}

// K4: dq [Q, H] (dp [P, H]) = gout * g . p (g^T . q), g recomputed from q, p and lse [Q].
// scratch: drt_contrastive_scratch_bytes(Q, P, H) bytes, 16-byte aligned, for the tensor-core
// body (null: the FFMA body); `body`, where not null, is set to 1 where the tensor-core body
// ran, else 0.
extern "C" int drt_contrastive_dq(const void* q, const void* p, const void* lse, const void* gout,
                                  void* dq, int Q, int P, int H, int stride, void* scratch,
                                  int* body, void* stream) {
  return launch_bwd<false>(q, p, lse, gout, dq, Q, P, H, stride, scratch, body,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int drt_contrastive_dp(const void* q, const void* p, const void* lse, const void* gout,
                                  void* dp, int Q, int P, int H, int stride, void* scratch,
                                  int* body, void* stream) {
  return launch_bwd<true>(q, p, lse, gout, dp, Q, P, H, stride, scratch, body,
                          static_cast<cudaStream_t>(stream));
}

// The widest H (a multiple of 4) the entries take: the FFMA bodies, which every shape may
// run, keep K3's 32 query rows and K4's [32, H] accumulator in shared memory.
extern "C" int drt_contrastive_max_h() {
  int H = 0;
  while (fwd_smem_bytes(H + 4) <= SMEM_MAX && bwd_smem_bytes(H + 4) <= SMEM_MAX) H += 4;
  return H;
}
