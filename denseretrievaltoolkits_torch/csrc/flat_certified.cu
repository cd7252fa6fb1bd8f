// K5 on Hopper: the certified exact top-J of fp32 or bf16 queries against rows of their own
// dtype, products on wgmma.
//
// Replaces, at the shapes drt_flat_certified_takes accepts, this TPU kernel of
// denseretrievaltoolkits_tpu/ops/topk.py:
//   K5 `_block_topj_kernel` (:37, launched by `_pallas_block_topj`, :336): exact top-J over
//       fp32 rows (Precision.HIGHEST, :324-327) or bf16 rows.
// block_topj.cu's bodies run the other shapes (drt_block_topj dispatches by shape).
//
// What it computes: for each (query, storage block of `block` rows) the J best (score, id)
// pairs, score = q . c, ties to the smaller id, rows >= n_valid masked, an empty entry (-inf,
// -1); output [Q, n_blocks, J]. A -0 score becomes +0: the certified order treats the two as
// equal, the packed key of the selection would not.
//
// What bounds it on the H100 (1M rows x 768, 1024 queries): bf16, the products, 2 Q N H at
// 989 TFLOP/s (1.59 ms), and the rows, which stream from L2 once per 64-query tile (24.6
// GB); fp32, three fp16 products a pair (split.cuh), 3 x 2 Q N H at 989 TFLOP/s (4.77 ms;
// FFMA products would take 23.48 ms at 67 TFLOP/s, TF32 pairs 9.76 at 495), and 49 GB of rows
// from L2.
//
// Design: one CTA a (64-query tile, storage block); rows are the wgmma's M, queries its N,
// 64 rows a tile. Each tile's scores go to a score tile [query][row] (pitch 68: the
// accumulators' stores and the rows' reads take the fewest wavefronts), then
// int4_certified.cu's selection (K10): two threads own a query, each half the tile's rows,
// with its own sorted list of packed keys (serve_select.cuh's key, whose order is the
// certified order once -0 is +0); a tile's rows past the list's J-th score at the tile's
// start are marked in a bitmask and only they reach the register insertion; the two lists
// merge at the end of the block. The bf16 body keeps the lists in registers for the whole
// block (8 keys for J <= 8, the certified search's J; 32 for the escalation's J = 32); the
// fp32 body, whose registers hold its row slices, keeps them in shared memory, and for J > 8
// one thread owns a query, every row, a list of 32 keys.
// - bf16 (`flat_bf16_wgmma`): one consumer warpgroup and one producer warp. The producer
//   brings the query tile once by TMA (the B operand, resident: 96 KB at H = 768) and then each
//   row tile's 64-dim slices (8 KB, 128-byte swizzle) into a ring of up to 12 mbarrier stages.
//   m64n64k16 SS wgmma; a stage is released once the next slice's products are issued and its
//   own are done.
// - fp32 (`flat_split_wgmma`): fp32 products on the fp16 tensor cores (split.cuh): each query
//   is scaled by a power of two (its largest component) and held as hi and lo fp16 planes, the
//   B operand (196 KB at H = 768, most of shared memory: TF32 pairs would need 393 KB); the rows
//   go straight from device memory into the warpgroup's registers, two 64-dim slices ahead,
//   each (row, slice) scaled by its own power of two and split there into the A fragments of
//   m64n64k16 RS wgmma. A slice's three products (hi.hi, hi.lo, lo.hi) sum in the tensor core;
//   the slice's sum leaves it, scaled back, into an fp32 total (one rounding a slice).
//   The dims are taken in another order than the rows store them (thread t of a quad reads
//   dims 4 t .. 4 t + 3 of each 16, one float4, as its fragment's k 2t, 2t + 1, 2t + 8,
//   2t + 9); the query planes store their dims in the same order.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "serve_select.cuh"
#include "split.cuh"

using namespace drt;

namespace {

constexpr int QT = 64;               // queries a CTA: the wgmma N
constexpr int TR = 64;               // rows a tile: the wgmma M
constexpr int SLICE = 64;            // dims a k-slice: one 128-byte row of 2-byte elements
constexpr uint32_t TILE = 64 * 128;  // a 64 x 64 slice of 2-byte elements, 128-byte swizzle
constexpr int JMAX = 32;             // the list of a query, for J > JT
constexpr int JT = 8;                // the two-thread selection's lists: J <= JT
constexpr int SCP = TR + 4;          // score tile pitch, floats
constexpr int NST_MAX = 12;          // bf16 ring stages, at most
constexpr size_t SMEM_MAX = 232448;
// the selection's shared memory: the score tile and, in the fp32 body, the lists (one thread
// a query, [JMAX][QT]; two, [JT][128]) and each list's floor (the bf16 body keeps its lists
// in registers)
constexpr size_t SCORE_BYTES = sizeof(float) * QT * SCP;
constexpr size_t SELECT_BYTES = SCORE_BYTES + sizeof(u64) * QT * JMAX + sizeof(float) * 128;
static_assert(JT * 128 <= QT * JMAX, "both lists' layouts share one space");

__host__ __device__ inline size_t bf16_smem(int H, int nst) {
  return 1024 + (size_t)(H / SLICE + nst) * TILE + SCORE_BYTES + 8 * (2 * nst + 1);
}
// the bf16 body's ring stages: as many as fit, up to NST_MAX
__host__ __device__ inline int bf16_stages(int H) {
  int nst = NST_MAX;
  while (nst > 0 && bf16_smem(H, nst) > SMEM_MAX) --nst;
  return nst;
}
__host__ __device__ inline size_t split_smem(int H) {
  return 1024 + (size_t)(H / SLICE) * 2 * TILE + SELECT_BYTES + sizeof(float) * QT;
}

// A thread's selection: the rows of a tile (srow: their scores, -0 made +0; rows past n_rows
// not stored) past its list's J-th score at the tile's start (the floor only rises) as a
// bitmask, then each of them, in row order, against the floor as it stands, into its sorted
// list of N keys (serve_select.cuh's insertion, no chain between the entries).
template <int ROWS>
__device__ __forceinline__ unsigned long long candidates(const float* srow, float floor,
                                                        int n_rows) {
  unsigned long long cand = 0ull;
#pragma unroll
  for (int k = 0; k < ROWS / 4; ++k) {
    const float4 s4 = *reinterpret_cast<const float4*>(srow + 4 * k);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (sv[e] > floor) cand |= 1ull << (4 * k + e);
  }
  if (n_rows < ROWS) cand &= n_rows <= 0 ? 0ull : (1ull << n_rows) - 1ull;
  return cand;
}
template <int N>
__device__ __forceinline__ void insert_rows(u64 (&L)[N], float& floor, unsigned long long cand,
                                            const float* srow, int row0, int J) {
  while (cand != 0ull) {
    const int b = __ffsll(cand) - 1;
    cand &= cand - 1ull;
    const float v = srow[b];
    if (v > floor) {
      insert_sorted(L, pack_key(v, row0 + b));
      // J = N (the search's 8, the escalation's 32): the last key, no select tree
      floor = J == N ? (L[N - 1] == 0ull ? -INFINITY : key_score(L[N - 1])) : list_floor(L, J);
    }
  }
}

// The fp32 body's selection over ROWS rows (32 or 64) into a list in shared memory (column
// `list` of a slot-major array, `stride` apart), which leaves it only where a row entered.
template <int N, int ROWS>
__device__ __forceinline__ void select_rows(u64* list, int stride, float* floor_at,
                                            const float* srow, int n_rows, int row0, int J) {
  float floor = *floor_at;
  const unsigned long long cand = candidates<ROWS>(srow, floor, n_rows);
  if (cand == 0ull) return;
  u64 L[N];
#pragma unroll
  for (int p = 0; p < N; ++p) L[p] = list[p * stride];
  insert_rows(L, floor, cand, srow, row0, J);
#pragma unroll
  for (int p = 0; p < N; ++p) list[p * stride] = L[p];
  *floor_at = floor;
}

// The tile's fp32 sums (acc[4 n + e]: row 16 w + g, query 8 n + 2 t4 + e; acc[4 n + 2 + e]:
// row + 8), times the query's factor where qf is given, + 0, into the score tile.
__device__ __forceinline__ void store_scores(float* scores, const float (&acc)[32],
                                             const float* qf, int warp, int g, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qq = 8 * n + 2 * t4 + e;
      const float f = qf != nullptr ? qf[qq] : 1.f;
      float* dst = scores + qq * SCP + 16 * warp + g;
      dst[0] = __fadd_rn(acc[4 * n + e] * f, 0.f);
      dst[8] = __fadd_rn(acc[4 * n + 2 + e] * f, 0.f);
    }
}

// ---- bf16 ---------------------------------------------------------------------------------

constexpr int BF16_THREADS = 160;  // one consumer warpgroup and one producer warp
constexpr int PRODUCER_WARP = 4;

__global__ void __launch_bounds__(BF16_THREADS, 1)
flat_bf16_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmr,
                float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                int n_valid, int block, int J, int nst) {
  extern __shared__ unsigned char smem_raw[];
  const int NS = H / SLICE;
  const uint32_t qplanes = (smem_addr(smem_raw) + 1023u) & ~1023u;  // [NS] query slices
  unsigned char* g_q = smem_raw + (qplanes - smem_addr(smem_raw));
  const uint32_t ring = qplanes + NS * TILE;                          // [nst] row slices
  float* scores = reinterpret_cast<float*>(g_q + (size_t)(NS + nst) * TILE);  // [QT][SCP]
  const uint32_t bars = smem_addr(scores + QT * SCP);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (nst + s); };
  const uint32_t qbar = bars + 8u * (2 * nst);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, blk = blockIdx.y;
  const int blk_start = blk * block;
  const int row_lim = min(min(N, blk_start + block), n_valid);  // rows at or past it: masked
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_expect_tx(qbar, NS * TILE);  // query rows past Q arrive as zeros
      for (int j = 0; j < NS; ++j) tma_load_2d(qplanes + j * TILE, &tmq, j * SLICE, q0, qbar);
      int stage = 0;
      unsigned phase = 0;
      for (int base = blk_start; base < row_lim; base += TR)
        for (int j = 0; j < NS; ++j) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), TILE);
          tma_load_2d(ring + stage * TILE, &tmr, j * SLICE, base, full(stage));
          if (++stage == nst) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // the selection's lists, in registers for the whole block: two threads a query, each half
  // a tile's rows, a list of JT keys (J <= JT) or of JMAX
  const int my_q = tid >> 1, my_half = tid & 1;
  u64 L8[JT], L32[JMAX];
#pragma unroll
  for (int p = 0; p < JT; ++p) L8[p] = 0ull;
#pragma unroll
  for (int p = 0; p < JMAX; ++p) L32[p] = 0ull;
  float floor = -INFINITY;
  mbar_wait(qbar, 0);  // also where no tile follows: the CTA outlives its loads
  const int g = lane >> 2, t4 = lane & 3;
  float acc[32];
  int stage = 0;
  unsigned phase = 0;
  for (int base = blk_start; base < row_lim; base += TR) {
    int prev = 0;
    for (int j = 0; j < NS; ++j) {
      mbar_wait(full(stage), phase);
      const uint32_t st = ring + stage * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(acc, sw128_desc(st + kk * 32, 16),
                     sw128_desc(qplanes + j * TILE + kk * 32, 16), j > 0 || kk > 0);
      wgmma_commit();
      if (j > 0) {  // the previous slice's products are done: release its stage
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(prev));
      }
      prev = stage;
      if (++stage == nst) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(prev));
    store_scores(scores, acc, nullptr, warp, g, t4);
    consumers_sync();
    if (q0 + my_q < Q) {  // thread t: query t / 2, rows 32 (t % 2) .. + 31
      const float* srow = scores + my_q * SCP + 32 * my_half;
      const int n_rows = row_lim - base - 32 * my_half, row0 = base + 32 * my_half;
      const unsigned long long cand = candidates<32>(srow, floor, n_rows);
      if (J <= JT)
        insert_rows(L8, floor, cand, srow, row0, J);
      else
        insert_rows(L32, floor, cand, srow, row0, J);
    }
    consumers_sync();  // the score tile is read before the next tile's scores
  }
  if (J <= JT)
    write_pair_lists(L8, tid, q0, Q, blk, gridDim.y, J, out_v, out_i);
  else
    write_pair_lists(L32, tid, q0, Q, blk, gridDim.y, J, out_v, out_i);
}

// ---- fp32 ---------------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;  // one warpgroup

// The hi and lo planes of a query tile in shared memory: slice j's hi plane at 2 j TILE, its
// lo plane TILE after; query r's row of a plane is 128 bytes, 16-byte chunk c at c ^ (r % 8).
// Dim 16 s + 4 t + u of a slice sits at column 16 s + 2 t + (u & 1) + 8 (u >> 1): k16 step s,
// the k a fragment's thread t gives u (a0 / a1: k 2t, 2t + 1; a2 / a3: k 2t + 8, 2t + 9).
__device__ __forceinline__ uint32_t plane_offset(int r, int col) {
  const int b = 2 * col;
  return (uint32_t)r * 128 + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flat_split_wgmma(const float* __restrict__ q, const float* __restrict__ corpus,
                 float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                 int n_valid, int block, int J) {
  extern __shared__ unsigned char smem_raw[];
  const int NS = H / SLICE;
  const uint32_t planes = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* g_planes = smem_raw + (planes - smem_addr(smem_raw));
  float* scores = reinterpret_cast<float*>(g_planes + (size_t)NS * 2 * TILE);  // [QT][SCP]
  u64* lists = reinterpret_cast<u64*>(scores + QT * SCP);
  float* floors = reinterpret_cast<float*>(lists + QT * JMAX);  // [128]
  float* qinv = floors + 128;                                   // [QT]: 2^-e of each query

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QT, blk = blockIdx.y;
  const int blk_start = blk * block;
  const int row_lim = min(min(N, blk_start + block), n_valid);

  // the query planes: warp w stages queries 16 w .. 16 w + 15, four at a time (their loads in
  // flight together); a lane holds dims 4 (lane + 32 i) .. + 3 of a query (H <= 768: i < 6),
  // the query's largest |component| from the same registers, then each float4 scaled, split
  // and stored as two words a plane
  const int nv = (H + 127) / 128;
  for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += 4) {
    float4 x[4][6];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        x[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nv && 4 * (lane + 32 * i) < H && q0 + r0 + u < Q)
          x[u][i] = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r0 + u) * H) + lane +
                          32 * i);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u;
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        m = fmaxf(m, fmaxf(fmaxf(fabsf(x[u][i].x), fabsf(x[u][i].y)),
                           fmaxf(fabsf(x[u][i].z), fabsf(x[u][i].w))));
      const int e = split_exp(warp_max(m));
      const float s = split_pow2(e);
      if (lane == 0) qinv[r] = split_pow2(-e);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int d = 4 * (lane + 32 * i), j = d / SLICE, o = d % SLICE;
        if (i >= nv || d >= H) break;
        const int col = 16 * (o >> 4) + 2 * ((o >> 2) & 3);
        unsigned hi01, lo01, hi23, lo23;
        split2(x[u][i].x * s, x[u][i].y * s, hi01, lo01);
        split2(x[u][i].z * s, x[u][i].w * s, hi23, lo23);
        unsigned char* hi = g_planes + (size_t)2 * j * TILE;
        *reinterpret_cast<unsigned*>(hi + plane_offset(r, col)) = hi01;
        *reinterpret_cast<unsigned*>(hi + plane_offset(r, col + 8)) = hi23;
        *reinterpret_cast<unsigned*>(hi + TILE + plane_offset(r, col)) = lo01;
        *reinterpret_cast<unsigned*>(hi + TILE + plane_offset(r, col + 8)) = lo23;
      }
    }
  }
  for (int i = tid; i < QT * JMAX; i += SPLIT_THREADS) lists[i] = 0ull;
  floors[tid] = -INFINITY;
  fence_proxy_async();
  __syncthreads();

  // the rows: slice idx of the block (tile idx / NS, slice idx % NS) in registers, thread
  // (w, g, t4) rows 16 w + g (a) and + 8 (b), one float4 a k16 step s: dims 16 s + 4 t4 ..
  const int n_tiles = row_lim > blk_start ? (row_lim - blk_start + TR - 1) / TR : 0;
  const int total = n_tiles * NS;
  auto load = [&](float4 (&ya)[4], float4 (&yb)[4], int idx) {
    if (idx >= total) return;
    const int ti = idx / NS, j = idx - ti * NS;
    const int ra = blk_start + ti * TR + 16 * warp + g, rb = ra + 8;
    const float* pa = corpus + (size_t)ra * H + j * SLICE + 4 * t4;
    const float* pb = corpus + (size_t)rb * H + j * SLICE + 4 * t4;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ya[s] = ra < N ? __ldg(reinterpret_cast<const float4*>(pa + 16 * s))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      yb[s] = rb < N ? __ldg(reinterpret_cast<const float4*>(pb + 16 * s))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float sum[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.f;
  // one slice: its rows' scales, fragments, products and fp32 sums; the registers it read
  // are refilled with the slice two ahead; after a tile's last slice, its selection
  auto step = [&](float4 (&ya)[4], float4 (&yb)[4], int idx) {
    const int ti = idx / NS, j = idx - ti * NS;
    float ma = 0.f, mb = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ma = fmaxf(ma, fmaxf(fmaxf(fabsf(ya[s].x), fabsf(ya[s].y)), fmaxf(fabsf(ya[s].z), fabsf(ya[s].w))));
      mb = fmaxf(mb, fmaxf(fmaxf(fabsf(yb[s].x), fabsf(yb[s].y)), fmaxf(fabsf(yb[s].z), fabsf(yb[s].w))));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the quad holds the row's 64 dims
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    }
    const int ea = split_exp(ma), eb = split_exp(mb);
    const float sa = split_pow2(ea), sb = split_pow2(eb);
    unsigned hi[4][4], lo[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split2(ya[s].x * sa, ya[s].y * sa, hi[s][0], lo[s][0]);
      split2(yb[s].x * sb, yb[s].y * sb, hi[s][1], lo[s][1]);
      split2(ya[s].z * sa, ya[s].w * sa, hi[s][2], lo[s][2]);
      split2(yb[s].z * sb, yb[s].w * sb, hi[s][3], lo[s][3]);
    }
    load(ya, yb, idx + 2);
    const uint32_t ph = planes + 2 * j * TILE, pl = ph + TILE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_f16_rs_n64(acc, hi[s], sw128_desc(ph + 32 * s, 16), s > 0);
      wgmma_f16_rs_n64(acc, hi[s], sw128_desc(pl + 32 * s, 16), 1);
      wgmma_f16_rs_n64(acc, lo[s], sw128_desc(ph + 32 * s, 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_regs(hi[s]), fence_regs(lo[s]);  // read until the wait
    const float ia = split_pow2(-ea), ib = split_pow2(-eb);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[4 * n + e] = fmaf(acc[4 * n + e], ia, sum[4 * n + e]);
        sum[4 * n + 2 + e] = fmaf(acc[4 * n + 2 + e], ib, sum[4 * n + 2 + e]);
      }
    if (j == NS - 1) {
      const int base = blk_start + ti * TR;
      store_scores(scores, sum, qinv, warp, g, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = 0.f;
      __syncthreads();
      if (J <= JT) {  // thread t: query t / 2, rows 32 (t % 2) .. + 31, a list of JT
        if (q0 + (tid >> 1) < Q)
          select_rows<JT, 32>(lists + tid, 128, floors + tid,
                              scores + (tid >> 1) * SCP + 32 * (tid & 1),
                              row_lim - base - 32 * (tid & 1), base + 32 * (tid & 1), J);
      } else if (tid < QT && q0 + tid < Q) {  // thread t: query t, every row, a list of JMAX
        select_rows<JMAX, TR>(lists + tid, QT, floors + tid, scores + tid * SCP,
                              row_lim - base, base, J);
      }
      __syncthreads();  // the score tile is read before the next tile's scores
    }
  };
  float4 a0[4], b0[4], a1[4], b1[4];
  load(a0, b0, 0);
  load(a1, b1, 1);
  for (int idx = 0; idx < total; idx += 2) {
    step(a0, b0, idx);
    if (idx + 1 < total) step(a1, b1, idx + 1);
  }
  if (J <= JT) {
    u64 L[JT];
#pragma unroll
    for (int p = 0; p < JT; ++p) L[p] = lists[p * 128 + tid];
    write_pair_lists(L, tid, q0, Q, blk, gridDim.y, J, out_v, out_i);
  } else if (tid < QT && q0 + tid < Q) {
    const size_t o = ((size_t)(q0 + tid) * gridDim.y + blk) * J;
    for (int p = 0; p < J; ++p) {
      const u64 key = lists[p * QT + tid];
      out_v[o + p] = key == 0ull ? -INFINITY : key_score(key);
      out_i[o + p] = key == 0ull ? -1 : key_row(key);
    }
  }
}

}  // namespace

// 1 where drt_flat_certified takes the shape, else 0: dtype 0 (fp32) or 1 (bf16) queries and
// rows, H % 64 == 0, the query tile and buffers in shared memory (fp32: H <= 768), q and the
// rows 16-byte aligned.
extern "C" int drt_flat_certified_takes(const void* q, const void* corpus, int H, int dtype) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
  if ((ptrs & 15) != 0 || H < SLICE || H % SLICE != 0) return 0;
  if (dtype == 0) return split_smem(H) <= SMEM_MAX;
  if (dtype == 1) return bf16_stages(H) >= 2;
  return 0;
}

// K5: q [Q, H] and corpus [N, H] of one dtype (0 fp32, 1 bf16) -> out_vals [Q, ceil(N /
// block), J] fp32, out_ids int32: per (query, block) the J best pairs (score descending, ties
// to the smaller id), rows >= n_valid masked, empty entries (-inf, -1). Shapes:
// drt_flat_certified_takes.
extern "C" int drt_flat_certified(const void* q, const void* corpus, void* out_v, void* out_i,
                                  int Q, int N, int H, int n_valid, int block, int J, int dtype,
                                  void* stream) {
  if (J < 1 || J > JMAX || block < 1 || Q < 1 || N < 1 ||
      !drt_flat_certified_takes(q, corpus, H, dtype))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + block - 1) / block;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + QT - 1) / QT, n_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if (dtype == 1) {
    CUtensorMap tmq, tmr;
    const cuuint64_t row_bytes[2] = {(cuuint64_t)H * 2, 0};
    const cuuint64_t qdims[3] = {(cuuint64_t)H, (cuuint64_t)Q, 1};
    const cuuint64_t rdims[3] = {(cuuint64_t)H, (cuuint64_t)N, 1};
    if (int e = tiled_map(&tmq, q, 2, qdims, row_bytes, 64)) return e;
    if (int e = tiled_map(&tmr, corpus, 2, rdims, row_bytes, 64)) return e;
    const int nst = bf16_stages(H);
    const size_t smem = bf16_smem(H, nst);
    cudaError_t err = cudaFuncSetAttribute(flat_bf16_wgmma,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flat_bf16_wgmma<<<grid, BF16_THREADS, smem, st>>>(tmq, tmr, ov, oi, Q, N, H, n_valid, block,
                                                      J, nst);
    return (int)cudaGetLastError();
  }
  const size_t smem = split_smem(H);
  cudaError_t err = cudaFuncSetAttribute(flat_split_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flat_split_wgmma<<<grid, SPLIT_THREADS, smem, st>>>(static_cast<const float*>(q),
                                                      static_cast<const float*>(corpus), ov, oi,
                                                      Q, N, H, n_valid, block, J);
  return (int)cudaGetLastError();
}
