// K5 on Hopper over fp32 rows: the certified exact top-J of fp32 queries against fp32 rows,
// products on wgmma; and K8 over fp32 rows, the serve top-J, on the same body.
//
// Replaces, at the shapes drt_flat_certified_takes accepts, these TPU kernels of
// denseretrievaltoolkits_tpu/ops/topk.py:
//   K5 `_block_topj_kernel` (:37, launched by `_pallas_block_topj`, :336) over fp32 rows
//       (Precision.HIGHEST, :324-327; K5 over bf16 rows is flat_serve.cu's, with `cert`);
//   K8 `_block_topj_kernel_packed` over fp32 rows (:122, `pallas_topk_serve`, :373): the same
//       scores, the packed selection (K8 over bf16 and int8 rows is flat_serve.cu's).
// block_topj.cu's bodies run the other shapes (drt_block_topj dispatches by shape).
//
// What it computes: for each (query, storage block of `block` rows) the J best (score, id)
// pairs, score = q . c, ties to the smaller id, rows >= n_valid masked, an empty entry (-inf,
// -1); output [Q, n_blocks, J]. Certified (K5), a -0 score becomes +0: the certified order
// treats the two as equal, the packed key of the selection would not; serve (K8), the key
// order of serve_select.cuh, -0 just below +0.
//
// What bounds it on the H100 (1M rows x 768, 1024 queries): three fp16 products a pair
// (split.cuh), 3 x 2 Q N H at 989 TFLOP/s (4.77 ms; FFMA products would take 23.48 ms at 67
// TFLOP/s, TF32 pairs 9.76 at 495), and 49 GB of rows from L2 (once per 64-query tile).
//
// Design: one CTA a (64-query tile, storage block), one warpgroup; rows are the wgmma's M,
// queries its N, 64 rows a tile. fp32 products on the fp16 tensor cores (split.cuh): each
// query is scaled by a power of two (its largest component) and held as hi and lo fp16 planes,
// the B operand (196 KB at H = 768, most of shared memory: TF32 pairs would need 393 KB); the
// rows go straight from device memory into the warpgroup's registers, two 64-dim slices ahead,
// each (row, slice) scaled by its own power of two and split there into the A fragments of
// m64n64k16 RS wgmma. A slice's three products (hi.hi, hi.lo, lo.hi) sum in the tensor core;
// the slice's sum leaves it, scaled back, into an fp32 total (one rounding a slice). The dims
// are taken in another order than the rows store them (thread t of a quad reads dims 4 t ..
// 4 t + 3 of each 16, one float4, as its fragment's k 2t, 2t + 1, 2t + 8, 2t + 9); the query
// planes store their dims in the same order.
// Selection (serve_select.cuh's select_rows, int4_certified.cu's K10): each tile's scores go
// to a score tile [query][row] (pitch 68) as their orders (-0 made +0 first where certified);
// two threads own a query, each half the tile's rows, with lists of 8 or 16 keys in shared
// memory for J <= 16 (the serve J of 1M rows is 7, of 262,144-row slabs 11, of the IVF side
// scans' 512-row blocks 6-12), and for J > 16 one thread a query, every row, a list of 32
// keys; a tile's rows past the list's J-th order at the tile's start are marked in a bitmask
// and only they reach the insertion; the two lists merge at the end of the block. (A CTA
// walking several storage blocks, the query planes built once, was 5% slower at 4096-row
// blocks and 2% at 512.)
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
constexpr int JMAX = 32;             // the list of a query, for J > JT16
constexpr int JT = 8;                // the two-thread selection's lists: J <= JT
constexpr int JT16 = 16;             // or J <= JT16
constexpr int SCP = TR + 4;          // score tile pitch, words
constexpr size_t SMEM_MAX = 232448;
// the selection's shared memory: the score tile, the lists (one thread a query, [JMAX][QT];
// two, [JT16][128]) and each list's floor
constexpr size_t SELECT_BYTES =
    sizeof(unsigned) * QT * SCP + sizeof(u64) * QT * JMAX + sizeof(float) * 128;
static_assert(JT16 * 128 <= QT * JMAX, "the lists' layouts share one space");

__host__ __device__ inline size_t split_smem(int H) {
  return 1024 + (size_t)(H / SLICE) * 2 * TILE + SELECT_BYTES + sizeof(float) * QT;
}

// The tile's fp32 sums (acc[4 n + e]: row 16 w + g, query 8 n + 2 t4 + e; acc[4 n + 2 + e]:
// row + 8) times each query's factor qf, + zero (+0: -0 made +0, certified; -0: every score
// kept, serve), as their orders into the score tile.
__device__ __forceinline__ void store_orders(unsigned* scores, const float (&acc)[32],
                                             const float* qf, float zero, int warp, int g,
                                             int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qq = 8 * n + 2 * t4 + e;
      unsigned* dst = scores + qq * SCP + 16 * warp + g;
      dst[0] = score_order(__fadd_rn(acc[4 * n + e] * qf[qq], zero));
      dst[8] = score_order(__fadd_rn(acc[4 * n + 2 + e] * qf[qq], zero));
    }
}

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
                 int n_valid, int block, int J, float zero) {
  extern __shared__ unsigned char smem_raw[];
  const int NS = H / SLICE;
  const uint32_t planes = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* g_planes = smem_raw + (planes - smem_addr(smem_raw));
  // [QT][SCP]: the tile's scores as their orders
  unsigned* scores = reinterpret_cast<unsigned*>(g_planes + (size_t)NS * 2 * TILE);
  u64* lists = reinterpret_cast<u64*>(scores + QT * SCP);
  unsigned* floors = reinterpret_cast<unsigned*>(lists + QT * JMAX);  // [128]: orders
  float* qinv = reinterpret_cast<float*>(floors + 128);  // [QT]: 2^-e of each query

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
  floors[tid] = 0u;
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
      store_orders(scores, sum, qinv, zero, warp, g, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = 0.f;
      __syncthreads();
      // thread t: query t / 2, rows 32 (t % 2) .. + 31, a list of JT or JT16; J > JT16: thread
      // t < 64, query t, every row, a list of JMAX
      const OrderRow o{scores + (J <= JT16 ? (tid >> 1) * SCP + 32 * (tid & 1) : tid * SCP)};
      const int n_rows = row_lim - base - (J <= JT16 ? 32 * (tid & 1) : 0);
      const int row0 = base + (J <= JT16 ? 32 * (tid & 1) : 0);
      if (J <= JT) {
        if (q0 + (tid >> 1) < Q)
          select_rows<JT, 32>(lists + tid, 128, floors + tid, o, o, n_rows, row0, J);
      } else if (J <= JT16) {
        if (q0 + (tid >> 1) < Q)
          select_rows<JT16, 32>(lists + tid, 128, floors + tid, o, o, n_rows, row0, J);
      } else if (tid < QT && q0 + tid < Q) {
        select_rows<JMAX, TR>(lists + tid, QT, floors + tid, o, o, n_rows, row0, J);
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
  auto write_pairs = [&](auto& L) {
    constexpr int N = sizeof(L) / sizeof(L[0]);
#pragma unroll
    for (int p = 0; p < N; ++p) L[p] = lists[p * 128 + tid];
    write_pair_lists(L, tid, q0, Q, blk, gridDim.y, J, out_v, out_i);
  };
  if (J <= JT) {
    u64 L[JT];
    write_pairs(L);
  } else if (J <= JT16) {
    u64 L[JT16];
    write_pairs(L);
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

// 1 where drt_flat_certified takes the shape, else 0: fp32 queries and rows, H % 64 == 0
// up to 768 (the query planes and buffers in shared memory), q and the rows 16-byte aligned.
extern "C" int drt_flat_certified_takes(const void* q, const void* corpus, int H) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
  if ((ptrs & 15) != 0 || H < SLICE || H % SLICE != 0) return 0;
  return split_smem(H) <= SMEM_MAX;
}

// K5 over fp32 rows: q [Q, H] and corpus [N, H] fp32 -> out_vals [Q, ceil(N / block), J]
// fp32, out_ids int32: per (query, block) the J best pairs (score descending, ties to the
// smaller id), rows >= n_valid masked, empty entries (-inf, -1); with `serve` (K8) in the
// serve key order. Shapes: drt_flat_certified_takes.
extern "C" int drt_flat_certified(const void* q, const void* corpus, void* out_v, void* out_i,
                                  int Q, int N, int H, int n_valid, int block, int J, int serve,
                                  void* stream) {
  if (J < 1 || J > JMAX || block < 1 || Q < 1 || N < 1 ||
      !drt_flat_certified_takes(q, corpus, H))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + block - 1) / block;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + QT - 1) / QT, n_blocks);
  const size_t smem = split_smem(H);
  cudaError_t err = cudaFuncSetAttribute(flat_split_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flat_split_wgmma<<<grid, SPLIT_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(corpus), static_cast<float*>(out_v),
      static_cast<int*>(out_i), Q, N, H, n_valid, block, J, serve ? -0.f : 0.f);
  return (int)cudaGetLastError();
}
