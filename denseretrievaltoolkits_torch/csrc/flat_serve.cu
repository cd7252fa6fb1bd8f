// K5, K6, K8, K11 and K12 on Hopper: the block top-J of bf16 queries against bf16 or int8 rows
// (K8, and K5 / K6 with the certified order), of int8 queries against int8 or nibble-packed
// int4 rows (K12), and of bf16 queries against int4 rows (K11), products on wgmma.
//
// Replaces, at the shapes drt_flat_serve_takes accepts, these TPU kernels of
// denseretrievaltoolkits_tpu/ops/topk.py:
//   K5  `_block_topj_kernel` over bf16 rows (:37, `_pallas_block_topj`, :336): bf16 queries x
//       bf16 rows, fp32 sums, the certified exact top-J (K5 over fp32 rows is
//       flat_certified.cu's);
//   K8  `_block_topj_kernel_packed` / `_packed_scaled` (:122, :148; `pallas_topk_serve*`,
//       :373, :411): bf16 queries x bf16 rows, and x int8 rows times the row scale, fp32 sums,
//       then the packed selection (K8 over fp32 rows is flat_certified.cu's);
//   K6  `_block_topj_kernel_scaled` (:65, `_pallas_block_topj_scaled`, :618): bf16 queries x
//       int8 rows times the row scale, the certified exact top-J;
//   K12 `_block_topj_kernel_packed_i8q` (:190, launched by `_pallas_block_topj_packed_i8q`,
//       :468): int8 queries x int8 rows, s32 products, then the packed selection;
//   K12 sq4 `_block_topj_kernel_packed_sq4_i8q` (:213, `_pallas_block_topj_packed_sq4_i8q`,
//       :504): the same over int4 rows;
//   K11 `_block_topj_kernel_packed_sq4` (:166, `_pallas_block_topj_packed_sq4`, :432): bf16
//       queries x int4 rows, fp32 sums, then the packed selection.
// block_topj.cu's mma.sync bodies run the other shapes (drt_block_topj dispatches by shape).
//
// What it computes: for each (query, storage block of `block` rows) the J best (score, id)
// pairs in the serve key order (serve_select.cuh: score descending, -0 just below +0, ties to
// the smaller id), rows >= n_valid masked, an empty entry (-inf, -1); output [Q, n_blocks, J].
// K12: score = (float(s32) x scale_row) x scale_query, the reference's order (topk.py:207-208),
// with the s32 sums exact; K11 / K8 int8 / K6: score = (fp32 sum of the exact bf16 x int4 or
// int8 products) x scale_row; K8 / K5 bf16: the fp32 sum of the exact bf16 products. K5 and K6
// (`cert`) make a -0 score +0 first, so the key order is the certified one (equal scores
// equal). int4
// rows are [N, H/2] bytes in the column-half layout of ops/quant.py (K9).
//
// What bounds it on the H100 (1M rows x 768, 1024 queries): the products, 2 Q N H operations,
// at 1,979 TOP/s for K12 (0.795 ms) and 989 TFLOP/s for K5, K6, K8 and K11 (1.59 ms); the rows
// (1.5 GB bf16, 0.77 GB int8, 0.38 GB int4) stream from device memory once and from L2 once per
// 64-query tile.
//
// Design: one CTA a (64-query tile, storage block): consumer warpgroups and one producer warp;
// rows are the wgmma's M (64 a tile), queries its N (64). The producer brings each tile's rows
// by TMA in 128-byte boxes (128-byte swizzle) into an mbarrier ring; the query tile stays
// resident in shared memory as the B operand.
// - K12 int8 rows (`I8`) and K5 / K8 bf16 rows (`BB`): the producer also brings the query tile once
//   by TMA, 128 int8 or 64 bf16 dims a slice in their natural order; m64n64k32 s8 or m64n64k16
//   bf16 wgmma with both operands in shared memory, a slice's stage released once the products
//   two slices on are issued and its own are done.
// - K12 int4 rows (`SQ4`): K10's body (int4_certified.cu) with one plane: the warpgroup reads
//   each slice's packed words straight into s8 A fragments (int4_tiles.cuh; low nibbles are
//   the slice's dims j, high ones j + H/2), against the int8 query tile that the consumer
//   warps write in that k order; m64n64k32 s8 wgmma with A from registers. The codes go in
//   biased, n + 8 (one AND-XOR a word, where a sign extension takes several instructions), and
//   the epilogue takes 8 x the query's sum off the exact s32 sums; those stay below 2^22, so
//   they become floats by a magic-number add, not the conversion unit.
// - K11 (`BF4`): the same words as bf16 A fragments of m64n64k16 RS wgmma, built with no
//   int-to-float conversion (int4_tiles.cuh: bf16 bits 0x4300 | (x ^ 8) are 128 + n + 8, one
//   bf16x2 FMA takes 136 off); the dims of a 16-dim step are permuted (thread t reads dims
//   4 t .. 4 t + 3 as k 2t, 2t + 1, 2t + 8, 2t + 9), and the consumer warps write the bf16
//   query tile in that order.
// - K8 int8 rows and K6 (`BI8`): 128 int8 dims a slice, read as words straight from the
//   stage into bf16 A fragments of m64n64k16 RS wgmma (common.cuh's i8x4_to_bf16: the biased
//   byte in the mantissa of the float 2^23, one fp32 subtraction, the high half: exact, no
//   int-to-float conversion; 5% faster than two bf16 masks of the byte and one bf16x2 FMA a
//   pair, and than the converted rows stored as a bf16 tile for SS wgmma, PERF.md); K11's k
//   order (thread t's word is dims 4t .. 4t + 3 as k 2t, 2t + 1, 2t + 8, 2t + 9), in which the
//   consumer warps write the bf16 query tile.
// - SQ4, BF4 and BI8 build a slice's fragments in one register set once the previous slice's
//   products are done; SQ4 and BF4 read a stage's second slice's words while its first slice's
//   products run, then release the stage.
// - Selection (serve_select.cuh, as K10's and K5's): the tile's scores go to a score tile
//   [query][row] as their orders (the key's high word, so -0 stays below +0); two threads own
//   a query, each half the tile's rows, with its own sorted list of NL keys in registers (NL =
//   8, 16 or 32, the least that holds J: the serve J is 7 at 1M rows, 11 on 262,144-row slabs,
//   6-12 on the IVF side scans' 512-row blocks, up to 32; K5's and K6's 8 and their
//   escalation's 32); a tile's rows past the list's J-th order at the tile's start are marked
//   in a bitmask and only they reach the insertion; the two lists merge at the end of the block.
// - One warpgroup's selection waits on its products and its products on its selection, so a
//   second warpgroup works beside it: I8 and SQ4 take 109 KB of shared memory at H = 768, and
//   two CTAs of one warpgroup share an SM; the bf16 query tiles of BF4, BB and BI8 (96 KB)
//   leave room for one CTA, which runs two warpgroups on the row tiles in turn (each with its
//   own half of the ring, score tile and lists, merged at the end): 1.55x faster than one
//   warpgroup for K11 on the H100 (PERF.md). A ring has one consumer: a second one, more than
//   a phase ahead of a stage's barrier (a tile of more stages than the ring), read stale rows.
// - A CTA walks storage blocks in turn (blockIdx.y, + gridDim.y, ...) with its query tile
//   resident: blocks short of 4096 rows share a CTA (hopper.cuh's grid_blocks), so the IVF side
//   scans' 512-row blocks do not rebuild the query tile every 8 row tiles.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "int4_tiles.cuh"
#include "serve_select.cuh"

using namespace drt;

namespace {

// the bodies: int8 x int8 (K12), int8 x int4 (K12 sq4), bf16 x int4 (K11), bf16 x bf16 (K8,
// K5), bf16 x int8 (K8, K6)
enum Kind { I8 = 0, SQ4 = 1, BF4 = 2, BB = 3, BI8 = 4 };

constexpr int QT = 64;                // queries a CTA: the wgmma N
constexpr int TR = 64;                // rows a tile: the wgmma M
constexpr int SCP = TR + 4;           // score tile pitch, words
constexpr uint32_t TILE = 64 * 128;   // 64 rows (or queries) x 128 bytes, 128-byte swizzle
constexpr int NST_MAX = 12;           // ring stages, at most
constexpr int JMAX = 32;
constexpr size_t SMEM_MAX = 232448;
constexpr size_t SMEM_TWO = 115712;   // a CTA's share where two fit an SM (228 KB, 1 KB each kept)

static_assert(2 * QT * SCP * sizeof(unsigned) >= 128 * JMAX * sizeof(u64),
              "two score tiles hold a warpgroup's lists");

// the element type codes of drt_block_topj's interface
constexpr int T_BF16 = 1, T_I8 = 2, T_I4 = 3;

// threads of a CTA: NWG consumer warpgroups and one producer warp
__host__ __device__ constexpr int threads(int nwg) { return 128 * nwg + 32; }

__host__ __device__ inline int kind_of(int qtype, int ctype) {
  if (qtype == T_I8 && ctype == T_I8) return I8;
  if (qtype == T_I8 && ctype == T_I4) return SQ4;
  if (qtype == T_BF16 && ctype == T_I4) return BF4;
  if (qtype == T_BF16 && ctype == T_BF16) return BB;
  if (qtype == T_BF16 && ctype == T_I8) return BI8;
  return -1;
}
// ring stages a row tile takes: 128 int8 dims (I8, BI8: the last stage zero-padded where
// H % 128 == 64), 64 bf16 dims (BB), or two 128-dim slices of packed int4 (SQ4, BF4)
__host__ __device__ inline int tile_stages(int kind, int H) {
  if (kind == BB) return H / 64;
  if (kind == I8 || kind == BI8) return (H + 127) / 128;
  return (H / 128 + 1) / 2;
}
// the resident query tile: int8 H bytes a query, bf16 2 H (BI8: over the padded width)
__host__ __device__ inline size_t query_bytes(int kind, int H) {
  if (kind == BI8) return (size_t)2 * QT * 128 * tile_stages(kind, H);
  return (size_t)(kind == BF4 || kind == BB ? 2 * QT : QT) * H;
}
// the query tile, the ring, a score tile a warpgroup (together also the two warpgroups' lists
// at the end: 128 x 32 keys), the query scales and sums and the barriers
__host__ __device__ inline size_t smem_bytes(int kind, int H, int nst, int nwg) {
  return 1024 + query_bytes(kind, H) + (size_t)nst * TILE + sizeof(unsigned) * QT * SCP * nwg +
         (sizeof(float) + sizeof(int)) * QT + 8 * (2 * nst + 1);
}
// Consumer warpgroups and ring stages: one warpgroup and five stages where two CTAs fit an
// SM (one's selection runs beside the other's products), else two warpgroups taking the row
// tiles in turn (the same overlap in one CTA, around one query tile) and as many stages as
// fit, up to NST_MAX, half of them each warpgroup's own ring. Returns nst and sets nwg.
__host__ __device__ inline int stages(int kind, int H, int& nwg) {
  nwg = 1;
  if (smem_bytes(kind, H, 5, 1) <= SMEM_TWO) return 5;
  nwg = 2;
  int nst = NST_MAX;
  while (nst > 0 && smem_bytes(kind, H, nst, 2) > SMEM_MAX) nst -= 2;
  return nst;
}

// the named barrier `id` of `n` threads (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- int8 rows as bf16 A fragments (BI8) ------------------------------------------------

// The bf16 A fragments (m64nNk16) of one 128-dim slice's eight k16 steps, straight from the
// stage: step kk from the words at bytes 16 kk + 4 t4 of rows 16 w + g (a[0], a[2]) and + 8
// (a[1], a[3]), each word's bytes 0, 1 as k 2 t4, 2 t4 + 1 and bytes 2, 3 as k 2 t4 + 8, 2 t4
// + 9 (common.cuh's i8x4_to_bf16, exact): dim offset i of a 16-dim group is column
// bf16_column(i) of the step, where the B operand stores it (as K11's nibbles).
__device__ __forceinline__ void i8_fragments(unsigned (&a)[8][4], const unsigned char* stage,
                                             int warp, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const unsigned w = *reinterpret_cast<const unsigned*>(stage + r * 128 +
                                                            ((kk ^ (r & 7)) << 4) + 4 * t4);
      i8x4_to_bf16(w, a[kk][i], a[kk][2 + i]);
    }
}

template <int KIND, int NL, int NWG>
__global__ void __launch_bounds__(threads(NWG), NWG == 1 ? 2 : 1)
flat_serve_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmr,
                 const void* __restrict__ q, const float* __restrict__ cscale,
                 const float* __restrict__ qscale, float* __restrict__ out_v,
                 int* __restrict__ out_i, int Q, int N, int H, int n_valid, int block, int J,
                 int nst, float zero) {
  constexpr bool INT8_Q = KIND == I8 || KIND == SQ4;  // int8 queries: s32 sums, query scales
  constexpr bool SS = KIND == I8 || KIND == BB;       // both operands by TMA
  using Acc = std::conditional_t<INT8_Q, int, float>;
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int COLS = KIND == BB ? 64 : 128;         // tensor-map columns a stage: 128 bytes
  extern __shared__ unsigned char smem_raw[];
  const int NS = H / 128;                             // k-slices of 128 dims (I8, SQ4, BF4)
  const int NJ = tile_stages(KIND, H);                // ring stages a tile
  const uint32_t qtile = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* g_q = smem_raw + (qtile - smem_addr(smem_raw));
  const uint32_t ring = qtile + (uint32_t)query_bytes(KIND, H);
  unsigned char* g_ring = g_q + query_bytes(KIND, H);
  // [NWG][QT][SCP]: a score tile a warpgroup
  unsigned* score_tiles = reinterpret_cast<unsigned*>(g_ring + (size_t)nst * TILE);
  float* qs = reinterpret_cast<float*>(score_tiles + NWG * QT * SCP);  // [QT]: query scales (K12)
  int* qsum = reinterpret_cast<int*>(qs + QT);  // [QT]: each int8 query's sum (SQ4)
  const uint32_t bars = smem_addr(qsum + QT);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (nst + s); };
  const uint32_t qbar = bars + 16u * nst;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, n_blocks = (N + block - 1) / block;
  // the storage blocks of the CTA, in turn: blockIdx.y, + gridDim.y, ...; a block's rows at or
  // past row_lim(blk) are masked
  auto row_lim = [&](int blk) { return min(min(N, blk * block + block), n_valid); };
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each warp of the tile's warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < QT) qsum[tid] = 0;
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer
    if (lane == 0) {
      if constexpr (SS) {  // the query tile: NJ slices of COLS elements, one 8 KB box each
        mbar_expect_tx(qbar, NJ * TILE);  // query rows past Q arrive as zeros
        for (int j = 0; j < NJ; ++j) tma_load_2d(qtile + j * TILE, &tmq, j * COLS, q0, qbar);
      }
      // a block's tile t into warpgroup t % NWG's ring, stages w nstw .. w nstw + nstw - 1:
      // a ring has one consumer, so a wait never runs more than one phase ahead of its barrier
      const int nstw = nst / NWG;
      int stage0 = 0, stage1 = 0;  // each ring's next stage
      unsigned phase0 = 0, phase1 = 0;
      for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y)
        for (int base = blk * block, t = 0; base < row_lim(blk); base += TR, ++t) {
          const bool second = NWG == 2 && (t & 1);
          int stage = second ? stage1 : stage0;
          unsigned phase = second ? phase1 : phase0;
          for (int j = 0; j < NJ; ++j) {
            const int s = (second ? nstw : 0) + stage;
            mbar_wait(empty(s), phase ^ 1);
            mbar_expect_tx(full(s), TILE);
            tma_load_2d(ring + s * TILE, &tmr, j * COLS, base, full(s));
            if (++stage == nstw) {
              stage = 0;
              phase ^= 1;
            }
          }
          if (second)
            stage1 = stage, phase1 = phase;
          else
            stage0 = stage, phase0 = phase;
        }
    }
    return;
  }

  // the query tile: by TMA (I8), or written by the consumer warps in the fragments' k order,
  // warp w its queries QPW w .. QPW w + QPW - 1, 16 bytes a load (queries past Q as zeros)
  constexpr int QPW = 16 / NWG;
  const int half = H / 2;
  if constexpr (KIND == SQ4) {  // dims j at bytes 0..63 of a slice's row, j + H/2 at 64..127
    const int per = H / 16;
    const int8_t* qi = static_cast<const int8_t*>(q);
#pragma unroll 4
    for (int idx = lane; idx < QPW * per; idx += 32) {
      const int r = QPW * warp + idx / per, d = 16 * (idx % per);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Q) v = __ldg(reinterpret_cast<const uint4*>(qi + (size_t)(q0 + r) * H + d));
      constexpr int ones = 0x01010101;  // the sum of four int8 by one dp4a
      atomicAdd(qsum + r, __dp4a((int)v.x, ones, __dp4a((int)v.y, ones,
                                 __dp4a((int)v.z, ones, __dp4a((int)v.w, ones, 0)))));
      const bool hi = d >= half;
      const int dd = hi ? d - half : d, b = (hi ? 64 : 0) + (dd & 63);
      *reinterpret_cast<uint4*>(g_q + (size_t)(dd >> 6) * TILE + r * 128 +
                                (((b >> 4) ^ (r & 7)) << 4)) = v;
    }
  } else if constexpr (KIND == BF4) {  // tile 2 s + hi: dims 64 s + o (+ H/2), permuted in 16s
    const int per = H / 8;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
#pragma unroll 4
    for (int idx = lane; idx < QPW * per; idx += 32) {
      const int r = QPW * warp + idx / per, d = 8 * (idx % per);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Q) v = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * H + d));
      const bool hi = d >= half;
      const int dd = hi ? d - half : d, o = dd & 63;
      // dims o .. o + 7 (o % 16 = 0 or 8): pairs at columns c, c + 8, c + 2, c + 10
      const int c = 16 * (o >> 4) + bf16_column(o & 15);
      unsigned char* row = g_q + (size_t)(2 * (dd >> 6) + hi) * TILE + r * 128;
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      const int cols[4] = {c, c + 8, c + 2, c + 10};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int b = 2 * cols[p];
        *reinterpret_cast<unsigned*>(row + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)) = w[p];
      }
    }
  } else if constexpr (KIND == BI8) {  // tile d / 64: dims permuted in 16s as BF4's
    const int per = 16 * NJ;  // 8 dims a load over the padded width (dims past H as zeros)
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
#pragma unroll 4
    for (int idx = lane; idx < QPW * per; idx += 32) {
      const int r = QPW * warp + idx / per, d = 8 * (idx % per);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Q && d < H)
        v = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * H + d));
      // dims d .. d + 7 (d % 16 = 0 or 8): pairs at columns c, c + 8, c + 2, c + 10
      const int c = 16 * ((d & 63) >> 4) + bf16_column(d & 15);
      unsigned char* row = g_q + (size_t)(d >> 6) * TILE + r * 128;
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      const int cols[4] = {c, c + 8, c + 2, c + 10};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int b = 2 * cols[p];
        *reinterpret_cast<unsigned*>(row + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)) = w[p];
      }
    }
  }
  if constexpr (INT8_Q)
    if (tid < QT) qs[tid] = q0 + tid < Q ? __ldg(qscale + q0 + tid) : 0.f;
  fence_proxy_async();
  named_sync(1, CONSUMERS);
  if constexpr (SS) mbar_wait(qbar, 0);  // also where no tile follows

  // warpgroup wg takes the row tiles wg, wg + NWG, ...; its thread ct = tid % 128 holds the
  // accumulator rows 16 (ct / 32) + g (+ 8) and, in the selection, query ct / 2's rows
  // 32 (ct % 2) .. + 31 of each tile
  const int wg = warp >> 2, wwarp = warp & 3, ct = tid & 127;
  const int g = lane >> 2, t4 = lane & 3;
  const int my_q = ct >> 1, my_half = ct & 1;
  unsigned* scores = score_tiles + wg * QT * SCP;
  auto wg_sync = [&]() { named_sync(2 + wg, 128); };
  // K12: the scales of the accumulator's queries 8 n + 2 t4 + e, [2 n + e]; SQ4: 8 x their
  // sums, which the biased codes (n + 8) add to the products. In registers, but for 32-key
  // lists (their 64 registers spilled these) read from shared memory at each tile.
  constexpr bool QREG = INT8_Q && NL < JMAX;
  float qsr[QREG ? 16 : 1];
  int qbias[QREG ? 16 : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        qsr[2 * n + e] = qs[8 * n + 2 * t4 + e];
        qbias[2 * n + e] = 8 * qsum[8 * n + 2 * t4 + e];
      }
  }
  u64 L[NL];
  unsigned floor;
  Acc acc[32];
  // the warpgroup's ring: stages wg nstw .. wg nstw + nstw - 1, its tiles' slices in sequence
  const int nstw = nst / NWG, ring0 = wg * nstw;
  int stage = ring0;
  unsigned phase = 0;
  auto next_stage = [&]() {
    if (++stage == ring0 + nstw) {
      stage = ring0;
      phase ^= 1;
    }
  };
  for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y) {
    const int blk_start = blk * block, lim = row_lim(blk);
#pragma unroll
    for (int p = 0; p < NL; ++p) L[p] = 0ull;
    floor = 0u;
    for (int base = blk_start + wg * TR; base < lim; base += NWG * TR) {
      // the scales of the thread's accumulator rows (fetched before the products; BB: none)
      const int r0 = base + 16 * wwarp + g;
      float sc0 = 1.f, sc1 = 1.f;
      if constexpr (KIND != BB) {
        sc0 = r0 < N ? __ldg(cscale + r0) : 0.f;
        sc1 = r0 + 8 < N ? __ldg(cscale + r0 + 8) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
      if constexpr (SS) {
        // a slice's stage is released once the products of the slice two on are issued and its
        // own are done: three groups in flight at most
        int held0 = -1, held1 = -1;  // the stages of the last two slices
        for (int j = 0; j < NJ; ++j) {
          mbar_wait(full(stage), phase);
          const uint32_t st = ring + stage * TILE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (KIND == I8)
              wgmma_s8_ss_n64(acc, sw128_desc(st + kk * 32, 16),
                              sw128_desc(qtile + j * TILE + kk * 32, 16), 1);
            else
              wgmma_ss_n64(acc, sw128_desc(st + kk * 32, 16),
                           sw128_desc(qtile + j * TILE + kk * 32, 16), 1);
          }
          wgmma_commit();
          if (j >= 2) {
            wgmma_wait<2>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(held0));
          }
          held0 = held1;
          held1 = stage;
          next_stage();
        }
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) {
          if (held0 >= 0) mbar_arrive(empty(held0));
          mbar_arrive(empty(held1));
        }
      } else {
        // the A fragments of a slice, one register set, built once the previous slice's
        // products are done (the other warpgroup's, or the other CTA's, run beside them). Two
        // sets picked by the slice's parity do not overlap: ptxas either serializes every wgmma
        // (C7513: a wait after each) or gives both sets the same registers while one is still
        // read (corrupt fragments; kernel_ab.py --sass, PERF.md).
        constexpr int KS = KIND == SQ4 ? 4 : 8;  // k steps a slice: k32 s8 or k16 bf16
        unsigned a0[KS][4];
        // the set a's fragments of slice s from the stage's words w (SQ4, BF4) or, BI8, straight
        // from the stage, which is then released; then the slice's products
        auto products = [&](unsigned (&a)[KS][4], const unsigned (&w)[2][4], int s) {
          wgmma_wait<0>();  // the group that read the set is done
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) fence_regs(a[kk]);
          if constexpr (KIND == SQ4) {
            slice_fragments<true>(a, w);
          } else if constexpr (KIND == BF4) {
            slice_fragments_bf16(a, w);
          } else {
            i8_fragments(a, g_ring + stage * TILE, wwarp, g, t4);
            __syncwarp();
            fence_proxy_async();  // the words are read before the stage's next TMA fill
            if (lane == 0) mbar_arrive(empty(stage));
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            if constexpr (KIND == SQ4)
              wgmma_s8_rs_n64(acc, a[kk], sw128_desc(qtile + s * TILE + kk * 32, 16), 1);
            else
              wgmma_rs_n64(acc, a[kk],
                           sw128_desc(qtile + (2 * s + (kk >> 2)) * TILE + (kk & 3) * 32, 16), 1);
          }
          wgmma_commit();
        };
        for (int j = 0; j < NJ; ++j) {
          if constexpr (KIND == BI8) {  // one slice a stage
            const unsigned none[2][4] = {};  // no words: the fragments come from the stage
            mbar_wait(full(stage), phase);
            products(a0, none, j);
          } else {
            const bool two = 2 * j + 1 < NS;  // the stage holds a second slice
            mbar_wait(full(stage), phase);
            unsigned w0[2][4], w1[2][4];
            const unsigned char* st = g_ring + stage * TILE;
            slice_words(w0, st, 0, wwarp, g, t4);
            products(a0, w0, 2 * j);
            // the second slice's words, read while the first's products run
            if (two) slice_words(w1, st, 1, wwarp, g, t4);
            // the words are in registers: the stage may be refilled once the generic reads are
            // ordered before the producer's TMA write (async proxy; without the fence, rows of the
            // stage's next fill were seen under two CTAs an SM)
            __syncwarp();
            fence_proxy_async();
            if (lane == 0) mbar_arrive(empty(stage));
            if (two) products(a0, w1, 2 * j + 1);
          }
          next_stage();
        }
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) fence_regs(a0[kk]);
      }
      // the scores of rows 16 w + g (+ 8) and queries 8 n + 2 t4 (+ 1), as their orders, into
      // the warpgroup's score tile [query][row]
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qq = 8 * n + 2 * t4 + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float sc = i ? sc1 : sc0;
            const Acc x = acc[4 * n + 2 * i + e];
            float v;
            if constexpr (KIND == BB) {
              v = x;
            } else if constexpr (!INT8_Q) {
              v = __fmul_rn(x, sc);
            } else {
              float qscale;
              int bias;
              if constexpr (QREG) {
                qscale = qsr[2 * n + e], bias = qbias[2 * n + e];
              } else {
                qscale = qs[qq], bias = 8 * qsum[qq];
              }
              // SQ4's sums (the biased products less 8 x the query's sum) are below 2^22 in
              // magnitude (H 127 8 at H <= 768): exact through the float whose low mantissa bits
              // they fill, with no conversion unit
              const float f =
                  KIND == SQ4 ? __fsub_rn(__int_as_float(x - bias + 0x4B400000), 12582912.f)
                              : __int2float_rn(x);
              v = __fmul_rn(__fmul_rn(f, sc), qscale);
            }
            // + zero: -0 keeps every score (serve); +0 makes a -0 score +0 (K6, certified)
            scores[qq * SCP + 16 * wwarp + g + 8 * i] = score_order(__fadd_rn(v, zero));
          }
        }
      wg_sync();
      if (q0 + my_q < Q) {  // thread ct: query ct / 2, rows 32 (ct % 2) .. + 31 of the tile
        const OrderRow o{scores + my_q * SCP + 32 * my_half};
        const unsigned long long cand =
            tile_candidates<32>(o, floor, lim - base - 32 * my_half);
        insert_candidates(L, floor, cand, o, base + 32 * my_half, J);
      }
      wg_sync();  // the score tile is read before the next tile's scores
    }
    if constexpr (NWG == 2) {  // warpgroup 1's lists join warpgroup 0's, through the score tiles
      u64* lists = reinterpret_cast<u64*>(score_tiles);  // [NL][128]
      named_sync(1, CONSUMERS);  // both are done with their score tiles
      if (wg == 1) {
#pragma unroll
        for (int p = 0; p < NL; ++p) lists[p * 128 + ct] = L[p];
      }
      named_sync(1, CONSUMERS);
      if (wg == 0) {
#pragma unroll
        for (int p = 0; p < NL; ++p) insert_sorted(L, lists[p * 128 + ct]);
        write_pair_lists(L, ct, q0, Q, blk, n_blocks, J, out_v, out_i);
      }
      named_sync(1, CONSUMERS);  // the lists are read before the next block's score tiles
    } else {
      write_pair_lists(L, ct, q0, Q, blk, n_blocks, J, out_v, out_i);
    }
  }
}

struct Args {
  CUtensorMap tmq, tmr;
  const void* q;
  const float *cscale, *qscale;
  float* out_v;
  int* out_i;
  int Q, N, H, n_valid, block, J, nst, nwg;
  float zero;  // added to every score: -0 (serve) or +0 (certified: -0 made +0)
  size_t smem;
  dim3 grid;
  cudaStream_t stream;
};

template <int KIND, int NL, int NWG>
int launch(const Args& a) {
  auto kernel = flat_serve_wgmma<KIND, NL, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = a.stream;
  kernel<<<a.grid, threads(NWG), a.smem, st>>>(a.tmq, a.tmr, a.q, a.cscale, a.qscale, a.out_v,
                                               a.out_i, a.Q, a.N, a.H, a.n_valid, a.block, a.J,
                                               a.nst, a.zero);
  return (int)cudaGetLastError();
}

// the list length: the least of 8, 16, 32 that holds J
template <int KIND, int NWG>
int launch_lists(const Args& a) {
  if (a.J <= 8) return launch<KIND, 8, NWG>(a);
  if (a.J <= 16) return launch<KIND, 16, NWG>(a);
  return launch<KIND, JMAX, NWG>(a);
}
template <int KIND>
int launch_kind(const Args& a) {
  return a.nwg == 1 ? launch_lists<KIND, 1>(a) : launch_lists<KIND, 2>(a);
}

}  // namespace

// 1 where drt_flat_serve takes the shape, else 0: int8 queries x int8 rows at H % 128 == 0 up
// to 1024, int8 or bf16 queries x int4 rows (packed [N, H/2]) at H % 128 == 0 up to 768, bf16
// queries x bf16 or int8 rows at H % 64 == 0 up to 1024, the queries and rows 16-byte aligned.
// Types as drt_block_topj's (1 bf16, 2 int8, 3 int4).
extern "C" int drt_flat_serve_takes(const void* q, const void* corpus, int H, int qtype,
                                    int ctype) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
  const int kind = kind_of(qtype, ctype);
  const int unit = kind == BB || kind == BI8 ? 64 : 128;
  if (kind < 0 || (ptrs & 15) != 0 || H < unit || H % unit != 0) return 0;
  if (H > (kind == SQ4 || kind == BF4 ? 768 : 1024)) return 0;
  int nwg;
  return stages(kind, H, nwg) >= 4;
}

// K5 / K6 / K8 / K11 / K12: q [Q, H] (qtype: bf16 or int8, with qscales [Q] fp32 for int8),
// corpus [N, H] bf16 or int8, or [N, H/2] packed int4 (ctype), with cscales [N] fp32 for int8
// and int4 rows -> out_vals [Q, ceil(N / block), J] fp32, out_ids int32: per (query, block) the
// J best pairs in the serve key order (cert: -0 made +0 first, the certified order; K5, K6), rows
// >= n_valid masked, empty entries (-inf, -1). Shapes: drt_flat_serve_takes.
extern "C" int drt_flat_serve(const void* q, const void* corpus, const void* cscales,
                              const void* qscales, void* out_v, void* out_i, int Q, int N, int H,
                              int n_valid, int block, int J, int qtype, int ctype, int cert,
                              void* stream) {
  const int kind = kind_of(qtype, ctype);
  if (J < 1 || J > JMAX || block < 1 || Q < 1 || N < 1 ||
      (ctype != T_BF16 && cscales == nullptr) || (qtype == T_I8 && qscales == nullptr) ||
      !drt_flat_serve_takes(q, corpus, H, qtype, ctype))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + block - 1) / block;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  Args a;
  if (kind == BB) {  // bf16 rows and queries: 64-dim boxes of 64 rows (hopper.cuh's cached maps)
    const cuuint64_t row_bytes[2] = {(cuuint64_t)H * 2, 0};
    const cuuint64_t qdims[3] = {(cuuint64_t)H, (cuuint64_t)Q, 1};
    const cuuint64_t rdims[3] = {(cuuint64_t)H, (cuuint64_t)N, 1};
    if (int e = tiled_map(&a.tmq, q, 2, qdims, row_bytes, TR)) return e;
    if (int e = tiled_map(&a.tmr, corpus, 2, rdims, row_bytes, TR)) return e;
  } else {
    const int row_bytes = kind == I8 || kind == BI8 ? H : H / 2;
    const cuuint64_t rdims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)N};
    const cuuint64_t rstrides[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t box[2] = {128, (cuuint32_t)TR};
    if (int e = tensor_map(&a.tmr, CU_TENSOR_MAP_DATA_TYPE_UINT8, corpus, 2, rdims, rstrides,
                           box, CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
    a.tmq = a.tmr;  // read only by the I8 body, which brings its query tile by TMA
    if (kind == I8) {
      const cuuint64_t qdims[2] = {(cuuint64_t)H, (cuuint64_t)Q};
      const cuuint64_t qstrides[1] = {(cuuint64_t)H};
      if (int e = tensor_map(&a.tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, qdims, qstrides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))
        return e;
    }
  }
  a.q = q;
  a.cscale = static_cast<const float*>(cscales);
  a.qscale = static_cast<const float*>(qscales);
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int*>(out_i);
  a.Q = Q, a.N = N, a.H = H, a.n_valid = n_valid, a.block = block, a.J = J;
  a.zero = cert ? 0.f : -0.f;
  a.nst = stages(kind, H, a.nwg);
  a.smem = smem_bytes(kind, H, a.nst, a.nwg);
  a.grid = dim3((Q + QT - 1) / QT,
                grid_blocks(n_blocks, (Q + QT - 1) / QT, block, a.nwg == 1 ? 2 : 1));
  a.stream = static_cast<cudaStream_t>(stream);
  if (kind == I8) return launch_kind<I8>(a);
  if (kind == SQ4) return launch_kind<SQ4>(a);
  if (kind == BF4) return launch_kind<BF4>(a);
  if (kind == BB) return launch_kind<BB>(a);
  return launch_kind<BI8>(a);
}
