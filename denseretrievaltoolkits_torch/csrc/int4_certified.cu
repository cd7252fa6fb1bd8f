// K10 on Hopper: the certified exact top-J of fp32 queries against nibble-packed int4 rows,
// products on s8 wgmma with exact query digits.
//
// Replaces, at the shapes drt_int4_certified_takes accepts, this TPU kernel of
// denseretrievaltoolkits_tpu/ops/topk.py:
//   K10 `_block_topj_kernel_sq4` (:237, launched by `_pallas_block_topj_sq4`, :288): exact
//       top-J over int4 rows, fp32 queries, true-fp32 scores times the row scale.
// block_topj.cu's FFMA body runs the other shapes (drt_block_topj dispatches by shape).
//
// What it computes: for each (query, storage block of `block` rows) the J best (score, id)
// pairs, score = (q . c) x scale_row with c the row's int4 codes, ties to the smaller id, rows
// >= n_valid masked, an empty entry (-inf, -1); output [Q, n_blocks, J]. Rows are [N, H/2]
// bytes in the column-half layout of ops/quant.py (K9): byte j holds dim j in its low nibble
// and dim j + H/2 in its high nibble.
//
// Exactness: the codes are integers in [-8, 7], so a product needs no fp32 multiplier. Each
// query is written once as the fixed-point integer v = round(q / e) with a per-query power
// of two e (the largest component's exponent; |v| < 2^23, so each component is off by at most
// e / 2, about 2^-23 of the largest), and v as three balanced base-256 digits
// v = d2 2^16 + d1 2^8 + d0 in [-128, 127]. The three digit planes against the codes are
// exact s8 x s8 -> s32 sums P2, P1, P0 (|P| <= H 128 8 < 2^20 at H <= 768); S = P2 2^16 + P1
// 2^8 + P0 is the exact integer v . c (in fp64, where it is exact), and the score is
// (float)(S e) x scale_row: one rounding of an exact sum, then the reference's scale
// multiply, then + 0 (a -0 score's key would sort below +0, which the certified order treats
// as equal). An all-zero query has v = 0 and scores +0.
//
// What bounds it on the H100: three s8 passes, 3 x 2 Q N H operations at 1,979 TOP/s (2.38
// ms at 1M rows x 768 x 1024 queries; fp32 FFMA products would be 23.48 ms at 67 TFLOP/s),
// and the rows, read from device memory once (the query tiles of a block run side by side
// in the grid and share them through L2).
//
// Design: one CTA a (64-query tile, storage block): one consumer warpgroup and one producer
// warp. Rows are the wgmma's M, queries its N.
// - Queries: each consumer warp reads its 16 fp32 queries once, two rows in flight, and
//   writes them into shared memory as the three digit planes (64 x H bytes each, 147,456
//   bytes at H = 768), one 128-byte swizzled 64 x 128 tile a plane and k-slice: the wgmma B
//   operand, resident for the block.
// - Rows: the producer brings each 64-row tile's packed rows by TMA, 128 bytes a row a stage
//   (two k-slices of 128 dims; 128-byte swizzle, so the fragment loads below take the fewest
//   wavefronts), into a 5-stage mbarrier ring. The warpgroup reads each slice's codes
//   straight into the wgmma A fragments (four packed words a thread, each giving the low
//   nibbles of its k32 steps 0-1 and the high nibbles of steps 2-3: dims j, then j + H/2,
//   the digit planes' order of k), so no expanded tile, proxy fence or barrier stands
//   between slices: a stage is free as soon as its words are in registers, and a slice's
//   fragments are built while the previous slice's products run (two register sets).
// - Products: m64n64k32 s8 wgmma with A from registers, three accumulators (P2, P1, P0: 96
//   registers a thread), four k32 steps a plane a slice.
// - Selection: the tile's scores go to a score tile [query][row] (pitch 68: the
//   accumulators' stores and the rows' reads both take the fewest wavefronts). For J <= 8
//   (the certified search's J) two threads own a query, each half the tile's rows, with its
//   own sorted list of 8 packed keys (serve_select.cuh's key, whose order is the certified
//   order): a row enters only past the list's J-th score (ties cannot enter: later rows
//   carry larger ids), by a register insertion with no chain between the list's entries; the
//   two lists merge at the end of the block. The candidates of a tile are first marked,
//   one bit a row, against the floor at the tile's start, so only they reach the insertion.
//   For J > 8 (the escalation's 32) one thread owns a query, every row, a list of 32 keys.
//   Keys are unpacked into (score, id) once. The selection (floor, bitmask, insertion, merge)
//   is serve_select.cuh's, the fragments int4_tiles.cuh's, both shared with flat_serve.cu.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "int4_tiles.cuh"
#include "serve_select.cuh"

using namespace drt;

namespace {

constexpr int QT = 64;           // queries a CTA: the wgmma N
constexpr int TR = 64;           // rows a tile: the wgmma M
constexpr int JMAX = 32;         // the list of a query, for J > JT
constexpr int JT = 8;            // the thread selection's list: J <= JT
constexpr int NST = 5;           // ring stages
constexpr int THREADS = 160;     // one consumer warpgroup and one producer warp
constexpr int PRODUCER_WARP = 4;
constexpr int SCP = TR + 4;      // score tile pitch, floats
constexpr uint32_t PLANE_TILE = QT * 128;   // a digit plane's k-slice: 64 x 128 bytes, swizzled
constexpr uint32_t STAGE = TR * STAGE_BYTES;  // a ring stage: 64 rows x 128 packed bytes
constexpr size_t SMEM_MAX = 232448;
static_assert(JT * 128 <= QT * JMAX, "both lists' layouts share one space");

__host__ __device__ inline size_t smem_bytes(int H) {
  return 1024 + 3 * (size_t)(H / 128) * PLANE_TILE + NST * STAGE + sizeof(float) * QT * SCP +
         sizeof(u64) * QT * JMAX + sizeof(double) * QT + sizeof(float) * TR +
         sizeof(unsigned) * 128 + 2 * NST * 8;
}

// The exponent shift of a query whose largest |component| is m: v = round(q 2^sh) with
// |v| <= 8,355,711, the largest three balanced base-256 digits hold (127 (2^16 + 2^8 + 1)).
__device__ __forceinline__ int digit_shift(float m) {
  if (!(m > 0.f)) return 0;  // an all-zero query: every digit 0
  int E;
  frexpf(m, &E);  // m = f 2^E, f in [0.5, 1)
  const int sh = 23 - E;
  return rintf(ldexpf(m, sh)) > 8355711.f ? sh - 1 : sh;
}

// 2^e as a float, for |e| <= 126
__device__ __forceinline__ float pow2f(int e) { return __int_as_float((127 + e) << 23); }

// an integer below 2^31 in magnitude, exactly, as a double (no conversion unit)
__device__ __forceinline__ double exact_double(int x) {
  return __hiloint2double(0x43300000, x ^ 0x80000000) - 4503601774854144.0;  // 2^52 + 2^31
}

// The orders of a tile row's scores for the selection (serve_select.cuh): each row's sum (srow)
// times its scale (crow), + 0 (the certified order: -0 is +0); four rows or one.
struct ScaledRow {
  const float* srow;
  const float* crow;
  __device__ __forceinline__ void operator()(int k, unsigned (&o)[4]) const {
    const float4 s4 = *reinterpret_cast<const float4*>(srow + 4 * k);
    const float4 c4 = *reinterpret_cast<const float4*>(crow + 4 * k);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = score_order(__fadd_rn(__fmul_rn(sv[e], cv[e]), 0.f));
  }
  __device__ __forceinline__ unsigned operator()(int b) const {
    return score_order(__fadd_rn(__fmul_rn(srow[b], crow[b]), 0.f));
  }
};

__global__ void __launch_bounds__(THREADS, 1)
int4_certified_wgmma(const __grid_constant__ CUtensorMap tmr, const float* __restrict__ q,
                     const float* __restrict__ cscale, float* __restrict__ out_v,
                     int* __restrict__ out_i, int Q, int N, int H, int n_valid, int block,
                     int J) {
  extern __shared__ unsigned char smem_raw[];
  const int NS = H / 128, NJ = (NS + 1) / 2;  // k-slices, ring stages a tile
  const uint32_t digits = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* g_digits = smem_raw + (digits - smem_addr(smem_raw));
  const uint32_t ring = digits + 3 * NS * PLANE_TILE;
  unsigned char* g_ring = g_digits + 3 * NS * PLANE_TILE;
  float* scores = reinterpret_cast<float*>(g_ring + NST * STAGE);  // [QT][SCP]
  // the lists, slot-major (a thread's list in one column): [JT][128] for J <= JT, [JMAX][QT]
  // for J > JT
  u64* lists = reinterpret_cast<u64*>(scores + QT * SCP);
  double* step = reinterpret_cast<double*>(lists + QT * JMAX);       // [QT]: 2^-sh
  float* tile_scale = reinterpret_cast<float*>(step + QT);           // [TR]
  unsigned* floors = reinterpret_cast<unsigned*>(tile_scale + TR);  // [128]: the lists' floors
  const uint32_t bars = smem_addr(floors + 128);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, blk = blockIdx.y;
  const int blk_start = blk * block;
  const int row_lim = min(min(N, blk_start + block), n_valid);  // rows at or past it: masked
  const bool thread_lists = J <= JT;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int base = blk_start; base < row_lim; base += TR)
        for (int j = 0; j < NJ; ++j) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), STAGE);
          tma_load_2d(ring + stage * STAGE, &tmr, j * STAGE_BYTES, base, full(stage));
          if (++stage == NST) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // the digit planes: warp w takes queries 16 w .. 16 w + 15, two at a time (the next pair's
  // row loads in flight while a pair is written); a lane holds 4 consecutive dims of a row a
  // float4 (one word a plane), the query's largest |component| from the same registers, then
  // q 2^sh as two exact power-of-two products (each factor a normal float), rounded
  const int half = H / 2, nv = H / 128;  // float4s a lane holds of a row (H <= 768: <= 6)
  float4 rows[2][6];
  auto load_pair = [&](int j) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * warp + j + u;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        rows[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nv && q0 + r < Q)
          rows[u][i] = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * H) + lane +
                             32 * i);
      }
    }
  };
  load_pair(0);
  for (int j = 0; j < 16; j += 2) {
    float4 cur[2][6];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 6; ++i) cur[u][i] = rows[u][i];
    if (j + 2 < 16) load_pair(j + 2);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * warp + j + u;
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        m = fmaxf(m, fmaxf(fmaxf(fabsf(cur[u][i].x), fabsf(cur[u][i].y)),
                           fmaxf(fabsf(cur[u][i].z), fabsf(cur[u][i].w))));
      const int sh = digit_shift(warp_max(m)), sa = sh / 2;
      if (lane == 0) step[r] = ldexp(1.0, -sh);
      const float fa = pow2f(sa), fb = pow2f(sh - sa);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (i >= nv) break;
        const float x[4] = {cur[u][i].x, cur[u][i].y, cur[u][i].z, cur[u][i].w};
        unsigned w2 = 0u, w1 = 0u, w0 = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int iv = __float2int_rn((x[e] * fa) * fb);
          const int d0 = (int)(signed char)iv;
          const int i1 = (iv - d0) >> 8;
          const int d1 = (int)(signed char)i1;
          const int d2 = (i1 - d1) >> 8;
          w2 |= (unsigned)(d2 & 255) << (8 * e);
          w1 |= (unsigned)(d1 & 255) << (8 * e);
          w0 |= (unsigned)(d0 & 255) << (8 * e);
        }
        const int c = 4 * (lane + 32 * i);  // the dim of x[0]
        const bool hi = c >= half;
        const int cc = hi ? c - half : c, b = (hi ? 64 : 0) + (cc & 63);
        const uint32_t off = (uint32_t)((cc >> 6) * QT + r) * 128 + (((b >> 4) ^ (r & 7)) << 4) +
                             (b & 15);
        *reinterpret_cast<unsigned*>(g_digits + off) = w2;
        *reinterpret_cast<unsigned*>(g_digits + NS * PLANE_TILE + off) = w1;
        *reinterpret_cast<unsigned*>(g_digits + 2 * NS * PLANE_TILE + off) = w0;
      }
    }
  }
  for (int i = tid; i < QT * JMAX; i += 128) lists[i] = 0ull;
  floors[tid] = 0u;
  fence_proxy_async();
  consumers_sync();

  const int g = lane >> 2, t4 = lane & 3;
  const int my_q = tid >> 1, my_half = tid & 1;  // the thread selection's query and half
  int acc[3][32];           // P2, P1, P0: rows 16 w + g (+ 8), queries 8 n + 2 t4 (+ 1)
  unsigned a0[4][4], a1[4][4];  // the A fragments of the stage's two slices
  int stage = 0;
  unsigned phase = 0;
  // one slice's products: the three planes against its fragments
  auto products = [&](const unsigned (&a)[4][4], int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wgmma_s8_rs_n64(acc[p], a[kk],
                        sw128_desc(digits + (p * NS + s) * PLANE_TILE + kk * 32, 16), 1);
    wgmma_commit();
  };
  for (int base = blk_start; base < row_lim; base += TR) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0;
    for (int j = 0; j < NJ; ++j) {
      const bool two = 2 * j + 1 < NS;  // the stage holds a second slice
      mbar_wait(full(stage), phase);
      unsigned w0[2][4], w1[2][4];
      const unsigned char* st = g_ring + stage * STAGE;
      slice_words(w0, st, 0, warp, g, t4);
      if (two) slice_words(w1, st, 1, warp, g, t4);
      // the words are in registers: the generic reads ordered before the TMA's refill
      __syncwarp();
      fence_proxy_async();
      if (lane == 0) mbar_arrive(empty(stage));
      // a0 was read by slice 2 j - 2: done once at most one group (slice 2 j - 1) is pending
      wgmma_wait<1>();
      fence_regs(a0[0]), fence_regs(a0[1]), fence_regs(a0[2]), fence_regs(a0[3]);
      slice_fragments(a0, w0);
      products(a0, 2 * j);
      if (two) {
        wgmma_wait<1>();  // slice 2 j - 1 (a1) is done
        fence_regs(a1[0]), fence_regs(a1[1]), fence_regs(a1[2]), fence_regs(a1[3]);
        slice_fragments(a1, w1);
        products(a1, 2 * j + 1);
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < 3; ++p) fence_regs(acc[p]);
    fence_regs(a0[0]), fence_regs(a0[1]), fence_regs(a0[2]), fence_regs(a0[3]);
    fence_regs(a1[0]), fence_regs(a1[1]), fence_regs(a1[2]), fence_regs(a1[3]);
    // S = P2 2^16 + P1 2^8 + P0 of rows 16 w + g (+ 8) and queries 8 n + 2 t4 (+ 1), times the
    // query's step e, rounded once, into the score tile [query][row]; the rows' scales
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qq = 8 * n + 2 * t4 + e;
        const double st = step[qq];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = 4 * n + 2 * i + e;
          const double S = fma(exact_double(acc[0][a] * 256 + acc[1][a]), 256.0,
                               exact_double(acc[2][a]));
          scores[qq * SCP + 16 * warp + g + 8 * i] = __double2float_rn(S * st);
        }
      }
    if (tid < TR) tile_scale[tid] = base + tid < row_lim ? __ldg(cscale + base + tid) : 0.f;
    consumers_sync();
    const int n_rows = row_lim - base;  // the tile's stored rows
    if (thread_lists) {  // thread t: query t / 2, rows 32 (t % 2) .. + 31, a list of JT
      if (q0 + my_q < Q) {
        const ScaledRow o{scores + my_q * SCP + 32 * my_half, tile_scale + 32 * my_half};
        select_rows<JT, 32>(lists + tid, 128, floors + tid, o, o, n_rows - 32 * my_half,
                            base + 32 * my_half, J);
      }
    } else if (tid < QT && q0 + tid < Q) {  // thread t: query t, every row, a list of JMAX
      const ScaledRow o{scores + tid * SCP, tile_scale};
      select_rows<JMAX, TR>(lists + tid, QT, floors + tid, o, o, n_rows, base, J);
    }
    consumers_sync();  // the score tile is read before the next tile's scores
  }

  const int n_blocks = gridDim.y;
  if (thread_lists) {  // the two halves' lists of a query merge in its even thread
    u64 L[JT];
#pragma unroll
    for (int p = 0; p < JT; ++p) L[p] = lists[p * 128 + tid];
    write_pair_lists(L, tid, q0, Q, blk, n_blocks, J, out_v, out_i);
    return;
  }
  if (tid < QT && q0 + tid < Q) {
    const size_t o = ((size_t)(q0 + tid) * n_blocks + blk) * J;
    for (int p = 0; p < J; ++p) {
      const u64 key = lists[p * QT + tid];
      out_v[o + p] = key == 0ull ? -INFINITY : key_score(key);
      out_i[o + p] = key == 0ull ? -1 : key_row(key);
    }
  }
}

}  // namespace

// 1 where drt_int4_certified takes the shape: H % 128 == 0, the digit planes and buffers in
// shared memory (H <= 768), the queries and rows 16-byte aligned; else 0.
extern "C" int drt_int4_certified_takes(const void* q, const void* corpus, int H) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
  return H >= 128 && H % 128 == 0 && (ptrs & 15) == 0 && smem_bytes(H) <= SMEM_MAX;
}

// K10: q [Q, H] fp32, corpus [N, H/2] packed int4 (column halves), scales [N] fp32 -> out_vals
// [Q, ceil(N / block), J] fp32, out_ids int32: per (query, block) the J best pairs (score
// descending, ties to the smaller id), rows >= n_valid masked, empty entries (-inf, -1).
// Shapes: drt_int4_certified_takes.
extern "C" int drt_int4_certified(const void* q, const void* corpus, const void* scales,
                                  void* out_v, void* out_i, int Q, int N, int H, int n_valid,
                                  int block, int J, void* stream) {
  if (J < 1 || J > JMAX || block < 1 || Q < 1 || N < 1 || scales == nullptr ||
      !drt_int4_certified_takes(q, corpus, H))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + block - 1) / block;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tmr;
  const cuuint64_t dims[2] = {(cuuint64_t)(H / 2), (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)(H / 2)};
  const cuuint32_t box[2] = {(cuuint32_t)STAGE_BYTES, (cuuint32_t)TR};
  if (int e = tensor_map(&tmr, CU_TENSOR_MAP_DATA_TYPE_UINT8, corpus, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(int4_certified_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + QT - 1) / QT, n_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4_certified_wgmma<<<grid, THREADS, smem, st>>>(
      tmr, static_cast<const float*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, N, H, n_valid, block, J);
  return (int)cudaGetLastError();
}
