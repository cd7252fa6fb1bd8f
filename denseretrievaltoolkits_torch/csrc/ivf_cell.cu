// The IVF cell kernels K13 and K14 on Hopper: empty query slots and empty row tiles skipped,
// products on wgmma + TMA (bf16, int8 rows, i8q) or FFMA (fp32), and an exact serve selection
// built for J of 20-32.
//
// Replaces these TPU kernels of denseretrievaltoolkits_tpu/ops/ivf_bulk.py (serve selection):
//   K13 `_cell_topj_kernel` / `_scaled` / `_i8q` (:44, :61, :143; `_ivf_cell_topj`, :122): per
//       (cell, cell block) the cell's probing-query slab [Qcap, H] against the block's rows of
//       the fixed-capacity layout [nlist * C, H], empty row slots (row id < 0) masked;
//   K14 `_ragged_kernel` / `_scaled` / `_i8q` (:165, :184, :202; `_ivf_ragged_topj`, :272):
//       the same over the ragged padded-flat block list, whose block -> cell map picks the slab.
// For each (storage block, selection block of `sel` rows, slot) the J best (score, id) pairs
// under the serve key of serve_select.cuh (exact fp32 score, ties to the smaller flat id),
// written cell-major [n_sel, Qcap, J] (an empty entry is (-inf, -1)). Formulas: fp32 cells
// score fp32 slots in true fp32 (FFMA, no TF32); bf16 cells bf16 products with fp32 sums;
// int8 cells under bf16 slots convert int8 -> bf16 (exact) and multiply the row scale after
// the sum; i8q runs s8 x s8 -> s32, then float(s32) * scale_row * scale_slot, in that order.
//
// What bounds it on the H100: the rows the probed cells hold, read once (0.26-0.98 ms at 1M
// rows x 768, 2.04 ms at 8.8M int8 rows), and the real (slot, row) products (about 0.1 ms
// in bf16 at 1M). The block top-J family's body (block_topj.cu) computed every one of the
// Qcap slots (mean fill a quarter) against every row of the layout (C = 4096 holds about
// 977 rows a cell), then merged each 128-row tile into each slot's list by J rounds of warp
// argmax: padding and the selection, not the products, held it at 18-70x its bound.
//
// Design:
// - Work: one CTA a (64-slot tile, storage block). The wrapper passes `slots` [nlist], each
//   cell's filled slots (real probe pairs take a cell's first slots): a CTA whose tile starts
//   at or past its cell's count writes (-inf, -1) lists and leaves; inside a CTA, the slots
//   past the count are neither merged nor read. A 128-row tile whose row ids are all < 0 is
//   neither loaded nor scored: every warp decides it from the ids (one vote), so the layout
//   need not fill cells from the front. The grid stays the launched shape: no host sync.
// - Products, bf16 / int8 rows / i8q (`ivf_cell_wgmma`): one consumer warpgroup and one
//   producer warp. The producer brings k-slices of the cell's 64 slots (a 3-D map over the
//   slab [nlist, Qcap, H], rows past Qcap zero-filled) and of the tile's 128 rows by TMA
//   (128-byte swizzle) into a 2-stage mbarrier ring; the warpgroup runs m64n128 wgmma (slots
//   as M, rows as N), fp32 sums for bf16 and s32 sums (k32) for i8q. int8 rows under bf16
//   slots arrive unswizzled as int8 and the warpgroup rewrites them as a swizzled bf16 tile
//   (an exact conversion by byte permutes) before the wgmma reads it. Slots are M = 64
//   whatever a cell's fill: at 1M rows the real products cost about 0.1 ms in bf16 even
//   with every tile padded to 64 slots, while the selection and the bytes scale with the
//   real slots and rows only, so one shape (and two CTAs an SM at 101 KB of shared memory)
//   serves every fill.
// - Products, fp32 (`ivf_cell_ffma`): 8 warps, each 8 slots x 128 rows by register-tiled
//   FFMA over K chunks staged transposed in shared memory; a warp whose 8 slots are all past
//   the count skips its products.
// - Selection (`merge_tile`): each warp owns its slots' running lists (32 packed keys a slot
//   in shared memory, the first J kept) and reads each of its filled slots' 128 scores from
//   a score tile, 4 a lane. Candidates must beat the list's J-th key (a tie cannot enter:
//   the tile's ids are larger). Up to 32 of them are inserted one by one (ballot for the
//   place, one shuffle to shift the list); more (a selection block's first tile) take a
//   warp-wide bitonic pass: the four 32-key columns sorted in alternating directions, their
//   top 32 by elementwise max and half-cleaners, then merged with the list the same way.
//   That costs about one pass over the tile's keys, where the J argmax rounds cost J; the
//   lists stay exact (the keys a full merge keeps).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "serve_select.cuh"

using namespace drt;

namespace {

using bf = __nv_bfloat16;

constexpr int JMAX = 32;        // one list entry a lane
constexpr int SLOTS = 64;       // slots a CTA: the wgmma M, the FFMA body's query tile
constexpr int TR = 128;         // rows a tile
constexpr int SCP = TR + 8;     // score tile pitch, floats: the accumulators' float2 stores
                                // take two wavefronts, a lane's reads one
constexpr int INSERT_MAX = 32;  // candidates a slot inserts one by one; more: bitonic
constexpr size_t SMEM_MAX = 232448;

enum { T_F32 = 0, T_BF16 = 1, T_I8 = 2 };

// What the CTAs of one launch share.
struct Job {
  const int* row_ids;     // [N] flat row -> corpus id, -1 = empty
  const int* block_cell;  // K14: [N / block] storage block -> cell; null: blk / cell_blocks
  const int* slots;       // [nlist] filled slots of each cell; null: all Qcap
  const float* cscale;    // [N] row scales (int8 cells), else null
  const float* qscale;    // [nlist, Qcap] slot scales (i8q), else null
  float* out_v;
  int* out_i;
  int Qcap, N, H, block, sel, J, cell_blocks;
};

__device__ __forceinline__ int cell_of(const Job& jb, int blk) {
  return jb.block_cell != nullptr ? __ldg(jb.block_cell + blk) : blk / jb.cell_blocks;
}

__device__ __forceinline__ int filled_slots(const Job& jb, int cell) {
  const int c = jb.slots != nullptr ? __ldg(jb.slots + cell) : jb.Qcap;
  return min(max(c, 0), jb.Qcap);
}

// (-inf, -1) in every list of slots s_lo .. s_hi - 1 of storage block blk
__device__ void write_empty(const Job& jb, int blk, int s_lo, int s_hi, int tid, int nthreads) {
  const int per = (jb.block + jb.sel - 1) / jb.sel;
  const int n = (s_hi - s_lo) * jb.J;
  for (int idx = tid; idx < per * n; idx += nthreads) {
    const int sb = idx / n, rem = idx - sb * n;
    const size_t o = ((size_t)(blk * per + sb) * jb.Qcap + s_lo) * jb.J + rem;
    jb.out_v[o] = -INFINITY;
    jb.out_i[o] = -1;
  }
}

// The rows base + lane + 32 r (r < 4) of a tile that are stored rows below lim (the
// selection block's end), and whether the tile has any: every warp reaches the same answer.
struct TileRows {
  bool valid[4];
  bool any;
};

__device__ __forceinline__ TileRows tile_rows(const Job& jb, int base, int lim, int lane) {
  TileRows t;
  bool a = false;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = base + lane + 32 * r;
    t.valid[r] = row < lim && __ldg(jb.row_ids + row) >= 0;
    a |= t.valid[r];
  }
  t.any = __any_sync(0xffffffffu, a);
  return t;
}

// ---- the selection ---------------------------------------------------------------------

// one compare-exchange step with lane ^ j: keep the smaller key where keep_min
__device__ __forceinline__ u64 cx(u64 v, int j, bool keep_min) {
  const u64 p = __shfl_xor_sync(0xffffffffu, v, j);
  return keep_min ? (p < v ? p : v) : (p > v ? p : v);
}

// a bitonic sequence of 32 keys (one a lane) sorted, ascending if asc
__device__ __forceinline__ u64 clean32(u64 v, bool asc, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) v = cx(v, j, ((lane & j) == 0) == asc);
  return v;
}

__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }

// The list L (sorted descending, one key a lane) and the 128 keys k (4 a lane) -> the top 32
// of both, sorted descending: the four key columns sorted across the warp (0 and 2
// descending, 1 and 3 ascending), the top 32 of each pair by elementwise max (a bitonic
// sequence) and a half-cleaner cascade, the same for the two halves, then with the list.
__device__ __forceinline__ u64 merge_bitonic(u64 L, u64 (&k)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool asc = ((lane & size) == 0) == (r & 1);
        k[r] = cx(k[r], j, ((lane & j) == 0) == asc);
      }
  const u64 a = clean32(kmax(k[0], k[1]), false, lane);
  const u64 b = clean32(kmax(k[2], k[3]), true, lane);
  const u64 c = clean32(kmax(a, b), true, lane);
  return clean32(kmax(L, c), false, lane);
}

// key x into the list L (sorted descending, one key a lane): the lanes above its place keep
// theirs, the others take their upper neighbour's; lane 31's key falls off
__device__ __forceinline__ u64 insert_key(u64 L, u64 x, int lane) {
  const int p = __popc(__ballot_sync(0xffffffffu, L > x));
  const u64 up = __shfl_up_sync(0xffffffffu, L, 1);
  return lane < p ? L : (lane == p ? x : up);
}

// One slot's tile of candidate keys k (4 a lane, 0: masked) into its list (32 keys in shared
// memory, sorted descending, 0 = empty; the first J are the result).
__device__ __forceinline__ void merge_tile(u64 (&k)[4], u64* list, int J, int lane) {
  const u64 thr = list[J - 1];
  unsigned m[4];
  int c = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = __ballot_sync(0xffffffffu, k[r] > thr);
    c += __popc(m[r]);
  }
  if (c == 0) return;
  u64 L = list[lane];
  if (c <= INSERT_MAX) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      for (unsigned mm = m[r]; mm != 0u; mm &= mm - 1u)
        L = insert_key(L, __shfl_sync(0xffffffffu, k[r], __ffs(mm) - 1), lane);
  } else {
    L = merge_bitonic(L, k, lane);
  }
  __syncwarp();  // every lane has read the list
  list[lane] = L;
  __syncwarp();
}

// The candidate keys of one slot's row of the score tile: column lane + 32 r is flat row
// base + lane + 32 r, x the row scale (int8 cells), x the slot scale (i8q), the reference's
// order; masked rows are 0.
template <bool CS, bool QS>
__device__ __forceinline__ void slot_keys(u64 (&k)[4], const float* srow, const TileRows& tr,
                                          const float (&cs)[4], float qs, int base, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = srow[lane + 32 * r];
    if constexpr (CS) v = v * cs[r];
    if constexpr (QS) v = v * qs;
    k[r] = tr.valid[r] ? pack_key(v, base + lane + 32 * r) : 0ull;
  }
}

// The lists of n slots (the CTA's slots sl0 .. sl0 + n - 1, lists 32 keys apart) of selection
// block sbi into the output, the first `mine` from the lists (which are then emptied), the
// rest (-inf, -1); one warp.
__device__ __forceinline__ void write_lists(const Job& jb, u64* lists, int sbi, int slot0, int n,
                                            int mine, int lane) {
  for (int j = 0; j < n; ++j) {
    const size_t o = ((size_t)sbi * jb.Qcap + slot0 + j) * jb.J + lane;
    u64 key = 0ull;
    if (j < mine) {
      key = lists[j * JMAX + lane];
      lists[j * JMAX + lane] = 0ull;
    }
    if (lane < jb.J) {
      jb.out_v[o] = key == 0ull ? -INFINITY : key_score(key);
      jb.out_i[o] = key == 0ull ? -1 : key_row(key);
    }
  }
  __syncwarp();
}

// ---- the wgmma body (bf16 slots x bf16 rows, bf16 slots x int8 rows, int8 x int8) -------

enum { K_BF16 = 0, K_I8ROWS = 1, K_I8Q = 2 };

constexpr int NST = 2;           // ring stages
constexpr int WG_THREADS = 160;  // one consumer warpgroup and one producer warp
constexpr int PRODUCER_WARP = 4;

template <int KIND>
struct Wg {
  static constexpr int KS = KIND == K_I8Q ? 128 : 64;  // k elements a slice: 128 bytes
  static constexpr uint32_t A_BYTES = SLOTS * 128;     // the slots' slice, swizzled
  // the rows' slice: swizzled 128-byte rows, or int8 rows of 64 bytes (converted after)
  static constexpr uint32_t B_BYTES = KIND == K_I8ROWS ? TR * 64 : TR * 128;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static constexpr uint32_t CONV = KIND == K_I8ROWS ? TR * 128 : 0;  // the rows as bf16
  static constexpr size_t SMEM = 1024 + NST * STAGE + CONV + sizeof(float) * SLOTS * SCP +
                                 sizeof(u64) * SLOTS * JMAX + 2 * NST * 8;
};
static_assert(Wg<K_BF16>::SMEM <= SMEM_MAX / 2 && Wg<K_I8ROWS>::SMEM <= SMEM_MAX / 2 &&
                  Wg<K_I8Q>::SMEM <= SMEM_MAX / 2,
              "two CTAs of the wgmma body must fit an SM");

// d (m64n128, s32) = A.B^T, or d += A.B^T with accumulate: A and B int8 in shared memory,
// both K-major (k32); accumulator layout as wgmma_ss_n128's
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keep the compiler from moving accesses of wgmma accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory writes of the generic proxy (the converted rows) made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warpgroup's own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// four int8 (one word, k in byte order) -> four bf16 in two words, exactly: each biased byte
// u = x + 128 becomes the float 2^23 + u, minus 2^23 + 128 leaves x, whose low 16 bits are
// zero (|x| <= 128), so its bf16 is its high half
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned b = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The tile's int8 rows [TR][64 bytes] -> bf16 [TR][128 bytes] in the 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8)); the warpgroup's 128 threads take 16 bytes of int8 each time
__device__ __forceinline__ void convert_rows(const unsigned char* src, unsigned char* dst,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 128 * i, r = idx >> 2, q = idx & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * 64 + q * 16);
    uint4 a, b;
    i8x4_to_bf16(v.x, a.x, a.y);
    i8x4_to_bf16(v.y, a.z, a.w);
    i8x4_to_bf16(v.z, b.x, b.y);
    i8x4_to_bf16(v.w, b.z, b.w);
    *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * q) ^ (r & 7)) << 4)) = a;
    *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * q + 1) ^ (r & 7)) << 4)) = b;
  }
}

template <int KIND>
__global__ void __launch_bounds__(WG_THREADS, 2)
ivf_cell_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmr,
               Job jb) {
  using W = Wg<KIND>;
  using Acc = std::conditional_t<KIND == K_I8Q, int, float>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (ring - smem_addr(smem_raw));
  const uint32_t conv = ring + NST * W::STAGE;
  float* scores = reinterpret_cast<float*>(gbase + NST * W::STAGE + W::CONV);
  u64* lists = reinterpret_cast<u64*>(scores + SLOTS * SCP);
  const uint32_t bars = smem_addr(lists + SLOTS * JMAX);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.y, s_lo = blockIdx.x * SLOTS;
  const int cell = cell_of(jb, blk);
  const int cnt = filled_slots(jb, cell);
  const int s_hi = min(jb.Qcap, s_lo + SLOTS);
  if (s_lo >= cnt) {  // no filled slot in this tile
    write_empty(jb, blk, s_lo, s_hi, tid, WG_THREADS);
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per = (jb.block + jb.sel - 1) / jb.sel;
  const int blk_start = blk * jb.block;
  const int ns = jb.H / W::KS;

  if (warp == PRODUCER_WARP) {
    int stage = 0;
    unsigned phase = 0;
    for (int sb = 0; sb < per; ++sb) {
      const int s0 = blk_start + sb * jb.sel, s_end = min(blk_start + jb.block, s0 + jb.sel);
      for (int base = s0; base < s_end; base += TR) {
        if (!tile_rows(jb, base, s_end, lane).any) continue;
        if (lane == 0)
          for (int s = 0; s < ns; ++s) {
            mbar_wait(empty(stage), phase ^ 1);
            const uint32_t st = ring + stage * W::STAGE;
            mbar_expect_tx(full(stage), W::STAGE);
            tma_load_3d(st, &tmq, s * W::KS, s_lo, cell, full(stage));
            tma_load_2d(st + W::A_BYTES, &tmr, s * W::KS, base, full(stage));
            if (++stage == NST) {
              stage = 0;
              phase ^= 1;
            }
          }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warp w owns the CTA's slots 16 w .. 16 w + 15 (accumulator rows g and g + 8
  // of its 16), of which `mine` are filled
  const int g = lane >> 2, t4 = lane & 3;
  u64* my_lists = lists + warp * 16 * JMAX;
  for (int i = lane; i < 16 * JMAX; i += 32) my_lists[i] = 0ull;
  __syncwarp();
  const int mine = min(max(cnt - s_lo - 16 * warp, 0), 16);
  const int n_here = min(max(s_hi - s_lo - 16 * warp, 0), 16);
  Acc acc[64];
  int stage = 0;
  unsigned phase = 0;
  for (int sb = 0; sb < per; ++sb) {
    const int s0 = blk_start + sb * jb.sel, s_end = min(blk_start + jb.block, s0 + jb.sel);
    for (int base = s0; base < s_end; base += TR) {
      const TileRows tr = tile_rows(jb, base, s_end, lane);
      if (!tr.any) continue;
      // zeroed here, the sums are dead during the selection
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      int prev = 0;
      for (int s = 0; s < ns; ++s) {
        mbar_wait(full(stage), phase);
        const uint32_t st = ring + stage * W::STAGE;
        if constexpr (KIND == K_I8ROWS) {
          if (s > 0) {  // the previous slice's products are done: its rows and stage are free
            wgmma_wait<0>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(prev));
          }
          convert_rows(gbase + stage * W::STAGE + W::A_BYTES, gbase + NST * W::STAGE, tid);
          fence_proxy_async();
          consumers_sync();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128(acc, sw128_desc(st + kk * 32, 16), sw128_desc(conv + kk * 32, 16), 1);
          wgmma_commit();
        } else {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (KIND == K_I8Q)
              wgmma_s8_n128(acc, sw128_desc(st + kk * 32, 16),
                            sw128_desc(st + W::A_BYTES + kk * 32, 16), 1);
            else
              wgmma_ss_n128(acc, sw128_desc(st + kk * 32, 16),
                            sw128_desc(st + W::A_BYTES + kk * 32, 16), 1);
          }
          wgmma_commit();
          if (s > 0) {  // the previous slice's products are done: release its stage
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(prev));
          }
        }
        prev = stage;
        if (++stage == NST) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(prev));
      // the sums of slot rows 16 w + g (+ 8) at columns 8 n + 2 t4 (+ 1) into the score tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = scores + (16 * warp + g + 8 * i) * SCP + 2 * t4;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(row + 8 * n) =
              make_float2((float)acc[4 * n + 2 * i], (float)acc[4 * n + 2 * i + 1]);
      }
      __syncwarp();
      float cs[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (KIND != K_BF16) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (tr.valid[r]) cs[r] = __ldg(jb.cscale + base + lane + 32 * r);
      }
      for (int j = 0; j < mine; ++j) {
        const int sl = 16 * warp + j;
        u64 k[4];
        if constexpr (KIND == K_I8Q)
          slot_keys<true, true>(k, scores + sl * SCP, tr, cs,
                                __ldg(jb.qscale + (size_t)cell * jb.Qcap + s_lo + sl), base,
                                lane);
        else
          slot_keys<KIND == K_I8ROWS, false>(k, scores + sl * SCP, tr, cs, 1.f, base, lane);
        merge_tile(k, my_lists + j * JMAX, jb.J, lane);
      }
      __syncwarp();  // the tile is read before the next one is stored
    }
    write_lists(jb, my_lists, blk * per + sb, s_lo + 16 * warp, n_here, mine, lane);
  }
}

// ---- the FFMA body (fp32 slots x fp32 rows) ----------------------------------------------

constexpr int FF_THREADS = 256;
constexpr int KT = 32;            // K chunk staged in shared memory
constexpr int LDQT = SLOTS + 4;   // chunk rows: float4-aligned, conflict-free column stores
constexpr int LDCT = TR + 4;
constexpr size_t FF_SMEM = sizeof(float) * ((size_t)KT * LDQT + (size_t)KT * LDCT + SLOTS * SCP) +
                           sizeof(u64) * SLOTS * JMAX;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// The K chunk a thread stages: VEC (H % 4 == 0, 16-byte aligned) as float4 of 4 consecutive
// k, else single elements; consecutive threads read consecutive k of one row. Held in
// registers while the previous chunk is scored, then stored transposed.
template <bool VEC>
struct Chunk {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int NC = KT * TR / (W * FF_THREADS);     // row loads a thread
  static constexpr int NQ = KT * SLOTS / (W * FF_THREADS);  // slot loads a thread
  float cv[NC][W], qv[NQ][W];

  __device__ __forceinline__ static void fetch_one(const float* src, int rows, int r, int k, int H,
                                                   float (&v)[W]) {
    if constexpr (VEC) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && k < H) t = *reinterpret_cast<const float4*>(src + (size_t)r * H + k);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = r < rows && k < H ? src[(size_t)r * H + k] : 0.f;
    }
  }
  // rows: the tile's rows from `rows_at` (n_rows of them), slots: n_slots from `q`
  __device__ __forceinline__ void fetch(const float* rows_at, int n_rows, const float* q,
                                        int n_slots, int k0, int H) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int idx = threadIdx.x + i * FF_THREADS, r = idx / (KT / W), k = (idx % (KT / W)) * W;
      fetch_one(rows_at, n_rows, r, k0 + k, H, cv[i]);
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = threadIdx.x + i * FF_THREADS, r = idx / (KT / W), k = (idx % (KT / W)) * W;
      fetch_one(q, n_slots, r, k0 + k, H, qv[i]);
    }
  }
  __device__ __forceinline__ void store(float* ct, float* qt) const {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int idx = threadIdx.x + i * FF_THREADS, r = idx / (KT / W), k = (idx % (KT / W)) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) ct[(k + e) * LDCT + r] = cv[i][e];
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = threadIdx.x + i * FF_THREADS, r = idx / (KT / W), k = (idx % (KT / W)) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) qt[(k + e) * LDQT + r] = qv[i][e];
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(FF_THREADS, 1)
ivf_cell_ffma(const float* __restrict__ qslab, const float* __restrict__ values, Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);  // [KT][LDQT]: a K chunk of the slots
  float* ct = qt + KT * LDQT;                  // [KT][LDCT]: a K chunk of the tile's rows
  float* sc = ct + KT * LDCT;                  // [SLOTS][SCP]
  u64* lists = reinterpret_cast<u64*>(sc + SLOTS * SCP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.y, s_lo = blockIdx.x * SLOTS;
  const int cell = cell_of(jb, blk);
  const int cnt = filled_slots(jb, cell);
  const int s_hi = min(jb.Qcap, s_lo + SLOTS);
  if (s_lo >= cnt) {
    write_empty(jb, blk, s_lo, s_hi, tid, FF_THREADS);
    return;
  }
  const int H = jb.H;
  const float* q = qslab + ((size_t)cell * jb.Qcap + s_lo) * H;
  const int n_fill = cnt - s_lo;  // filled slots of the tile (at most SLOTS are read)
  // warp w scores and selects for the tile's slots 8 w .. 8 w + 7, of which `mine` are filled;
  // each thread scores those 8 slots against rows 4 lane .. + 3 of the tile
  u64* my_lists = lists + warp * 8 * JMAX;
  for (int i = lane; i < 8 * JMAX; i += 32) my_lists[i] = 0ull;
  __syncwarp();
  const int mine = min(max(n_fill - 8 * warp, 0), 8);
  const int n_here = min(max(s_hi - s_lo - 8 * warp, 0), 8);
  const int per = (jb.block + jb.sel - 1) / jb.sel;
  const int blk_start = blk * jb.block;
  const int nk = (H + KT - 1) / KT;
  for (int sb = 0; sb < per; ++sb) {
    const int s0 = blk_start + sb * jb.sel, s_end = min(blk_start + jb.block, s0 + jb.sel);
    for (int base = s0; base < s_end; base += TR) {
      const TileRows tr = tile_rows(jb, base, s_end, lane);
      if (!tr.any) continue;
      const float* rows_at = values + (size_t)base * H;
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      Chunk<VEC> next;
      next.fetch(rows_at, s_end - base, q, n_fill, 0, H);
      for (int kc = 0; kc < nk; ++kc) {
        __syncthreads();  // the previous chunk (and the previous tile) is read
        next.store(ct, qt);
        __syncthreads();
        if (kc + 1 < nk) next.fetch(rows_at, s_end - base, q, n_fill, (kc + 1) * KT, H);
        if (mine == 0) continue;
        const int kmax = min(KT, H - kc * KT);
        for (int kk = 0; kk < kmax; ++kk) {
          float c[4], qa[4], qb[4];
          load4(ct + kk * LDCT + 4 * lane, c);
          load4(qt + kk * LDQT + 8 * warp, qa);
          load4(qt + kk * LDQT + 8 * warp + 4, qb);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] = fmaf(qa[i], c[j], acc[i][j]);
              acc[i + 4][j] = fmaf(qb[i], c[j], acc[i + 4][j]);
            }
        }
      }
      if (mine == 0) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(sc + (8 * warp + i) * SCP + 4 * lane) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncwarp();
      const float cs[4] = {1.f, 1.f, 1.f, 1.f};
      for (int j = 0; j < mine; ++j) {
        u64 k[4];
        slot_keys<false, false>(k, sc + (8 * warp + j) * SCP, tr, cs, 1.f, base, lane);
        merge_tile(k, my_lists + j * JMAX, jb.J, lane);
      }
    }
    write_lists(jb, my_lists, blk * per + sb, s_lo + 8 * warp, n_here, mine, lane);
  }
}

// ---- host ---------------------------------------------------------------------------------

int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
               CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  if (int err = encode_tiled(&encode)) return err;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int KIND>
int launch_wgmma(const void* qslab, const void* values, const Job& jb, int nlist, dim3 grid,
                 cudaStream_t stream) {
  using W = Wg<KIND>;
  const bool bf_slots = KIND != K_I8Q;
  const size_t qe = bf_slots ? 2 : 1, re = KIND == K_BF16 ? 2 : 1;
  const CUtensorMapDataType qt = bf_slots ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType rt = KIND == K_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tmq, tmr;
  const cuuint64_t qdims[3] = {(cuuint64_t)jb.H, (cuuint64_t)jb.Qcap, (cuuint64_t)nlist};
  const cuuint64_t qstrides[2] = {jb.H * qe, (cuuint64_t)jb.Qcap * jb.H * qe};
  const cuuint32_t qbox[3] = {(cuuint32_t)W::KS, SLOTS, 1};
  if (int e = encode_map(&tmq, qt, qslab, 3, qdims, qstrides, qbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  const cuuint64_t rdims[2] = {(cuuint64_t)jb.H, (cuuint64_t)jb.N};
  const cuuint64_t rstrides[1] = {jb.H * re};
  const cuuint32_t rbox[2] = {(cuuint32_t)W::KS, TR};
  if (int e = encode_map(&tmr, rt, values, 2, rdims, rstrides, rbox,
                         KIND == K_I8ROWS ? CU_TENSOR_MAP_SWIZZLE_NONE
                                          : CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  cudaError_t err = cudaFuncSetAttribute(ivf_cell_wgmma<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)W::SMEM);
  if (err != cudaSuccess) return (int)err;
  ivf_cell_wgmma<KIND><<<grid, WG_THREADS, W::SMEM, stream>>>(tmq, tmr, jb);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_ffma(const void* qslab, const void* values, const Job& jb, dim3 grid,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ivf_cell_ffma<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FF_SMEM);
  if (err != cudaSuccess) return (int)err;
  ivf_cell_ffma<VEC><<<grid, FF_THREADS, FF_SMEM, stream>>>(
      static_cast<const float*>(qslab), static_cast<const float*>(values), jb);
  return (int)cudaGetLastError();
}

}  // namespace

// The shapes drt_ivf_cell takes: 1 for fp32 x fp32 (any H), bf16 x bf16 at H % 64 == 0,
// bf16 x int8 at H % 64 == 0 and int8 x int8 at H % 128 == 0, the wgmma bodies with the slab
// and the rows 16-byte aligned; else 0.
extern "C" int drt_ivf_cell_takes(const void* qslab, const void* values, int H, int qtype,
                                  int ctype) {
  if (qtype == T_F32 && ctype == T_F32) return 1;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qslab) | reinterpret_cast<uintptr_t>(values);
  if ((ptrs & 15) != 0 || H < 1) return 0;
  if (qtype == T_BF16 && (ctype == T_BF16 || ctype == T_I8)) return H % 64 == 0;
  if (qtype == T_I8 && ctype == T_I8) return H % 128 == 0;
  return 0;
}

// The IVF cell kernels K13 / K14, serve selection. qslab [nlist, Qcap, H] (qtype), the
// probing-query slots of each cell; values [N, H] (ctype) in N / block storage blocks, each
// inside one cell; row_ids [N] (-1 = empty, masked); cscales [N] fp32 for int8 cells, else
// null; qscales [nlist, Qcap] fp32 for int8 slots, else null; block_cell [N / block] int32
// gives each block's cell (K14); null, the cell is blk / cell_blocks (K13). slots [nlist]
// int32: each cell's filled slots, its first ones (null: every slot); the lists of the others
// are (-inf, -1). Each storage block is cut into selection blocks of `sel` rows (the last one
// shorter where sel does not divide block) -> out_vals / out_ids [N / block * ceil(block /
// sel), Qcap, J], ids flat row positions. Shapes: drt_ivf_cell_takes.
extern "C" int drt_ivf_cell(const void* qslab, const void* values, const void* cscales,
                            const void* qscales, const void* row_ids, const void* block_cell,
                            const void* slots, void* out_v, void* out_i, int nlist, int Qcap,
                            int N, int H, int block, int sel, int J, int cell_blocks, int qtype,
                            int ctype, void* stream) {
  if (J < 1 || J > JMAX || block < 1 || sel < 1 || sel > block || J > sel || N % block != 0 ||
      row_ids == nullptr || nlist < 1 || Qcap < 1 || N < 1 ||
      (block_cell == nullptr && cell_blocks < 1) || N / block > 65535 ||
      !drt_ivf_cell_takes(qslab, values, H, qtype, ctype) ||
      (ctype == T_I8) != (cscales != nullptr) || (qtype == T_I8) != (qscales != nullptr))
    return (int)cudaErrorInvalidValue;
  const Job jb{static_cast<const int*>(row_ids), static_cast<const int*>(block_cell),
               static_cast<const int*>(slots), static_cast<const float*>(cscales),
               static_cast<const float*>(qscales), static_cast<float*>(out_v),
               static_cast<int*>(out_i), Qcap, N, H, block, sel, J, cell_blocks};
  const dim3 grid((Qcap + SLOTS - 1) / SLOTS, N / block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qtype == T_F32) {
    const uintptr_t ptrs =
        reinterpret_cast<uintptr_t>(qslab) | reinterpret_cast<uintptr_t>(values);
    if (H % 4 == 0 && (ptrs & 15) == 0) return launch_ffma<true>(qslab, values, jb, grid, st);
    return launch_ffma<false>(qslab, values, jb, grid, st);
  }
  if (qtype == T_I8) return launch_wgmma<K_I8Q>(qslab, values, jb, nlist, grid, st);
  if (ctype == T_I8) return launch_wgmma<K_I8ROWS>(qslab, values, jb, nlist, grid, st);
  return launch_wgmma<K_BF16>(qslab, values, jb, nlist, grid, st);
}
