// The IVF cell kernels K13, K14 and K17 on Hopper: empty query slots and empty row tiles
// skipped, products on wgmma + TMA (bf16, int8 rows, i8q, PQ codes) or FFMA (fp32), and an
// exact serve selection built for J of 20-32 (K17 at J <= 8: register lists, two lanes a
// slot).
//
// Replaces these TPU kernels of denseretrievaltoolkits_tpu/ops/ivf_bulk.py (serve selection):
//   K13 `_cell_topj_kernel` / `_scaled` / `_i8q` (:44, :61, :143; `_ivf_cell_topj`, :122): per
//       (cell, cell block) the cell's probing-query slab [Qcap, H] against the block's rows of
//       the fixed-capacity layout [nlist * C, H], empty row slots (row id < 0) masked;
//   K14 `_ragged_kernel` / `_scaled` / `_i8q` (:165, :184, :202; `_ivf_ragged_topj`, :272):
//       the same over the ragged padded-flat block list, whose block -> cell map picks the slab;
// and this of denseretrievaltoolkits_tpu/ops/ivf_pq.py:
//   K17 `_ragged_pq_kernel` (:58; `_ivf_ragged_topj_pq`, :167): K14 over PQ codes of cell
//       residuals, decoded through the table [M, k, d_sub], each slot's probe score added to
//       its scores after the product, before the row mask.
// For each (storage block, selection block of `sel` rows, slot) the J best (score, id) pairs
// under the serve key of serve_select.cuh (exact fp32 score, ties to the smaller flat id),
// written cell-major [n_sel, Qcap, J] (an empty entry is (-inf, -1)). Formulas: fp32 cells
// score fp32 slots in true fp32 (FFMA, no TF32); bf16 cells bf16 products with fp32 sums;
// int8 cells under bf16 slots convert int8 -> bf16 (exact) and multiply the row scale after
// the sum; i8q runs s8 x s8 -> s32, then float(s32) * scale_row * scale_slot, in that order;
// PQ cells decode each code to its table entry in bf16 (exact: the table is bf16) and score
// bf16 products with fp32 sums, + the slot's offset.
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
// - Products, PQ codes (`ivf_cell_wgmma<K_PQ>`, K17): the slots' slice as bf16's, the codes of
//   the tile's 128 rows for the slice's subspaces by TMA (a box of 128 rows x the slice's
//   storage rows of the code-major [M_storage, N]; where N, block or sel is no multiple of 16
//   the producer warp copies them), one code-major stage of R x 128 bytes beside the slots'.
//   Each consumer thread decodes its row's 64 dims (the 4-bit table, 32 H bytes, copied to
//   shared memory once a CTA; the 8-bit one, 512 H bytes, read through L2) while the previous
//   slice's products run, then stores them swizzled as bf16 once every warp's products are
//   done (the products read every row), behind fence.proxy.async and the named barrier.
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
//   lists stay exact (the keys a full merge keeps). K17 at J <= 8 (its bulk J): lanes 2 j and
//   2 j + 1 own slot j, each half the tile's rows with a register list of 8 keys; the rows
//   past the list's J-th score are marked one bit a row, then inserted (select_pair); the
//   two lists merge when the selection block is written.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "serve_select.cuh"

using namespace drt;
using namespace drt::warp_select;

namespace {

using bf = __nv_bfloat16;

constexpr int JMAX = 32;        // one list entry a lane
constexpr int SLOTS = 64;       // slots a CTA: the wgmma M, the FFMA body's query tile
constexpr int TR = 128;         // rows a tile
constexpr int SCP = TR + 8;     // score tile pitch, floats: the accumulators' float2 stores
                                // take two wavefronts, a lane's reads one
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

// ---- the selection (warp_select::merge_tile of serve_select.cuh) -------------------------

// The candidate keys of one slot's row of the score tile: column lane + 32 r is flat row
// base + lane + 32 r, x the row scale (int8 cells), x the slot scale (i8q), the reference's
// order, or + the slot's offset (PQ cells, after the product); masked rows are 0.
template <bool CS, bool QS, bool OFF = false>
__device__ __forceinline__ void slot_keys(u64 (&k)[4], const float* srow, const TileRows& tr,
                                          const float (&cs)[4], float qs, int base, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = srow[lane + 32 * r];
    if constexpr (CS) v = v * cs[r];
    if constexpr (QS) v = v * qs;
    if constexpr (OFF) v = v + qs;
    k[r] = tr.valid[r] ? pack_key(v, base + lane + 32 * r) : 0ull;
  }
}

// K17's selection for J <= JT: lanes 2 j and 2 j + 1 of a warp own its slot j, each half the
// tile's rows (64 h .. 64 h + 63), with a list of JT keys at keys 8 h .. of the slot's 32
// (sorted descending): the rows past the list's J-th score (ties cannot enter: later rows
// carry larger ids) as a bitmask, then each in row order against the floor as it stands, by
// a register insertion. srow: the slot's scores, valid: the tile's stored rows (bit r of
// word w: row 32 w + r), off: the slot's offset, added after the product.
constexpr int JT = 8;
__device__ __forceinline__ void select_pair(u64* list, const float* srow, const unsigned (&valid)[4],
                                            float off, int base, int h, int J) {
  const u64 t = list[J - 1];
  float floor = t == 0ull ? -INFINITY : key_score(t);
  unsigned long long cand = 0ull;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float4 s4 = *reinterpret_cast<const float4*>(srow + 64 * h + 4 * k);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (sv[e] + off > floor) cand |= 1ull << (4 * k + e);
  }
  const unsigned lo = h ? valid[2] : valid[0], hi = h ? valid[3] : valid[1];
  cand &= ((unsigned long long)hi << 32) | lo;
  if (cand == 0ull) return;
  u64 L[JT];
#pragma unroll
  for (int p = 0; p < JT; ++p) L[p] = list[p];
  do {
    const int b = __ffsll(cand) - 1;
    cand &= cand - 1ull;
    const float v = srow[64 * h + b] + off;
    if (v > floor) {
      insert_sorted(L, pack_key(v, base + 64 * h + b));
      floor = list_floor(L, J);
    }
  } while (cand != 0ull);
#pragma unroll
  for (int p = 0; p < JT; ++p) list[p] = L[p];
}

// The lists of select_pair (slot j's halves at keys 0 and 8 of its 32) of selection block sbi
// into the output as write_lists does: each pair merged in its even lane.
__device__ __forceinline__ void write_pair_lists(const Job& jb, u64* lists, int sbi, int slot0,
                                                 int n, int mine, int lane) {
  const int j = lane >> 1, h = lane & 1;
  u64 L[JT];
#pragma unroll
  for (int p = 0; p < JT; ++p) {
    L[p] = j < mine ? lists[j * JMAX + 8 * h + p] : 0ull;
    if (j < mine) lists[j * JMAX + 8 * h + p] = 0ull;
  }
#pragma unroll
  for (int p = 0; p < JT; ++p) {
    const u64 other = __shfl_xor_sync(0xffffffffu, L[p], 1);
    if (h == 0) insert_sorted(L, other);
  }
  if (h == 0 && j < n) {
    const size_t o = ((size_t)sbi * jb.Qcap + slot0 + j) * jb.J;
#pragma unroll
    for (int p = 0; p < JT; ++p)
      if (p < jb.J) {
        jb.out_v[o + p] = L[p] == 0ull ? -INFINITY : key_score(L[p]);
        jb.out_i[o + p] = L[p] == 0ull ? -1 : key_row(L[p]);
      }
  }
  __syncwarp();
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

// ---- the wgmma body (bf16 slots x bf16 rows, bf16 slots x int8 rows, int8 x int8, bf16
// slots x PQ codes) --------------------------------------------------------------------------

enum { K_BF16 = 0, K_I8ROWS = 1, K_I8Q = 2, K_PQ = 3 };

constexpr int NST = 2;           // ring stages
constexpr int WG_THREADS = 160;  // one consumer warpgroup and one producer warp
constexpr int PRODUCER_WARP = 4;

template <int KIND>
struct Wg {
  static constexpr int KS = KIND == K_I8Q ? 128 : 64;  // k elements a slice: 128 bytes
  static constexpr uint32_t A_BYTES = SLOTS * 128;     // the slots' slice, swizzled
  // the rows' slice: swizzled 128-byte rows, or int8 rows of 64 bytes (converted after); PQ
  // codes take the launch's Pq::stage - A_BYTES
  static constexpr uint32_t B_BYTES = KIND == K_I8ROWS ? TR * 64 : KIND == K_PQ ? 0 : TR * 128;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  // the rows as bf16 (int8 rows converted, PQ rows decoded)
  static constexpr uint32_t CONV = KIND == K_I8ROWS || KIND == K_PQ ? TR * 128 : 0;
  static constexpr size_t SMEM = 1024 + NST * STAGE + CONV + sizeof(float) * SLOTS * SCP +
                                 sizeof(u64) * SLOTS * JMAX + 2 * NST * 8;
};

// K17's PQ cells: codes code-major [M_storage, N] (8-bit: code - 128 as int8 [M, N]; 4-bit:
// subspaces 2i, 2i + 1 in the low and high nibbles of [M / 2, N]), the bf16 table [M, k,
// d_sub] (k = 256 / 16), M = H / d_sub, d_sub | 128.
struct Pq {
  const unsigned char* codes;
  const bf* table;      // device memory; the 4-bit table is copied to shared memory
  const float* poff;    // [nlist, Qcap]: each slot's offset, added to its scores
  int d_sub, four;      // four: 4-bit codes
  int rows;             // storage rows of codes a 64-dim slice (one at least)
  int tma;              // the codes come by TMA (N, block and sel multiples of 16, 16-byte
                        // aligned); else the producer warp copies them
  int table_smem;       // the table is in shared memory (after the barriers)
  uint32_t stage;       // ring stage bytes: the slots' slice, then the codes (1024-aligned)
};

// the first storage row of codes of 64-dim slice s
__device__ __forceinline__ int pq_row0(const Pq& pq, int s) {
  const int m = s * 64 / pq.d_sub;
  return pq.four ? m >> 1 : m;
}

// Row `row` of a tile's 64-dim slice s decoded to bf16 (8 dims a uint4): codes [pq.rows][TR]
// bytes as the stage holds them; entry (m, code, dim % d_sub) of the table for subspace m =
// dim / d_sub.
__device__ __forceinline__ void pq_decode(uint4 (&o)[8], const unsigned char* codes,
                                          const bf* table, const Pq& pq, int s, int row) {
  const int d = pq.d_sub, kc = pq.four ? 16 : 256, r0 = pq_row0(pq, s);
  auto entry = [&](int m) {  // the table row of subspace m's code for this row
    const unsigned b = codes[((pq.four ? m >> 1 : m) - r0) * TR + row];
    const unsigned code = pq.four ? ((m & 1) ? b >> 4 : b & 15u) : b ^ 0x80u;
    return table + ((size_t)m * kc + code) * d;
  };
  if (pq.four && d == 4) {  // 8 dims: two subspaces, one code byte, two 8-byte entries
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int m = (s * 64 + 8 * c) >> 2;  // even
      const unsigned b = codes[((m >> 1) - r0) * TR + row];
      const uint2 lo = *reinterpret_cast<const uint2*>(table + ((size_t)m * 16 + (b & 15u)) * 4);
      const uint2 hi = *reinterpret_cast<const uint2*>(table + ((size_t)m * 16 + 16 + (b >> 4)) * 4);
      o[c] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = s * 64 + 8 * c;
    if (d >= 8) {  // 8 dims of one subspace: one 16-byte load
      const int m = k / d;
      o[c] = *reinterpret_cast<const uint4*>(entry(m) + (k - m * d));
    } else if (d == 4) {  // two subspaces, 8 bytes each
      const uint2 a = *reinterpret_cast<const uint2*>(entry(k >> 2));
      const uint2 b = *reinterpret_cast<const uint2*>(entry((k >> 2) + 1));
      o[c] = make_uint4(a.x, a.y, b.x, b.y);
    } else {  // d_sub 1 or 2: 4 bytes at a time
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k + 2 * e;
        if (d == 2) {
          w[e] = *reinterpret_cast<const unsigned*>(entry(kk >> 1));
        } else {
          const unsigned lo = *reinterpret_cast<const unsigned short*>(entry(kk));
          const unsigned hi = *reinterpret_cast<const unsigned short*>(entry(kk + 1));
          w[e] = lo | (hi << 16);
        }
      }
      o[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}
static_assert(Wg<K_BF16>::SMEM <= SMEM_MAX / 2 && Wg<K_I8ROWS>::SMEM <= SMEM_MAX / 2 &&
                  Wg<K_I8Q>::SMEM <= SMEM_MAX / 2,
              "two CTAs of the wgmma body must fit an SM");

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
               Job jb, Pq pq) {
  using W = Wg<KIND>;
  using Acc = std::conditional_t<KIND == K_I8Q, int, float>;
  constexpr bool PQ = KIND == K_PQ;
  const uint32_t STAGE = PQ ? pq.stage : W::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (ring - smem_addr(smem_raw));
  const uint32_t conv = ring + NST * STAGE;
  float* scores = reinterpret_cast<float*>(gbase + NST * STAGE + W::CONV);
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
  const bf* table = nullptr;  // PQ: the table, in shared memory where it fits
  if constexpr (PQ) {
    table = pq.table;
    if (pq.table_smem) {
      uint4* ts = reinterpret_cast<uint4*>(lists + SLOTS * JMAX) + NST;  // after the barriers
      for (int i = tid; i < 2 * jb.H; i += WG_THREADS)  // 32 H bytes
        ts[i] = __ldg(reinterpret_cast<const uint4*>(pq.table) + i);
      table = reinterpret_cast<const bf*>(ts);
    }
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
        for (int s = 0; s < ns; ++s) {
          const uint32_t st = ring + stage * STAGE;
          if constexpr (PQ) {  // every lane: the codes, copied where TMA cannot bring them
            mbar_wait(empty(stage), phase ^ 1);
            const int r0 = pq_row0(pq, s);
            if (!pq.tma) {
              unsigned char* dst = gbase + stage * STAGE + W::A_BYTES;
              for (int i = lane; i < pq.rows * TR; i += 32) {
                const int n = base + (i & (TR - 1));
                dst[i] = n < jb.N ? pq.codes[(size_t)(r0 + i / TR) * jb.N + n] : 0;
              }
            }
            __syncwarp();
            if (lane == 0) {
              mbar_expect_tx(full(stage), W::A_BYTES + (pq.tma ? pq.rows * TR : 0));
              tma_load_3d(st, &tmq, s * W::KS, s_lo, cell, full(stage));
              if (pq.tma) tma_load_2d(st + W::A_BYTES, &tmr, base, r0, full(stage));
            }
          } else if (lane == 0) {
            mbar_wait(empty(stage), phase ^ 1);
            mbar_expect_tx(full(stage), W::STAGE);
            tma_load_3d(st, &tmq, s * W::KS, s_lo, cell, full(stage));
            tma_load_2d(st + W::A_BYTES, &tmr, s * W::KS, base, full(stage));
          }
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
        const uint32_t st = ring + stage * STAGE;
        if constexpr (PQ) {
          // this row's slice decoded while the previous slice's products run, stored once every
          // warp's products are done (they read every row of the buffer)
          uint4 o[8];
          pq_decode(o, gbase + stage * STAGE + W::A_BYTES, table, pq, s, tid);
          if (s > 0) {
            wgmma_wait<0>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(prev));
          }
          consumers_sync();
          unsigned char* dst = gbase + NST * STAGE + tid * 128;
#pragma unroll
          for (int c = 0; c < 8; ++c) *reinterpret_cast<uint4*>(dst + ((c ^ (tid & 7)) << 4)) = o[c];
          fence_proxy_async();
          consumers_sync();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128(acc, sw128_desc(st + kk * 32, 16), sw128_desc(conv + kk * 32, 16), 1);
          wgmma_commit();
        } else if constexpr (KIND == K_I8ROWS) {
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
      fence_regs(acc);
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
      if constexpr (KIND == K_I8ROWS || KIND == K_I8Q) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (tr.valid[r]) cs[r] = __ldg(jb.cscale + base + lane + 32 * r);
      }
      if (PQ && jb.J <= JT) {  // K17: two lanes a slot, register lists
        unsigned valid[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) valid[r] = __ballot_sync(0xffffffffu, tr.valid[r]);
        const int j = lane >> 1;
        if (j < mine)
          select_pair(my_lists + j * JMAX + 8 * (lane & 1), scores + (16 * warp + j) * SCP, valid,
                      __ldg(pq.poff + (size_t)cell * jb.Qcap + s_lo + 16 * warp + j), base,
                      lane & 1, jb.J);
        __syncwarp();
        continue;
      }
      for (int j = 0; j < mine; ++j) {
        const int sl = 16 * warp + j;
        u64 k[4];
        if constexpr (KIND == K_I8Q)
          slot_keys<true, true>(k, scores + sl * SCP, tr, cs,
                                __ldg(jb.qscale + (size_t)cell * jb.Qcap + s_lo + sl), base,
                                lane);
        else if constexpr (PQ)
          slot_keys<false, false, true>(k, scores + sl * SCP, tr, cs,
                                        __ldg(pq.poff + (size_t)cell * jb.Qcap + s_lo + sl), base,
                                        lane);
        else
          slot_keys<KIND == K_I8ROWS, false>(k, scores + sl * SCP, tr, cs, 1.f, base, lane);
        merge_tile(k, my_lists + j * JMAX, jb.J, lane);
      }
      __syncwarp();  // the tile is read before the next one is stored
    }
    if (PQ && jb.J <= JT)
      write_pair_lists(jb, my_lists, blk * per + sb, s_lo + 16 * warp, n_here, mine, lane);
    else
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
  if (int e = tensor_map(&tmq, qt, qslab, 3, qdims, qstrides, qbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  const cuuint64_t rdims[2] = {(cuuint64_t)jb.H, (cuuint64_t)jb.N};
  const cuuint64_t rstrides[1] = {jb.H * re};
  const cuuint32_t rbox[2] = {(cuuint32_t)W::KS, TR};
  if (int e = tensor_map(&tmr, rt, values, 2, rdims, rstrides, rbox,
                         KIND == K_I8ROWS ? CU_TENSOR_MAP_SWIZZLE_NONE
                                          : CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  cudaError_t err = cudaFuncSetAttribute(ivf_cell_wgmma<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)W::SMEM);
  if (err != cudaSuccess) return (int)err;
  ivf_cell_wgmma<KIND><<<grid, WG_THREADS, W::SMEM, stream>>>(tmq, tmr, jb, Pq{});
  return (int)cudaGetLastError();
}

// K17: the slab's map as bf16 slots', the codes' (a box of 128 rows x the slice's storage
// rows) where TMA can bring them; the 4-bit table in shared memory where it fits
int launch_pq(const void* qslab, const Job& jb, Pq pq, int nlist, int m_storage, dim3 grid,
              cudaStream_t stream) {
  using W = Wg<K_PQ>;
  CUtensorMap tmq, tmr = {};
  const cuuint64_t qdims[3] = {(cuuint64_t)jb.H, (cuuint64_t)jb.Qcap, (cuuint64_t)nlist};
  const cuuint64_t qstrides[2] = {jb.H * 2ull, (cuuint64_t)jb.Qcap * jb.H * 2};
  const cuuint32_t qbox[3] = {(cuuint32_t)W::KS, SLOTS, 1};
  if (int e = tensor_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qslab, 3, qdims, qstrides, qbox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  pq.rows = max(1, (64 / pq.d_sub) >> pq.four);
  // a box's first row is its innermost coordinate: every tile start a multiple of 16 bytes
  pq.tma = jb.N % 16 == 0 && jb.block % 16 == 0 && jb.sel % 16 == 0 &&
           (reinterpret_cast<uintptr_t>(pq.codes) & 15) == 0;
  if (pq.tma) {
    const cuuint64_t cdims[2] = {(cuuint64_t)jb.N, (cuuint64_t)m_storage};
    const cuuint64_t cstrides[1] = {(cuuint64_t)jb.N};
    const cuuint32_t cbox[2] = {TR, (cuuint32_t)pq.rows};
    if (int e = tensor_map(&tmr, CU_TENSOR_MAP_DATA_TYPE_UINT8, pq.codes, 2, cdims, cstrides, cbox,
                           CU_TENSOR_MAP_SWIZZLE_NONE))
      return e;
  }
  pq.stage = W::A_BYTES + ((pq.rows * TR + 1023u) & ~1023u);
  size_t smem = 1024 + NST * (size_t)pq.stage + W::CONV + sizeof(float) * SLOTS * SCP +
                sizeof(u64) * SLOTS * JMAX + 2 * NST * 8;
  const size_t table = 32 * (size_t)jb.H;  // the 4-bit table [M, 16, d_sub] bf16
  pq.table_smem = pq.four && smem + table <= SMEM_MAX;
  if (pq.table_smem) smem += table;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ivf_cell_wgmma<K_PQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ivf_cell_wgmma<K_PQ><<<grid, WG_THREADS, smem, stream>>>(tmq, tmr, jb, pq);
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

// The IVF-PQ cell kernel K17 over the ragged block list of PQ codes: codes [M, N] int8 holding
// code - 128 (nbits 8) or [M / 2, N] nibble-packed (nbits 4), M = H / d_sub, N = n_blocks x
// block; the bf16 table [M, k, d_sub] (k = 256 / 16, d_sub | 128, H % 128 == 0, 16-byte
// aligned); each cell's bf16 query slab qslab [nlist, Qcap, H] (16-byte aligned); qoff [nlist,
// Qcap] fp32 is added to every score of its slot after the product, before the row mask
// (row_ids < 0) and the selection; block_cell [N / block] each block's cell; slots [nlist]
// int32 each cell's filled slots, its first ones (null: every slot), the lists of the others
// (-inf, -1). -> out_vals / out_ids [N / block * ceil(block / sel), Qcap, J], ids flat
// positions.
extern "C" int drt_ivf_pq_cell(const void* qslab, const void* codes, const void* table,
                               const void* qoff, const void* row_ids, const void* block_cell,
                               const void* slots, void* out_v, void* out_i, int nlist, int Qcap,
                               int N, int H, int d_sub, int nbits, int block, int sel, int J,
                               void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qslab) | reinterpret_cast<uintptr_t>(table);
  if (J < 1 || J > JMAX || block < 1 || sel < 1 || sel > block || J > sel || N % block != 0 ||
      row_ids == nullptr || block_cell == nullptr || qoff == nullptr || nlist < 1 || Qcap < 1 ||
      N < 1 || N / block > 65535 || (nbits != 4 && nbits != 8) || d_sub < 1 || 128 % d_sub != 0 ||
      H < 128 || H % 128 != 0 || (ptrs & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Job jb{static_cast<const int*>(row_ids), static_cast<const int*>(block_cell),
               static_cast<const int*>(slots), nullptr, nullptr, static_cast<float*>(out_v),
               static_cast<int*>(out_i), Qcap, N, H, block, sel, J, 1};
  Pq pq{};
  pq.codes = static_cast<const unsigned char*>(codes);
  pq.table = static_cast<const bf*>(table);
  pq.poff = static_cast<const float*>(qoff);
  pq.d_sub = d_sub;
  pq.four = nbits == 4;
  const int m_storage = H / d_sub / (nbits == 4 ? 2 : 1);
  const dim3 grid((Qcap + SLOTS - 1) / SLOTS, N / block);
  return launch_pq(qslab, jb, pq, nlist, m_storage, grid, static_cast<cudaStream_t>(stream));
}
