// The PQ serve kernels K15 and K16 on Hopper: a decode pass, then a wgmma + TMA scoring body.
//
// Replaces these TPU kernels of denseretrievaltoolkits_tpu/ops/pq.py, all launched by
// `pq_topj_blocks` (:499):
//   K15 `_pq_serve_kernel` (:349; 8-bit codes, bf16 block-diagonal codebook) and
//       `_pq4_serve_kernel` (:409; 4-bit codes);
//   K16 `_pq_serve_kernel_i8dec` (:293): 8-bit codes through an int8 codebook with one
//       scale per output dim.
// Each scores bf16 queries against the decoded bf16 rows of every corpus block with fp32
// sums, masks rows >= n_valid and keeps each block's J best (score, id) pairs by the serve
// selection (serve_select.cuh: exact scores, ties to the smaller id). Output [Q, n_blocks,
// J] (vals fp32, ids int32 global row positions; an empty slot is (-inf, -1)).
//
// Codes are code-major: [M, N] int8 holding code - 128, or [M/2, N] nibble-packed
// (subspace 2i in the low nibble of packed row i, 2i+1 in the high one), M = H / d_sub;
// the table is compact, [M, k, d_sub] (k = 256 or 16), bf16, or int8 with a per-dim fp32
// scale [H] for K16 (ops/pq.py:bdcb_table cuts it out of the block-diagonal operand).
//
// The rule the TPU kernel keeps, and this design keeps: each block is decoded ONCE per
// search (pq.py:318-341 decodes at the first query tile into a VMEM scratch [H, block])
// and every query tile scores the decoded rows. Blocks run in no order here, so the
// decode is a pass of its own. The wrapper cuts the corpus into chunks of whole storage
// blocks (ops/pq.py:pq_chunk_rows, 32,768 rows: a chunk's rows, 48 MB at H = 768, are
// scored while most of them are still in the 50 MB L2) and, per chunk, launches
//   1. pq_decode_kernel: the chunk's rows decoded into a bf16 scratch [rows, H] that the
//      wrapper allocates (each row's H dims contiguous: the K-major B operand). A CTA
//      takes one 64-dim group of 2048 rows. It stages that group's slice of the table in
//      shared memory as the bf16 values the decode yields ([k][64]: 32 KB for 8-bit codes,
//      2 KB for 4-bit; for K16 bf16(float(int8 entry) x scale[dim]), rounded once, which
//      is the TPU's s32 one-hot sum times the scale), then per 256-row pass stages the
//      group's code rows (coalesced byte loads) and writes every row's 128 bytes of the
//      group: 8 threads a row, each one 16-byte store assembled from shared-memory
//      gathers (the 8 threads of a row read 8 different 16-byte columns of the table:
//      no bank conflicts), a warp 4 whole rows.
//   2. pq_score_wgmma: one CTA per (128-query tile, storage block): two consumer
//      warpgroups of 64 queries and one producer warp. The producer brings 64-dim
//      k-slices of the query tile and of a 128-row tile of the block's decoded rows by TMA
//      (128-byte swizzle; rows past the chunk or Q arrive as zeros) into a 4-stage mbarrier
//      ring. Each warpgroup runs m64n128k16 wgmma (fp32 sums) on them, releasing a stage
//      as soon as the next stage's products are issued. Row tiles start at the block's
//      first row, so none straddles two blocks; one that runs past the block's end masks
//      those rows (as rows past n_valid). Then each warp selects for its 16 queries, with
//      no barrier between warps: it stores the tile's scores to a score tile of its own
//      and, from the accumulators, marks each row's candidates: above the row's J-th
//      entry (a tie cannot enter: the tile's ids are larger) and, where J <= 8, at or
//      above the least of its quad's second-largest values (8 >= J of the tile's values
//      reach it, so nothing below it is in the top J). A row with at most 32 candidates
//      (every row at our shapes, a block's first tile included) is merged by one lane,
//      the warp's 16 rows at once: its list in registers where J <= 8, each candidate
//      one compare-exchange chain; else inserted in shared memory. A row with more (a
//      block's first tile where J > 8) takes J rounds of warp argmax. The lists stay
//      exact: the keys a merge of every score would keep.
// Query tiles run fastest in the grid: the tiles of one block run side by side and read
// its rows from L2.
//
// Shared memory of the scoring body (232,448 bytes a CTA at most): the ring, 4 stages of a
// 16 KB query slice and a 16 KB row slice (131,072 bytes); 8 per-warp score tiles of 16 x
// 128 fp32 (65,536; XOR-swizzled by row instead of padded, so the accumulator's float2
// stores and the row reads are conflict-free); the 128 queries' lists of JMAX packed keys
// at a stride of JMAX + 1 (33,792: the 16 lanes that merge 16 rows hit 16 bank pairs);
// the barriers (64); 1024 bytes to align the ring to the swizzle atom: 231,488 in all,
// one CTA an SM.
//
// What bounds it on the H100: the dense products, 2 Q N H bf16 operations (3.18 ms at Q =
// 2048, N = 1M, H = 768, 989 TFLOP/s), and the bytes they pull through L2: a CTA reads its
// query tile once per row tile and each row tile once, 64 flop a byte at 128 x 128 tiles
// (about 47 GB at those shapes). Measured there (kernel_ab.py --kernel pq): the scoring
// launches take 7.9-8.6 ms, of which the products about 5 ms and the selection about
// 3.3 ms more (it runs between tiles while the tensor cores wait; the threshold keeps
// it to a few insertions a row); the decode pass 1.1-1.3 ms, writing 2 H bytes a row
// (1.5 GB at 1M rows, 0.46 ms at 3.35 TB/s): bytes under the ops bound.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "serve_select.cuh"

using namespace drt;

namespace {

using bf = __nv_bfloat16;

constexpr int JMAX = 32;  // one list entry per lane

// ---- the decode pass ---------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_COLS = 64;           // dims of a CTA's group: one 128-byte row segment
constexpr int DEC_PASS = 256;          // rows whose codes are staged at once
constexpr int DEC_ROWS = 2048;         // rows a CTA
constexpr int CODE_LD = DEC_PASS + 4;  // a staged code row, bytes (the pad spreads banks)

// the code row holding dim's code: subspace dim / d_sub, two a row for 4-bit codes
__host__ __device__ inline int code_row(int dim, int dshift, bool four) {
  const int m = dim >> dshift;
  return four ? m >> 1 : m;
}

// shared memory of the decode pass: the table slice, then the code rows of one pass
inline size_t decode_smem(int kc, int dshift) {
  const int n_rows = code_row(DEC_COLS - 1, dshift, kc == 16) + 1;  // most any group reads
  return (size_t)kc * DEC_COLS * sizeof(bf) + (size_t)n_rows * CODE_LD;
}

// VEC consecutive bf16 (VEC * 2 bytes, as aligned) from src to dst
template <int VEC>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  if constexpr (VEC == 8)
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  else if constexpr (VEC == 4)
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  else if constexpr (VEC == 2)
    *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
  else
    *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
}

// KC entries a subspace (256: 8-bit codes, 16: 4-bit), VEC = min(d_sub, 8) dims a gather
template <int KC, int VEC>
__global__ void __launch_bounds__(DEC_THREADS)
pq_decode_kernel(const unsigned char* __restrict__ codes, const void* __restrict__ table,
                 const float* __restrict__ dscale, bf* __restrict__ out, int N, int H, int dshift,
                 int row0, int rows) {
  constexpr bool FOUR = KC == 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* tab = reinterpret_cast<bf*>(smem);                   // [KC][DEC_COLS]
  unsigned char* cs = smem + KC * DEC_COLS * sizeof(bf);   // [code rows][CODE_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * DEC_COLS;
  const int d = 1 << dshift;
  const int p0 = code_row(c0, dshift, FOUR);
  const int n_code = code_row(c0 + DEC_COLS - 1, dshift, FOUR) - p0 + 1;
  // the table slice, 8 dims of one entry (one 16-byte store) an item, VEC a load: the
  // loads of a thread's items are all in flight at once
  constexpr int ITEMS = KC * DEC_COLS / 8;
#pragma unroll
  for (int i = 0; i < (ITEMS + DEC_THREADS - 1) / DEC_THREADS; ++i) {
    const int idx = tid + i * DEC_THREADS;
    if (idx >= ITEMS) break;
    const int c = idx >> 3, j = 8 * (idx & 7);
    uint4 v;
    bf* o = reinterpret_cast<bf*>(&v);
#pragma unroll
    for (int e = 0; e < 8; e += VEC) {
      const int dim = c0 + j + e, m = dim >> dshift;
      const size_t at = ((size_t)m * KC + c) * d + (dim - (m << dshift));
      if (dscale == nullptr) {
        copy_vec<VEC>(o + e, static_cast<const bf*>(table) + at);
      } else {
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          o[e + x] = __float2bfloat16_rn((float)static_cast<const signed char*>(table)[at + x] *
                                         __ldg(dscale + dim + x));
      }
    }
    *reinterpret_cast<uint4*>(tab + c * DEC_COLS + j) = v;
  }
  const int r_begin = blockIdx.x * DEC_ROWS, r_end = min(rows, r_begin + DEC_ROWS);
  const int j0 = 8 * (lane & 7);  // this thread's 8 dims of the group
  for (int pr = r_begin; pr < r_end; pr += DEC_PASS) {
    const int n_pr = min(DEC_PASS, r_end - pr);
    __syncthreads();  // the previous pass's codes are read
    for (int idx = tid; idx < n_code * DEC_PASS; idx += DEC_THREADS) {
      const int cr = idx / DEC_PASS, r = idx - cr * DEC_PASS;
      if (r < n_pr) cs[cr * CODE_LD + r] = __ldg(codes + (size_t)(p0 + cr) * N + row0 + pr + r);
    }
    __syncthreads();  // the codes (and, the first time, the table) are staged
    for (int r = warp * 4 + (lane >> 3); r < n_pr; r += DEC_THREADS / 8) {
      uint4 v = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 8; e += VEC) {
        const int m = (c0 + j0 + e) >> dshift;
        int code;
        if constexpr (FOUR) {
          const unsigned b = cs[((m >> 1) - p0) * CODE_LD + r];
          code = (m & 1) ? (int)(b >> 4) : (int)(b & 15u);
        } else {
          code = (int)(cs[(m - p0) * CODE_LD + r] ^ 0x80u);  // centered int8 -> entry
        }
        copy_vec<VEC>(reinterpret_cast<bf*>(&v) + e, tab + code * DEC_COLS + j0 + e);
      }
      *reinterpret_cast<uint4*>(out + (size_t)(pr + r) * H + c0 + j0) = v;
    }
  }
}

template <int KC>
auto decode_kernel(int vec) {
  switch (vec) {
    case 1: return pq_decode_kernel<KC, 1>;
    case 2: return pq_decode_kernel<KC, 2>;
    case 4: return pq_decode_kernel<KC, 4>;
    default: return pq_decode_kernel<KC, 8>;
  }
}

// rows row0 .. row0 + rows - 1 of the codes decoded into out [rows, H]
int decode_pass(const void* codes, const void* table, const float* dscale, bf* out, int N,
                int H, int dshift, int nbits, int row0, int rows, cudaStream_t stream) {
  const int kc = nbits == 4 ? 16 : 256, vec = min(1 << dshift, 8);
  const auto kernel = nbits == 4 ? decode_kernel<16>(vec) : decode_kernel<256>(vec);
  const size_t smem = decode_smem(kc, dshift);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + DEC_ROWS - 1) / DEC_ROWS, H / DEC_COLS);
  kernel<<<grid, DEC_THREADS, smem, stream>>>(static_cast<const unsigned char*>(codes), table,
                                               dscale, out, N, H, dshift, row0, rows);
  return (int)cudaGetLastError();
}

// ---- the scoring body --------------------------------------------------------------------

constexpr int SQ = 128;            // queries a CTA: two consumer warpgroups of 64
constexpr int SR = 128;            // rows a row tile
constexpr int SK = 64;             // dims a k-slice: one 128-byte swizzle atom wide
constexpr int NST = 4;             // ring stages
constexpr int S_THREADS = 288;     // two consumer warpgroups and one producer warp
constexpr int PRODUCER_WARP = 8;
constexpr uint32_t A_BYTES = SQ * SK * 2, B_BYTES = SR * SK * 2, STAGE = A_BYTES + B_BYTES;
constexpr uint32_t SC_BYTES = 8 * 16 * SR * 4;  // per-warp score tiles [16][SR] fp32
constexpr int LSTRIDE = JMAX + 1;  // keys a query's list takes: 8 bytes more spread banks
constexpr int SPARSE_MAX = 32;     // more candidates in a row than this: J rounds instead
constexpr int REG_J = 8;           // lists of up to REG_J keys take their candidates in registers
constexpr uint32_t LIST_BYTES = SQ * LSTRIDE * 8;
constexpr uint32_t BAR_BYTES = 2 * NST * 8;
constexpr size_t SCORE_SMEM = 1024 + NST * STAGE + SC_BYTES + LIST_BYTES + BAR_BYTES;
static_assert(SCORE_SMEM <= 232448, "the scoring body's shared memory exceeds a CTA's");

// Key `key` into the sorted list L of J keys (0 = empty) if it beats the J-th: the
// entries below its place move down one.
__device__ __forceinline__ void insert_key(u64* L, int J, u64 key) {
  if (key <= L[J - 1]) return;
  int p = J - 1;
  for (; p > 0; --p) {
    const u64 above = L[p - 1];
    if (above > key) break;
    L[p] = above;
  }
  L[p] = key;
}

// One CTA: queries q0 .. q0 + 127 against storage block blockIdx.y of a chunk whose rows
// row0 .. row0 + rows - 1 are decoded behind tmr; the block's lists go to slot block0 +
// blockIdx.y of out [Q, n_blocks, J].
__global__ void __launch_bounds__(S_THREADS, 1)
pq_score_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmr,
               float* __restrict__ out_v, int* __restrict__ out_i, int Q, int H, int n_valid,
               int block, int J, int row0, int rows, int block0, int n_blocks) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (ring - smem_addr(smem_raw));
  float* scores = reinterpret_cast<float*>(gbase + NST * STAGE);
  u64* lists = reinterpret_cast<u64*>(gbase + NST * STAGE + SC_BYTES);
  const uint32_t bars = ring + NST * STAGE + SC_BYTES + LIST_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NST + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * SQ;
  const int b_start = blockIdx.y * block, b_end = min(rows, b_start + block);  // chunk rows
  const int n_tiles = (b_end - b_start + SR - 1) / SR;
  const int ns = H / SK;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int s = 0; s < ns; ++s) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t st = ring + stage * STAGE;
          mbar_expect_tx(full(stage), STAGE);
          tma_load_2d(st, &tmq, s * SK, q0, full(stage));
          tma_load_2d(st + A_BYTES, &tmr, s * SK, b_start + t * SR, full(stage));
          if (++stage == NST) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns queries q0 + 64 wg ..; its warp owns the 16 queries
  // q0 + 16 warp .. (rows 16 (warp % 4) + g and + 8 of the warpgroup's accumulator)
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  float* sc = scores + warp * 16 * SR;
  u64* lk = lists + warp * 16 * LSTRIDE;
  for (int i = lane; i < 16 * LSTRIDE; i += 32) lk[i] = 0ull;
  const int qw = q0 + 16 * warp;
  const int n_q = min(16, Q - qw);  // <= 0: queries past Q only
  const uint32_t a_off = wg * (64 * SK * 2);
  float acc[64];
  int stage = 0;
  unsigned phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    // zeroed here, the sums are dead while the last tile's lists are merged: their 64
    // registers serve the selection
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int s = 0; s < ns; ++s) {
      mbar_wait(full(stage), phase);
      const uint32_t st = ring + stage * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
        wgmma_ss_n128(acc, sw128_desc(st + a_off + kk * 32, 16),
                      sw128_desc(st + A_BYTES + kk * 32, 16), 1);
      wgmma_commit();
      if (s > 0) {  // the previous slice's products are done: release its stage
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(prev));
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
    // The tile's rows base .. base + SR - 1 of the chunk; those at or past the block's
    // end or n_valid are masked. The thread holds columns 8 n + 2 t4 + e (bit 2 n + e of
    // its masks) of local rows g and g + 8; column c of local row r is stored at
    // c ^ 8 (r % 8) of the warp's score tile. A candidate must beat its row's J-th entry
    // (strictly: the tile's ids are larger, so a tie cannot enter) and, where J <= 8,
    // reach the row's tile threshold: the least of the quad's second-largest values, which
    // at least 8 >= J of the tile's values reach, so no value below it can be in the top J.
    const int base = b_start + t * SR;
    const int lim = min(b_end, n_valid - row0) - base;
    const int id0 = row0 + base;
    unsigned pass[2];  // the thread's candidates of rows g and g + 8
    int cnt[2];        // ... and the row's count of them
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const u64 tk = lk[(g + 8 * i) * LSTRIDE + J - 1];
      const float thr = tk == 0ull ? -INFINITY : key_score(tk);
      float top1 = -INFINITY, top2 = -INFINITY;
#pragma unroll
      for (int n = 0; n < SR / 8; ++n) {
        const int c = 8 * n + 2 * t4;
        const float v0 = c < lim ? acc[4 * n + 2 * i] : -INFINITY;
        const float v1 = c + 1 < lim ? acc[4 * n + 2 * i + 1] : -INFINITY;
        acc[4 * n + 2 * i] = v0;
        acc[4 * n + 2 * i + 1] = v1;
        *reinterpret_cast<float2*>(sc + (g + 8 * i) * SR + (c ^ (g << 3))) = make_float2(v0, v1);
        top2 = fmaxf(top2, fminf(top1, v0));
        top1 = fmaxf(top1, v0);
        top2 = fmaxf(top2, fminf(top1, v1));
        top1 = fmaxf(top1, v1);
      }
      top2 = fminf(top2, __shfl_xor_sync(0xffffffffu, top2, 1));
      top2 = fminf(top2, __shfl_xor_sync(0xffffffffu, top2, 2));
      const float tile_thr = J <= 8 ? top2 : -INFINITY;
      pass[i] = 0u;
#pragma unroll
      for (int n = 0; n < SR / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * n + 2 * i + e];
          pass[i] |= (unsigned)(v > thr && v >= tile_thr) << (2 * n + e);
        }
      cnt[i] = __popc(pass[i]);
      cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], 1);
      cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], 2);
      if (g + 8 * i >= n_q) cnt[i] = 0;  // a query past Q
    }
    __syncwarp();
    // rows with more than SPARSE_MAX candidates (a block's first tile where J > 8): J
    // rounds of warp argmax (serve_select.cuh), one row after the other
    const unsigned dense = __ballot_sync(0xffffffffu, t4 == 0 && cnt[0] > SPARSE_MAX) |
                           (__ballot_sync(0xffffffffu, t4 == 0 && cnt[1] > SPARSE_MAX) << 1);
    for (unsigned m = dense; m != 0u; m &= m - 1u) {  // bit 4 g: row g; 4 g + 1: row g + 8
      const int b = __ffs(m) - 1, r = (b >> 2) + 8 * (b & 1);
      const float* row = sc + r * SR;
      u64 ck[SR / 32];
#pragma unroll
      for (int c = 0; c < SR / 32; ++c) {
        const int col = lane + 32 * c;
        ck[c] = pack_key(row[col ^ ((r & 7) << 3)], id0 + col);
      }
      merge_keys<SR / 32>(ck, lk + r * LSTRIDE, J, lane);
    }
    // the other rows: lane 4 g + i puts row g + 8 i's candidates into its list one by
    // one, the 16 rows at once (their lists LSTRIDE keys apart: on other banks)
    const int my_cnt = (t4 & 1) ? cnt[1] : cnt[0];
    unsigned masks[4];  // the row's candidates, by the lane holding them
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m0 = __shfl_sync(0xffffffffu, pass[0], 4 * g + k);
      const unsigned m1 = __shfl_sync(0xffffffffu, pass[1], 4 * g + k);
      masks[k] = (t4 & 1) ? m1 : m0;
    }
    if (t4 < 2 && my_cnt >= 1 && my_cnt <= SPARSE_MAX) {
      const int my_row = g + 8 * t4;
      u64* list = lk + my_row * LSTRIDE;
      const float* srow = sc + my_row * SR;
      if (J <= REG_J) {  // the list in registers: REG_J slots kept sorted, the first J kept
        u64 r[REG_J];
#pragma unroll
        for (int q = 0; q < REG_J; ++q) r[q] = q < J ? list[q] : 0ull;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          for (unsigned m = masks[k]; m != 0u; m &= m - 1u) {
            const int bit = __ffs(m) - 1;
            const int c = 8 * (bit >> 1) + 2 * k + (bit & 1);
            u64 x = pack_key(srow[c ^ (g << 3)], id0 + c);
#pragma unroll
            for (int q = 0; q < REG_J; ++q) {
              const u64 hi = r[q] > x ? r[q] : x;
              x = r[q] > x ? x : r[q];
              r[q] = hi;
            }
          }
#pragma unroll
        for (int q = 0; q < REG_J; ++q)
          if (q < J) list[q] = r[q];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          for (unsigned m = masks[k]; m != 0u; m &= m - 1u) {
            const int bit = __ffs(m) - 1;
            const int c = 8 * (bit >> 1) + 2 * k + (bit & 1);
            insert_key(list, J, pack_key(srow[c ^ (g << 3)], id0 + c));
          }
      }
    }
    __syncwarp();  // the lists are written and the tile read before the next tile
  }
  for (int idx = lane; idx < n_q * J; idx += 32) {
    const int r = idx / J, j = idx - r * J;
    const u64 k = lk[r * LSTRIDE + j];
    const size_t o = ((size_t)(qw + r) * n_blocks + block0 + blockIdx.y) * J + j;
    out_v[o] = k == 0ull ? -INFINITY : key_score(k);
    out_i[o] = k == 0ull ? -1 : key_row(k);
  }
}

// the tensor map of a bf16 matrix [rows, H], 64-column x 128-row boxes
int rows_map(CUtensorMap* map, const void* base, int rows, int H) {
  return tiled_map(map, base, 2, {(cuuint64_t)H, (cuuint64_t)rows, 1},
                   {(cuuint64_t)H * sizeof(bf), 0}, 128);
}

}  // namespace

// The PQ serve kernels K15 / K16: q [Q, H] bf16 (16-byte aligned) against PQ codes, codes
// [M, N] int8 (8-bit, code - 128) or [M/2, N] (4-bit, nibble-packed), M = H / d_sub, table
// [M, k, d_sub] (k = 256 or 16) bf16, or int8 with dscale [H] fp32 (8-bit only: K16); rows
// >= n_valid masked; serve selection -> out_vals / out_ids [Q, ceil(N / block), J]. Takes
// H % 128 == 0 and d_sub | 128. The corpus goes through in chunks of chunk_rows rows (a
// multiple of block, at most 65535 blocks), each decoded into scratch (bf16 [min(chunk_rows,
// N), H], 16-byte aligned), then scored: two launches a chunk. launched[0] / launched[1]
// (host ints, set to 0 first) count the decode and scoring launches that were made.
extern "C" int drt_pq_topj(const void* q, const void* codes, const void* table,
                           const void* dscale, void* scratch, void* out_v, void* out_i, int Q,
                           int N, int H, int d_sub, int nbits, int n_valid, int block, int J,
                           int chunk_rows, int* launched, void* stream) {
  launched[0] = launched[1] = 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(scratch);
  if (J < 1 || J > JMAX || block < 1 || (nbits != 4 && nbits != 8) ||
      (nbits == 4 && dscale != nullptr) || d_sub < 1 || 128 % d_sub != 0 || H % 128 != 0 ||
      chunk_rows < block || chunk_rows % block != 0 || chunk_rows / block > 65535 ||
      (ptrs & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q < 1 || N < 1) return 0;
  int dshift = 0;
  while ((1 << dshift) < d_sub) ++dshift;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (N + block - 1) / block;
  CUtensorMap tmq, tmr;
  if (int err = rows_map(&tmq, q, Q, H)) return err;
  cudaError_t err = cudaFuncSetAttribute(pq_score_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SCORE_SMEM);
  if (err != cudaSuccess) return (int)err;
  bf* rows_out = static_cast<bf*>(scratch);
  for (int row0 = 0; row0 < N; row0 += chunk_rows) {
    const int rows = min(chunk_rows, N - row0);
    if (int e = decode_pass(codes, table, static_cast<const float*>(dscale), rows_out, N, H,
                            dshift, nbits, row0, rows, st))
      return e;
    ++launched[0];
    if (int e = rows_map(&tmr, scratch, rows, H)) return e;
    const dim3 grid((Q + SQ - 1) / SQ, (rows + block - 1) / block);
    pq_score_wgmma<<<grid, S_THREADS, SCORE_SMEM, st>>>(
        tmq, tmr, static_cast<float*>(out_v), static_cast<int*>(out_i), Q, H, n_valid, block,
        J, row0, rows, row0 / block, n_blocks);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    ++launched[1];
  }
  return 0;
}
