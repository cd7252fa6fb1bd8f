// Per-block top-J of inner-product scores: one templated kernel family for K5, K6, K8,
// K10, K11 and K12.
//
// Replaces these TPU kernels of denseretrievaltoolkits_tpu/ops/topk.py:
//   K5  `_block_topj_kernel` (:37, launched by `_pallas_block_topj`, :336): exact top-J,
//       fp32 / bf16 rows;
//   K6  `_block_topj_kernel_scaled` (:65, `_pallas_block_topj_scaled`, :618): K5 over
//       int8 rows times a per-row scale, bf16 queries;
//   K8  `_packed_select` with `_block_topj_kernel_packed` / `_packed_scaled` (:94, :122,
//       :148; `pallas_topk_serve*`, :373, :411): the serve selection over fp32, bf16 and
//       int8 rows;
//   K12 `_block_topj_kernel_packed_i8q` (:190, :481): int8 queries x int8 rows, s32
//       products, times scale_row x scale_query, then the serve selection; and its sq4
//       body `_block_topj_kernel_packed_sq4_i8q` (:213, :517) over int4 rows;
//   K10 `_block_topj_kernel_sq4` (:237, `_pallas_block_topj_sq4`, :288): exact top-J over
//       int4 rows, fp32 queries, true-fp32 scores times the row scale;
//   K11 `_block_topj_kernel_packed_sq4` (:166, `_pallas_block_topj_packed_sq4`, :445): the
//       serve selection over int4 rows, bf16 queries.
// and these of denseretrievaltoolkits_tpu/ops/ivf_bulk.py (the IVF cell kernels, all with
// the serve selection):
//   K13 `_cell_topj_kernel` / `_scaled` / `_i8q` (:44, :61, :143; `_ivf_cell_topj`, :122):
//       per (cell, cell block) the cell's probing-query slab [Qcap, H] against the block's
//       rows of the fixed-capacity layout [nlist * C, H], empty slots (row id < 0) masked;
//   K14 `_ragged_kernel` / `_scaled` / `_i8q` (:165, :184, :202; `_ivf_ragged_topj`,
//       :272): the same over the ragged padded-flat block list, whose block -> cell map
//       picks the slab.
// The IVF kernels are this family with a per-block query base: a block reads its cell
// (block_cell[blk] for K14, blk / blocks-per-cell for K13; the TPU scalar-prefetches it)
// and stages its tile of that cell's slots, and the row mask reads the row ids. Their
// selection block may be narrower than the storage block: where the reference's Poisson
// J exceeds JMAX, the wrapper halves the selection block (never across a cell) until it
// fits, and a block then writes one list per selection block. Ids are flat row positions
// in the cell layout; the output is cell-major [n_selection_blocks, Qcap, J].
// int4 rows are nibble-packed [N, H/2] in the column-half layout of ops/quant.py (K9):
// byte j of a row holds dim j in its low nibble and dim j + H/2 in its high nibble. The
// TPU scores them as two half-dim products; here the rows are unpacked while they are
// staged (a sign extension per nibble, exact in every compute type) and scored over the
// full H by the same product loops as the other rows.
// For each (query tile, corpus block): scores q.c^T (x the row scale, x the query scale),
// rows >= n_valid masked, then the J best (score, id) pairs of the block with ties to
// the smaller id. Output layout [Q, n_blocks, J] (vals fp32, ids int32; an empty slot
// is (-inf, -1)), which the merge reads as [Q, n_blocks * J] without a transpose.
//
// Template parameters: the query element type QT (float, bf16, int8), the corpus
// element type CT (float, bf16, int8 or packed int4 with a per-row scale) and the
// selection SERVE.
// - Certified (K5, K6): the list is (score, id) pairs; the certificate and its
//   escalation ladder run on the host side (ops/topk.py:certified_topk).
// - Serve (K8, K12): one packed 64-bit key per candidate, order-preserving score bits
//   high and the inverted row id low, so a merge step is one comparison and ties go to
//   the smaller id. The TPU packs into 32 bits (Mosaic has no top_k) and rounds the
//   score to 2^id_bits ulps; here the key keeps all 32 score bits, so scores come back
//   exact.
// fp32 rows score in true fp32 (FFMA, no TF32) to match Precision.HIGHEST; bf16 rows
// score bf16 values with fp32 accumulation; int8 rows under bf16 queries convert to
// bf16 (|v| <= 127 is exact) and score on the same bf16 path, the scale multiplying in
// the score epilogue before selection; int8 x int8 (K12) runs the s8 tensor-core mma
// with s32 accumulation and dequantizes as float(s32) * scale_row * scale_q, the
// reference's order (topk.py:207-208). int4 rows unpack to fp32 under fp32 queries (K10,
// the FFMA path), to bf16 under bf16 queries (K11) and to int8 under int8 queries (K12
// sq4, whose s32 sums are exact in any order).
//
// What bounds it on the H100: the 2*Q*N*H products (989 TFLOP/s bf16, 1979 TOP/s int8,
// 67 TFLOP/s fp32 FFMA), and the corpus, which streams from device memory once per
// query tile (the query tiles of one corpus block are adjacent in the grid, so their
// re-reads hit L2). The [Q, N] score matrix never reaches device memory.
//
// Design: the TPU's J iterative masked maxes over a VMEM score block and its VMEM
// block cap do not carry over. A block of 256 threads serves 64 queries and walks its
// corpus block in sub-tiles of 128 rows; each sub-tile's scores land in shared memory,
// and each warp then updates the running top-J of its queries. A sub-tile that cannot
// beat a query's J-th entry is skipped with one warp vote (new rows always carry larger
// ids, so a tie never displaces an entry); otherwise J rounds of warp argmax merge the
// list (one entry per lane) with the 128 new candidates.
//
// - Tensor cores (bf16 or int8 queries, H % 64 == 0, 16-byte aligned): the queries
//   resident in shared memory, corpus k-slices of 64 elements double-buffered, fragments
//   by ldmatrix; bf16 mma.sync m16n8k16 or s8 mma.sync m16n8k32. Slices that keep their
//   type are staged by 16-byte cp.async; int8 rows under bf16 queries, and int4 rows, are
//   loaded into registers one slice ahead (16 packed bytes hold 16 dims of one half) and
//   converted as they are stored.
// - fp32 (products must stay exact fp32), and other widths: register-tiled FFMA
//   (8 queries x 4 rows per thread, fed by float4 shared loads), queries and corpus
//   staged transposed in 32-wide K chunks (int4 rows: 4 packed bytes per 4 dims).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace drt;

namespace {

using i8 = signed char;
using bf = __nv_bfloat16;
using u64 = unsigned long long;

constexpr int TN = 128;           // corpus rows per sub-tile
constexpr int NT = 256;           // threads per block
constexpr int JMAX = 32;          // one list entry per lane
constexpr int CPL = TN / 32;      // candidates per lane in the selection
constexpr size_t SMEM_MAX = 232448;
constexpr size_t LIST_BYTES = 8;  // per list entry: (fp32, int32) or one u64 key

// element type codes of the C interface
enum { T_F32 = 0, T_BF16 = 1, T_I8 = 2, T_I4 = 3 };

// the corpus element of int4 rows: one byte packs two dims, H/2 apart
struct nib {
  unsigned char b;
};

// Four packed bytes -> their four low nibbles (dims j) or high nibbles (dims j + H/2),
// sign-extended, as four int8 in one word: (n ^ 8) - 8 per byte, no borrow across bytes.
__device__ __forceinline__ unsigned nibbles(unsigned w, bool high) {
  const unsigned n = (high ? w >> 4 : w) & 0x0F0F0F0Fu;
  return __vsub4(n ^ 0x08080808u, 0x08080808u);
}

// The address of corpus element (row, k); for int4 rows the byte that holds dim k.
template <typename CT>
__device__ __forceinline__ const void* corpus_at(const CT* corpus, size_t row, int k, int H) {
  if constexpr (std::is_same_v<CT, nib>) {
    const int half = H >> 1;
    return reinterpret_cast<const unsigned char*>(corpus) + row * half + (k < half ? k : k - half);
  } else {
    return corpus + row * H + k;
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The serve key: order-preserving score bits high, the inverted row id low, so a
// larger key is a larger score or, on a tie, a smaller id. 0 is an empty slot (or a
// masked row): every finite score maps above it.
__device__ __forceinline__ u64 pack_key(float v, int row) {
  if (v == -INFINITY) return 0ull;
  const unsigned b = __float_as_uint(v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)o << 32) | (u64)(~(unsigned)row);
}
__device__ __forceinline__ float key_score(u64 k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_row(u64 k) { return (int)~(unsigned)(k & 0xffffffffu); }

// One warp merges a sub-tile's TN scores of one query (sc, rows base..base+TN-1,
// masked rows at -inf) into the query's sorted top-J list (qlv, qli).
__device__ __forceinline__ void merge_subtile(const float* sc, int base, float* qlv, int* qli,
                                              int J, int lane) {
  const float thr = qlv[J - 1];
  float cv[CPL];
  int ci[CPL];
  bool beat = false;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    cv[c] = sc[lane + 32 * c];
    ci[c] = base + lane + 32 * c;
    beat |= cv[c] > thr;
  }
  if (!__any_sync(0xffffffffu, beat)) return;
  const float av = lane < J ? qlv[lane] : -INFINITY;
  const int ai = lane < J ? qli[lane] : INT_MAX;
  bool a_taken = false;
  bool c_taken[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) c_taken[c] = false;
  float nv = -INFINITY;
  int ni = INT_MAX;
  for (int j = 0; j < J; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (!a_taken && better(av, ai, bv, bi)) { bv = av; bi = ai; }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (!c_taken[c] && better(cv[c], ci[c], bv, bi)) { bv = cv[c]; bi = ci[c]; }
    float rv = bv;
    int ri = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ri, o);
      if (better(ov, oi, rv, ri)) { rv = ov; ri = oi; }
    }
    if (rv == -INFINITY) break;  // only masked rows / empty slots remain
    if (lane == j) { nv = rv; ni = ri; }
    // ids of finite entries are unique, so exactly one lane owns the winner
    if (!a_taken && av == rv && ai == ri) a_taken = true;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (!c_taken[c] && cv[c] == rv && ci[c] == ri) c_taken[c] = true;
  }
  if (lane < J) { qlv[lane] = nv; qli[lane] = ni; }
  __syncwarp();
}

// The serve merge: the same rounds on packed keys, one comparison per step.
__device__ __forceinline__ void merge_subtile_packed(const float* sc, int base, u64* qk, int J,
                                                     int lane) {
  const u64 thr = qk[J - 1];
  u64 ck[CPL];
  bool beat = false;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    ck[c] = pack_key(sc[lane + 32 * c], base + lane + 32 * c);
    beat |= ck[c] > thr;
  }
  if (!__any_sync(0xffffffffu, beat)) return;
  const u64 a = lane < J ? qk[lane] : 0ull;
  bool a_taken = false;
  bool c_taken[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) c_taken[c] = false;
  u64 nk = 0ull;
  for (int j = 0; j < J; ++j) {
    u64 b = a_taken ? 0ull : a;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (!c_taken[c] && ck[c] > b) b = ck[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 ob = __shfl_xor_sync(0xffffffffu, b, o);
      b = ob > b ? ob : b;
    }
    if (b == 0ull) break;  // only masked rows / empty slots remain
    if (lane == j) nk = b;
    // keys carry their row id, so exactly one lane owns the winner
    if (!a_taken && a == b) a_taken = true;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (!c_taken[c] && ck[c] == b) c_taken[c] = true;
  }
  if (lane < J) qk[lane] = nk;
  __syncwarp();
}

// The running top-J lists of a block's queries, in LIST_BYTES * JMAX bytes per query
// of shared memory: (fp32 score, int32 id) pairs, or packed keys for the serve selection.
template <bool SERVE>
struct Lists {
  unsigned char* p;
  int n;  // queries
  __device__ float* lv() const { return reinterpret_cast<float*>(p); }
  __device__ int* li() const { return reinterpret_cast<int*>(p) + n * JMAX; }
  __device__ u64* lk() const { return reinterpret_cast<u64*>(p); }

  __device__ void init() const {
    for (int idx = threadIdx.x; idx < n * JMAX; idx += NT) {
      if constexpr (SERVE) {
        lk()[idx] = 0ull;
      } else {
        lv()[idx] = -INFINITY;
        li()[idx] = INT_MAX;
      }
    }
  }
  __device__ void merge(const float* sc, int base, int qi, int J, int lane) const {
    if constexpr (SERVE)
      merge_subtile_packed(sc, base, lk() + qi * JMAX, J, lane);
    else
      merge_subtile(sc, base, lv() + qi * JMAX, li() + qi * JMAX, J, lane);
  }
  // lists of the n queries q0.. of selection block sb -> out[Q, n_sel, J], or
  // cell-major out[n_sel, Q, J]
  __device__ void write(int q0, int Q, int sb, int n_sel, int J, bool cell_major, float* out_v,
                        int* out_i) const {
    for (int idx = threadIdx.x; idx < n * J; idx += NT) {
      const int r = idx / J, j = idx - r * J;
      if (q0 + r >= Q) continue;
      const size_t o = cell_major ? ((size_t)sb * Q + q0 + r) * J + j
                                  : ((size_t)(q0 + r) * n_sel + sb) * J + j;
      if constexpr (SERVE) {
        const u64 k = lk()[r * JMAX + j];
        out_v[o] = k == 0ull ? -INFINITY : key_score(k);
        out_i[o] = k == 0ull ? -1 : key_row(k);
      } else {
        const float v = lv()[r * JMAX + j];
        out_v[o] = v;
        out_i[o] = v == -INFINITY ? -1 : li()[r * JMAX + j];
      }
    }
  }
};

// Where a block's rows and queries come from. The flat family: one query matrix, rows
// < n_valid, selection block = storage block. The IVF kernels (row_ids set): the queries
// of the block's cell, rows whose id is >= 0, selection blocks of `sel` rows.
struct Cells {
  const int* row_ids;     // IVF: [N] flat row -> corpus id, -1 = empty; null: flat family
  const int* block_cell;  // K14: [n_blocks] storage block -> cell; null: blk / cell_blocks
  int cell_blocks;        // K13: storage blocks per cell
  int sel;                // rows per selection block (the storage block for the flat family)
  int n_sel;              // selection blocks in all (the output's block extent)
};

// the cell of storage block blk, whose slab of Q query slots the block scores (0 for the
// flat family's one query matrix)
__device__ __forceinline__ size_t cell_of(const Cells& cells, int blk) {
  if (cells.row_ids == nullptr) return 0;
  return cells.block_cell != nullptr ? __ldg(cells.block_cell + blk) : blk / cells.cell_blocks;
}

// a sub-tile score: the product, x the row scale, x the query scale (the reference's
// order), or -inf for a masked row (past n_valid or the selection block, or an empty IVF
// slot)
__device__ __forceinline__ float epilogue(float acc, int row, int q, int n_valid, int row_end,
                                          const float* cscale, const float* qscale,
                                          const int* row_ids) {
  if (row >= n_valid || row >= row_end) return -INFINITY;
  if (row_ids != nullptr && __ldg(row_ids + row) < 0) return -INFINITY;
  float v = acc;
  if (cscale != nullptr) v *= __ldg(cscale + row);
  if (qscale != nullptr) v *= __ldg(qscale + q);
  return v;
}

// ---- tensor-core path (bf16 or int8 queries) ------------------------------------------

constexpr int MQ = 64;  // queries per block
constexpr int MK = 64;  // corpus k-slice (elements) staged per step

// the element the mma consumes: int8 under int8 queries, else bf16
template <typename QT>
using MmaT = std::conditional_t<std::is_same_v<QT, i8>, i8, bf>;

template <typename QT>
size_t mma_smem_bytes(int H) {
  using ME = MmaT<QT>;
  const size_t pad = 16 / sizeof(ME);  // 16-byte row pads keep ldmatrix conflict-free
  return sizeof(QT) * (size_t)MQ * (H + pad) + sizeof(ME) * 2 * (size_t)TN * (MK + pad) +
         sizeof(float) * (size_t)MQ * (TN + 1) + LIST_BYTES * MQ * JMAX;
}

template <typename QT, typename CT, bool SERVE>
__global__ void __launch_bounds__(NT)
block_topj_mma_kernel(const QT* __restrict__ q, const CT* __restrict__ corpus,
                      const float* __restrict__ cscale, const float* __restrict__ qscale,
                      float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                      int n_valid, int block, int J, Cells cells) {
  using ME = MmaT<QT>;
  constexpr bool INT8 = std::is_same_v<QT, i8>;
  constexpr bool NIB = std::is_same_v<CT, nib>;
  constexpr bool CONVERT = !std::is_same_v<CT, ME>;  // int8 rows under bf16 queries, int4
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int PAD = 16 / sizeof(ME);
  constexpr int LDW = MK + PAD;            // corpus slice row, elements
  constexpr int LDWB = LDW * sizeof(ME);   // ... bytes
  constexpr int KSTEP = 32;                // bytes of k per mma
  constexpr int LDSC = TN + 1;
  const int LDQB = (H + 16 / (int)sizeof(QT)) * sizeof(QT);  // query row, bytes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                      // [MQ][LDQB]
  ME* cs = reinterpret_cast<ME*>(qs + (size_t)MQ * LDQB);        // [2][TN][LDW]
  float* sc = reinterpret_cast<float*>(cs + 2 * TN * LDW);       // [MQ][LDSC]
  const Lists<SERVE> lists{reinterpret_cast<unsigned char*>(sc + MQ * LDSC), MQ};

  const int q0 = blockIdx.x * MQ;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3;           // this warp's m16 tile of queries
  const int nb = (warp >> 2) * 8;    // and its eight n8 tiles of the sub-tile's rows
  const int blk_start = blk * block;
  const int row_end = min(N, blk_start + block);
  const int per = (block + cells.sel - 1) / cells.sel;  // selection blocks per storage block
  const size_t cell = cell_of(cells, blk);
  q += cell * Q * H;
  if (qscale != nullptr) qscale += cell * Q;

  const int qrow_chunks = H * (int)sizeof(QT) / 16;
  for (int idx = tid; idx < MQ * qrow_chunks; idx += NT) {
    const int r = idx / qrow_chunks, c = (idx - r * qrow_chunks) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Q)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(q) +
                                          (size_t)(q0 + r) * H * sizeof(QT) + c);
    *reinterpret_cast<uint4*>(qs + (size_t)r * LDQB + c) = v;
  }
  lists.init();

  // a slice: TN rows x MK elements of the corpus; CHUNKS 16-byte corpus loads per thread
  constexpr int SLICE_CHUNKS = TN * MK * (int)sizeof(CT) / 16;
  constexpr int CHUNKS = SLICE_CHUNKS / NT;
  static_assert(SLICE_CHUNKS % NT == 0, "slice loads must divide evenly");
  // corpus elements per 16-byte load: 16 int8, 8 bf16, or the 16 dims of one half that
  // 16 packed int4 bytes hold (H % 64 == 0, so a load never straddles the halves)
  constexpr int PER_CHUNK = 16 / (int)sizeof(CT);
  uint4 held[CONVERT ? CHUNKS : 1];                // converted rows one slice ahead

  auto fetch_slice = [&](int buf, int base, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / (MK / PER_CHUNK), c = (idx - r * (MK / PER_CHUNK)) * PER_CHUNK;
      const void* src = corpus_at(corpus, (size_t)(base + r), k0 + c, H);
      if constexpr (CONVERT) {
        held[i] = base + r < N ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      } else {
        ME* dst = cs + (buf * TN + r) * LDW + c;
        if (base + r < N)
          cp_async16(dst, src);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  // the held slice k0.. into buffer buf: int4 nibbles sign-extended to int8, then int8
  // -> bf16 under bf16 queries (both exact)
  auto store_held = [&](int buf, int k0) {
    if constexpr (CONVERT) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int idx = tid + i * NT;
        const int r = idx / (MK / PER_CHUNK), c = (idx - r * (MK / PER_CHUNK)) * PER_CHUNK;
        uint4 u = held[i];
        if constexpr (NIB) {
          const bool high = k0 + c >= (H >> 1);
          u = make_uint4(nibbles(u.x, high), nibbles(u.y, high), nibbles(u.z, high),
                         nibbles(u.w, high));
        }
        uint4* dst = reinterpret_cast<uint4*>(cs + (buf * TN + r) * LDW + c);
        if constexpr (INT8) {
          dst[0] = u;
        } else {
          const i8* v = reinterpret_cast<const i8*>(&u);
          __nv_bfloat162 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __floats2bfloat162_rn((float)v[2 * e], (float)v[2 * e + 1]);
          dst[0] = *reinterpret_cast<const uint4*>(&o[0]);
          dst[1] = *reinterpret_cast<const uint4*>(&o[4]);
        }
      }
    }
  };

  const int ns = H / MK;
  // one sub-tile: TN rows from base scored against the query tile into sc, rows at or
  // past s_end masked, then merged into the lists
  auto subtile = [&](int base, int s_end) {
    Acc acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    fetch_slice(0, base, 0);
    if constexpr (CONVERT) store_held(0, 0);
    cp_async_commit();
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) fetch_slice((s + 1) & 1, base, (s + 1) * MK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned char* cb = reinterpret_cast<const unsigned char*>(cs + (s & 1) * TN * LDW);
#pragma unroll
      for (int kb = 0; kb < MK * (int)sizeof(ME); kb += KSTEP) {
        unsigned a[4];
        ldmatrix_x4(a, qs + (size_t)(mt * 16 + (lane & 15)) * LDQB + s * MK * sizeof(QT) + kb +
                           16 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          unsigned b[4];  // rows of tiles nb+j, nb+j+1; k halves kb, kb+16 bytes
          ldmatrix_x4(b, cb + ((nb + j) * 8 + (lane & 7) + 8 * (lane >> 4)) * LDWB + kb +
                             16 * ((lane >> 3) & 1));
          if constexpr (INT8) {
            mma_s8_16x8x32(acc[j], a, b[0], b[1]);
            mma_s8_16x8x32(acc[j + 1], a, b[2], b[3]);
          } else {
            mma_bf16_16x8x16(acc[j], a, b[0], b[1]);
            mma_bf16_16x8x16(acc[j + 1], a, b[2], b[3]);
          }
        }
      }
      // converted rows: the next slice's registers go to the buffer read one step ago
      if constexpr (CONVERT)
        if (s + 1 < ns) store_held((s + 1) & 1, (s + 1) * MK);
      __syncthreads();  // this slice's buffer is refilled two steps on
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (nb + j) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), c = n + (e & 1);
        sc[r * LDSC + c] = epilogue((float)acc[j][e], base + c, q0 + r, n_valid, s_end,
                                    cscale, qscale, cells.row_ids);
      }
    }
    __syncthreads();
    for (int qi = warp * (MQ / 8); qi < (warp + 1) * (MQ / 8); ++qi)
      lists.merge(sc + qi * LDSC, base, qi, J, lane);
    // the next sub-tile rewrites sc only after its first slice barrier
  };
  for (int sb = 0; sb < per; ++sb) {  // selection blocks: one top-J list each
    const int s0 = blk_start + sb * cells.sel;
    const int s_end = min(row_end, s0 + cells.sel);
    if (sb > 0) {
      __syncthreads();  // the previous selection block's lists are written
      lists.init();
    }
    for (int base = s0; base < s_end; base += TN) subtile(base, s_end);
    __syncthreads();
    lists.write(q0, Q, blk * per + sb, cells.n_sel, J, cells.row_ids != nullptr, out_v, out_i);
  }
}

// ---- CUDA-core path ------------------------------------------------------------------

constexpr int TQ = 64;  // queries per block
constexpr int KT = 32;  // K chunk staged in shared memory
constexpr int LDQT = TQ + 4;  // chunk rows: float4-aligned, conflict-free column stores
constexpr int LDCT = TN + 4;

size_t smem_bytes() {
  return sizeof(float) * ((size_t)KT * LDQT + (size_t)KT * LDCT + (size_t)TQ * (TN + 1)) +
         LIST_BYTES * TQ * JMAX;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// The K chunk a thread stages: VEC (fp32, H % 4 == 0, 16-byte aligned) as float4 of
// 4 consecutive k, else as single elements; consecutive threads read consecutive k of
// one row, so global reads coalesce. Held in registers while the previous chunk is
// scored, then stored transposed.
template <typename QT, typename CT, bool VEC>
struct Chunk {
  static constexpr int W = VEC ? 4 : 1;                // elements per load
  static constexpr int NC = KT * TN / (W * NT);        // corpus loads per thread
  static constexpr int NQ = KT * TQ / (W * NT);        // query loads per thread
  float cv[NC][W], qv[NQ][W];

  template <typename T>
  __device__ __forceinline__ static void fetch_one(const T* src, int rows, int r, int k, int H,
                                                   float (&v)[W]) {
    if constexpr (VEC) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && k < H) t = *reinterpret_cast<const float4*>(src + (size_t)r * H + k);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = r < rows && k < H ? to_float(src[(size_t)r * H + k]) : 0.f;
    }
  }
  // int4 rows: W dims of one half (VEC: H % 8 == 0, so W = 4 never straddles them), W
  // consecutive packed bytes
  __device__ __forceinline__ static void fetch_nib(const nib* corpus, size_t row, bool in, int k,
                                                   int H, float (&v)[W]) {
    const unsigned char* p = static_cast<const unsigned char*>(corpus_at(corpus, row, k, H));
    unsigned w = 0u;
    if (in) w = VEC ? *reinterpret_cast<const unsigned*>(p) : (unsigned)*p;
    w = nibbles(w, k >= (H >> 1));
    const i8* e = reinterpret_cast<const i8*>(&w);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = (float)e[j];
  }
  __device__ __forceinline__ void fetch(const CT* corpus, const QT* q, int base, int row_end,
                                        int q0, int Q, int k0, int H) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / (KT / W), k = (idx % (KT / W)) * W;
      if constexpr (std::is_same_v<CT, nib>)
        fetch_nib(corpus, (size_t)(base + r), r < row_end - base && k0 + k < H, k0 + k, H, cv[i]);
      else
        fetch_one(corpus + (size_t)base * H, row_end - base, r, k0 + k, H, cv[i]);
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / (KT / W), k = (idx % (KT / W)) * W;
      fetch_one(q + (size_t)q0 * H, Q - q0, r, k0 + k, H, qv[i]);
    }
  }
  __device__ __forceinline__ void store(float* ct, float* qt) const {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / (KT / W), k = (idx % (KT / W)) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) ct[(k + e) * LDCT + r] = cv[i][e];
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / (KT / W), k = (idx % (KT / W)) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) qt[(k + e) * LDQT + r] = qv[i][e];
    }
  }
};

template <typename QT, typename CT, bool VEC, bool SERVE>
__global__ void __launch_bounds__(NT)
block_topj_kernel(const QT* __restrict__ q, const CT* __restrict__ corpus,
                  const float* __restrict__ cscale, const float* __restrict__ qscale,
                  float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                  int n_valid, int block, int J, Cells cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);  // [KT][LDQT]: a K chunk of the queries
  float* ct = qt + KT * LDQT;                  // [KT][LDCT]: a K chunk of the sub-tile rows
  float* sc = ct + KT * LDCT;                  // [TQ][TN+1]
  const Lists<SERVE> lists{reinterpret_cast<unsigned char*>(sc + TQ * (TN + 1)), TQ};

  const int q0 = blockIdx.x * TQ;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t cell = cell_of(cells, blk);
  q += cell * Q * H;
  if (qscale != nullptr) qscale += cell * Q;
  // each thread scores queries 8*warp .. +7 against rows 4*lane .. +3 of the sub-tile:
  // one float4 of rows and two of queries per 32 FFMA
  lists.init();

  const int blk_start = blk * block;
  const int row_end = min(N, blk_start + block);
  const int per = (block + cells.sel - 1) / cells.sel;  // selection blocks per storage block
  const int nk = (H + KT - 1) / KT;
  Chunk<QT, CT, VEC> next;
  next.fetch(corpus, q, blk_start, row_end, q0, Q, 0, H);
  // one sub-tile: TN rows from base scored into sc, rows at or past s_end masked, then
  // merged into the lists; the chunks of the sub-tile that starts at `following` are
  // prefetched meanwhile
  auto subtile = [&](int base, int s_end, int following) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();  // previous readers of the chunks (and of sc, for the first) are done
      next.store(ct, qt);
      __syncthreads();
      // prefetch the next chunk (or the next sub-tile's first) while this one is scored
      if (kc + 1 < nk)
        next.fetch(corpus, q, base, row_end, q0, Q, (kc + 1) * KT, H);
      else if (following < row_end)
        next.fetch(corpus, q, following, row_end, q0, Q, 0, H);
      const int kmax = min(KT, H - kc * KT);
      for (int kk = 0; kk < kmax; ++kk) {
        float c[4], qa[4], qb[4];
        load4(ct + kk * LDCT + 4 * lane, c);
        load4(qt + kk * LDQT + 8 * warp, qa);
        load4(qt + kk * LDQT + 8 * warp + 4, qb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j] = fmaf(qa[i], c[j], acc[i][j]);
            acc[i + 4][j] = fmaf(qb[i], c[j], acc[i + 4][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[(8 * warp + i) * (TN + 1) + 4 * lane + j] =
            epilogue(acc[i][j], base + 4 * lane + j, q0 + 8 * warp + i, n_valid, s_end, cscale,
                     qscale, cells.row_ids);
    __syncthreads();
    for (int qi = warp * (TQ / 8); qi < (warp + 1) * (TQ / 8); ++qi)
      lists.merge(sc + qi * (TN + 1), base, qi, J, lane);
  };
  for (int sb = 0; sb < per; ++sb) {  // selection blocks: one top-J list each
    const int s0 = blk_start + sb * cells.sel;
    const int s_end = min(row_end, s0 + cells.sel);
    if (sb > 0) {
      __syncthreads();  // the previous selection block's lists are written
      lists.init();
    }
    // sub-tiles in row order; the next selection block starts at s_end
    for (int base = s0; base < s_end; base += TN)
      subtile(base, s_end, base + TN < s_end ? base + TN : s_end);
    __syncthreads();
    lists.write(q0, Q, blk * per + sb, cells.n_sel, J, cells.row_ids != nullptr, out_v, out_i);
  }
}

struct Args {
  const void *q, *corpus, *cscale, *qscale;
  void *out_v, *out_i;
  int Q, N, H, n_valid, block, J;
  Cells cells;
  cudaStream_t stream;
};

// One kernel over every storage block, one grid row each (the grid's y extent takes at
// most 65535 of them; callers pass slabs or cell layouts far below that). Query tiles run
// fastest: the tiles that read one corpus block run side by side (L2 reuse).
template <typename QT, typename CT, typename K>
int launch_blocks(K kernel, int tile, size_t smem, const Args& a) {
  const int n_blocks = (a.N + a.block - 1) / a.block;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Q + tile - 1) / tile, n_blocks);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CT*>(a.corpus),
      static_cast<const float*>(a.cscale), static_cast<const float*>(a.qscale),
      static_cast<float*>(a.out_v), static_cast<int*>(a.out_i), a.Q, a.N, a.H, a.n_valid,
      a.block, a.J, a.cells);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT, bool VEC, bool SERVE>
int launch(const Args& a) {
  return launch_blocks<QT, CT>(block_topj_kernel<QT, CT, VEC, SERVE>, TQ, smem_bytes(), a);
}

// the tensor-core path, or -1 when the shape or alignment does not fit it
template <typename QT, typename CT, bool SERVE>
int try_mma(const Args& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.corpus);
  const size_t smem = mma_smem_bytes<QT>(a.H);
  if (a.H % MK != 0 || (ptrs & 15) != 0 || smem > SMEM_MAX) return -1;
  return launch_blocks<QT, CT>(block_topj_mma_kernel<QT, CT, SERVE>, MQ, smem, a);
}

template <bool SERVE>
int dispatch(const Args& a, int qtype, int ctype) {
  if (qtype == T_F32 && ctype == T_F32) {
    const uintptr_t ptrs =
        reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.corpus);
    if (a.H % 4 == 0 && (ptrs & 15) == 0) return launch<float, float, true, SERVE>(a);
    return launch<float, float, false, SERVE>(a);
  }
  if (qtype == T_BF16 && ctype == T_BF16) {
    const int code = try_mma<bf, bf, SERVE>(a);
    return code >= 0 ? code : launch<bf, bf, false, SERVE>(a);
  }
  if (qtype == T_BF16 && ctype == T_I8) {
    const int code = try_mma<bf, i8, SERVE>(a);
    return code >= 0 ? code : launch<bf, i8, false, SERVE>(a);
  }
  if (SERVE && qtype == T_I8 && ctype == T_I8) {
    const int code = try_mma<i8, i8, true>(a);
    return code >= 0 ? code : (int)cudaErrorInvalidValue;  // s8 products need the mma path
  }
  if constexpr (SERVE) {
    if (qtype == T_BF16 && ctype == T_I4) {  // K11
      const int code = try_mma<bf, nib, true>(a);
      return code >= 0 ? code : launch<bf, nib, false, true>(a);
    }
    if (qtype == T_I8 && ctype == T_I4) {  // K12 sq4
      const int code = try_mma<i8, nib, true>(a);
      return code >= 0 ? code : (int)cudaErrorInvalidValue;
    }
  } else if (qtype == T_F32 && ctype == T_I4) {  // K10
    const uintptr_t q16 = reinterpret_cast<uintptr_t>(a.q) & 15;
    const uintptr_t c4 = reinterpret_cast<uintptr_t>(a.corpus) & 3;
    if (a.H % 8 == 0 && q16 == 0 && c4 == 0) return launch<float, nib, true, false>(a);
    return launch<float, nib, false, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [Q,H] (qtype), corpus [N,H] (ctype) or [N,H/2] (int4), cscales [N] fp32 or null,
// qscales [Q] fp32 or null -> out_vals [Q, n_blocks, J] fp32, out_ids [Q, n_blocks, J]
// int32. Types: 0 fp32, 1 bf16, 2 int8, 3 int4 (nibble-packed, column halves, H even).
// Pairs taken: fp32 x fp32, bf16 x bf16, bf16 x int8, fp32 x int4 (certified only), and
// (serve only) bf16 x int4, and int8 x int8 / int8 x int4 at H % 64 == 0 with 16-byte
// aligned rows.
extern "C" int drt_block_topj(const void* q, const void* corpus, const void* cscales,
                              const void* qscales, void* out_v, void* out_i, int Q, int N, int H,
                              int n_valid, int block, int J, int qtype, int ctype, int serve,
                              void* stream) {
  if (J < 1 || J > JMAX || block < 1 || (ctype == T_I4 && H % 2))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + block - 1) / block;
  const Args a{q, corpus, cscales, qscales, out_v, out_i, Q, N, H, n_valid, block, J,
               Cells{nullptr, nullptr, 1, block, n_blocks}, static_cast<cudaStream_t>(stream)};
  return serve ? dispatch<true>(a, qtype, ctype) : dispatch<false>(a, qtype, ctype);
}

// The IVF cell kernels (K13, K14), serve selection. qslab [nlist, Qcap, H] (qtype), the
// probing-query slots of each cell; values [N, H] (ctype) in N / block storage blocks,
// each inside one cell; row_ids [N] (-1 = empty slot, masked); cscales [N] fp32 for int8
// cells, else null; qscales [nlist, Qcap] fp32 for int8 queries, else null. block_cell
// [N / block] int32 gives each block's cell (K14); null, the cell is blk / cell_blocks
// (K13: C = cell_blocks * block rows per cell). Each storage block is cut into selection
// blocks of `sel` rows (the last one shorter where sel does not divide block) ->
// out_vals / out_ids [N / block * ceil(block / sel), Qcap, J], ids flat row positions.
// Pairs taken: fp32 x fp32, bf16 x bf16, bf16 x int8 and, at H % 64 == 0 with 16-byte
// aligned rows, int8 x int8.
extern "C" int drt_ivf_topj(const void* qslab, const void* values, const void* cscales,
                            const void* qscales, const void* row_ids, const void* block_cell,
                            void* out_v, void* out_i, int Qcap, int N, int H, int block, int sel,
                            int J, int cell_blocks, int qtype, int ctype, void* stream) {
  if (J < 1 || J > JMAX || block < 1 || sel < 1 || sel > block || N % block != 0 ||
      row_ids == nullptr || ctype == T_I4 || (block_cell == nullptr && cell_blocks < 1))
    return (int)cudaErrorInvalidValue;
  const int n_sel = N / block * ((block + sel - 1) / sel);
  const Args a{qslab, values, cscales, qscales, out_v, out_i, Qcap, N, H, INT_MAX, block, J,
               Cells{static_cast<const int*>(row_ids), static_cast<const int*>(block_cell),
                     cell_blocks, sel, n_sel},
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, qtype, ctype);
}
