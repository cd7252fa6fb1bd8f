// The serve selection shared by the block top-J kernels (block_topj.cu), the native-int8 and
// int4 serve kernels (flat_serve.cu), the PQ serve scoring body (pq_serve.cu), the IVF cell
// kernels (ivf_cell.cu) and the certified searches (int4_certified.cu, flat_certified.cu): one
// packed 64-bit key per candidate, order-preserving score bits high and the inverted row id
// low, so a merge step is one comparison and ties go to the smaller id. The TPU packs into 32
// bits (Mosaic has no top_k) and rounds the score to 2^id_bits ulps; here the key keeps all 32
// score bits, so scores come back exact. The key orders -0 just below +0, as the reference's
// packed selection does; with the scores' -0 made +0 its order is also the certified order
// (score descending, then id ascending, equal scores equal whatever their sign).
#pragma once

#include <math.h>

namespace drt {

using u64 = unsigned long long;

// The order of a score, the serve key's high word: larger for a larger score, -0 just below
// +0; every finite score's is above 0.
__device__ __forceinline__ unsigned score_order(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The serve key: a larger key is a larger score or, on a tie, a smaller id. 0 is an
// empty slot (or a masked row): every finite score maps above it.
__device__ __forceinline__ u64 order_key(unsigned o, int row) {
  return ((u64)o << 32) | (u64)(~(unsigned)row);
}
__device__ __forceinline__ u64 pack_key(float v, int row) {
  if (v == -INFINITY) return 0ull;
  return order_key(score_order(v), row);
}
__device__ __forceinline__ float key_score(u64 k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_row(u64 k) { return (int)~(unsigned)(k & 0xffffffffu); }

// One warp merges 32 * CPL candidate keys (ck, CPL per lane) into a query's sorted top-J
// list qk (J <= 32, one entry per lane, 0 = empty). Candidates that cannot beat the
// J-th entry are skipped with one warp vote (keys carry their ids, so a tie is decided
// by the id and never displaces an entry); otherwise J rounds of warp argmax over the
// list and the candidates.
template <int CPL>
__device__ __forceinline__ void merge_keys(const u64 (&ck)[CPL], u64* qk, int J, int lane) {
  const u64 thr = qk[J - 1];
  bool beat = false;
#pragma unroll
  for (int c = 0; c < CPL; ++c) beat |= ck[c] > thr;
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

// A thread's own list of N keys in registers, sorted descending (int4_certified.cu,
// flat_certified.cu, flat_serve.cu, and ivf_cell.cu's K17 for J <= 8): the key x inserted, the smallest falling off, every entry's
// new value from its own comparison and its upper neighbour's, with no chain between entries.
template <int N>
__device__ __forceinline__ void insert_sorted(u64 (&L)[N], u64 x) {
  bool above[N];  // L[p] stays ahead of x
#pragma unroll
  for (int p = 0; p < N; ++p) above[p] = L[p] > x;
#pragma unroll
  for (int p = N - 1; p > 0; --p) L[p] = above[p] ? L[p] : (above[p - 1] ? x : L[p - 1]);
  L[0] = above[0] ? L[0] : x;
}

// the j-th key (from 0) of a list of N (a power of two): a select tree on the bits of j
template <int N>
__device__ __forceinline__ u64 jth_key(const u64 (&L)[N], int j) {
  if constexpr (N == 1) {
    return L[0];
  } else {
    u64 half[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) half[i] = (j & 1) ? L[2 * i + 1] : L[2 * i];
    return jth_key<N / 2>(half, j >> 1);
  }
}

// the score a key must beat to enter a list of J: its J-th, or -inf while it holds fewer
template <int N>
__device__ __forceinline__ float list_floor(const u64 (&L)[N], int J) {
  const u64 t = jth_key<N>(L, J - 1);
  return t == 0ull ? -INFINITY : key_score(t);
}

// ---- a thread's own list over a tile's rows (int4_certified.cu, flat_serve.cu, flat_certified.cu)
// A thread owns a sorted list of N keys and sees the rows of each tile in row order, each
// row as its score's order (score_order; the certified kernel makes -0 +0 first, so its
// order is the certified one). A row enters only past the order of the list's J-th key,
// the floor: an equal order cannot enter, since a later row carries a larger id. The floor
// only rises, so the rows past the floor at the tile's start are marked first, one bit a
// row, and only they reach the insertion.

// the order of the list's J-th key, 0 while it holds fewer than J (J = N: its last, no tree)
template <int N>
__device__ __forceinline__ unsigned list_floor_order(const u64 (&L)[N], int J) {
  return (unsigned)((J == N ? L[N - 1] : jth_key<N>(L, J - 1)) >> 32);
}

// The rows of a tile (ROWS <= 64, a multiple of 4) whose order beats `floor`, as a bitmask:
// order4(k, o) gives the orders of rows 4 k .. 4 k + 3; rows at or past n_rows are not stored.
template <int ROWS, typename Order4>
__device__ __forceinline__ unsigned long long tile_candidates(Order4 order4, unsigned floor,
                                                              int n_rows) {
  unsigned long long cand = 0ull;
#pragma unroll
  for (int k = 0; k < ROWS / 4; ++k) {
    unsigned o[4];
    order4(k, o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (o[e] > floor) cand |= 1ull << (4 * k + e);
  }
  if (n_rows < ROWS) cand &= n_rows <= 0 ? 0ull : (1ull << n_rows) - 1ull;
  return cand;
}

// The candidates of a tile (a bitmask), in row order, into the list L against the floor as it
// stands: order1(b) gives row b's order, row0 the tile's first row id.
template <int N, typename Order1>
__device__ __forceinline__ void insert_candidates(u64 (&L)[N], unsigned& floor,
                                                  unsigned long long cand, Order1 order1,
                                                  int row0, int J) {
  while (cand != 0ull) {
    const int b = __ffsll(cand) - 1;
    cand &= cand - 1ull;
    const unsigned o = order1(b);
    if (o > floor) {
      insert_sorted(L, order_key(o, row0 + b));
      floor = list_floor_order(L, J);
    }
  }
}

// A query's row of a score tile of orders as the selection reads it: four rows or one
// (flat_serve.cu, flat_certified.cu's fp32 body).
struct OrderRow {
  const unsigned* orow;
  __device__ __forceinline__ void operator()(int k, unsigned (&o)[4]) const {
    const uint4 v = *reinterpret_cast<const uint4*>(orow + 4 * k);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  __device__ __forceinline__ unsigned operator()(int b) const { return orow[b]; }
};

// The same with the list in shared memory (column `list` of a slot-major array, `stride`
// apart) and its floor at floor_at: both leave shared memory only where a row entered.
template <int N, int ROWS, typename Order4, typename Order1>
__device__ __forceinline__ void select_rows(u64* list, int stride, unsigned* floor_at,
                                            Order4 order4, Order1 order1, int n_rows, int row0,
                                            int J) {
  unsigned floor = *floor_at;
  const unsigned long long cand = tile_candidates<ROWS>(order4, floor, n_rows);
  if (cand == 0ull) return;
  u64 L[N];
#pragma unroll
  for (int p = 0; p < N; ++p) L[p] = list[p * stride];
  insert_candidates(L, floor, cand, order1, row0, J);
#pragma unroll
  for (int p = 0; p < N; ++p) list[p * stride] = L[p];
  *floor_at = floor;
}

// The two halves' lists of N keys of a query (a lane pair's L, thread 2 q + h holding half h
// of the block's rows) merged in its even thread, which writes them into out [Q, n_blocks, J]
// (query q0 + q, block blk; an empty entry (-inf, -1)).
template <int N>
__device__ __forceinline__ void write_pair_lists(u64 (&L)[N], int tid, int q0, int Q, int blk,
                                                 int n_blocks, int J, float* out_v, int* out_i) {
  const int my_q = tid >> 1, my_half = tid & 1;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const u64 other = __shfl_xor_sync(0xffffffffu, L[p], 1);
    if (my_half == 0) insert_sorted(L, other);
  }
  if (my_half == 0 && q0 + my_q < Q) {
    const size_t o = ((size_t)(q0 + my_q) * n_blocks + blk) * J;
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < J) {
        out_v[o + p] = L[p] == 0ull ? -INFINITY : key_score(L[p]);
        out_i[o + p] = L[p] == 0ull ? -1 : key_row(L[p]);
      }
  }
}

// The merge of a tile's 128 candidate keys into a list of up to 32 (ivf_cell.cu):
// candidates above the list's J-th key are inserted one by one up to INSERT_MAX, more take
// one warp bitonic pass.
namespace warp_select {

constexpr int INSERT_MAX = 32;  // candidates a list inserts one by one; more: bitonic

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

// One tile's candidate keys k (4 a lane, 0: masked) into a list (32 keys in shared memory,
// sorted descending, 0 = empty; the first J are the result).
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

}  // namespace warp_select

}  // namespace drt
