// The serve selection shared by the block top-J kernels (block_topj.cu) and the PQ serve
// scoring body (pq_serve.cu): one packed 64-bit key per candidate, order-preserving
// score bits high and the inverted row id low, so a merge step is one comparison and
// ties go to the smaller id. The TPU packs into 32 bits (Mosaic has no top_k) and rounds
// the score to 2^id_bits ulps; here the key keeps all 32 score bits, so scores come back
// exact.
#pragma once

#include <math.h>

namespace drt {

using u64 = unsigned long long;

// The serve key: a larger key is a larger score or, on a tie, a smaller id. 0 is an
// empty slot (or a masked row): every finite score maps above it.
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

}  // namespace drt
