// Tiles of nibble-packed int4 rows as wgmma A fragments, read straight from a TMA stage
// (int4_certified.cu's K10, flat_serve.cu's K11 and K12 sq4 bodies).
//
// Rows are [N, H/2] bytes in the column-half layout of ops/quant.py (K9): byte j holds dim j in
// its low nibble and dim j + H/2 in its high nibble. A stage holds 64 rows x STAGE_BYTES packed
// bytes (two k-slices of 64 bytes: 128 dims each, 64 low and 64 high), brought by TMA with a
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)). Thread (w, g, t4) of the
// consumer warpgroup (warp w, g = lane / 4, t4 = lane % 4) gives the fragments of rows
// 16 w + g and 16 w + g + 8.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace drt {

constexpr int STAGE_BYTES = 128;  // packed bytes of a row a stage: two k-slices of 128 dims

// The packed words of one k-slice (h: the stage's first or second) a thread's A fragments
// need: rows 16 w + g (i = 0) and + 8 (i = 1), bytes 64 h + 16 m + 4 t4 (m = 0..3).
__device__ __forceinline__ void slice_words(unsigned (&w)[2][4], const unsigned char* stage,
                                            int h, int warp, int g, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[i][m] = *reinterpret_cast<const unsigned*>(
          stage + r * STAGE_BYTES + (((4 * h + m) ^ (r & 7)) << 4) + 4 * t4);
  }
}

// Four packed int4 bytes -> their four low nibbles or, with `high`, high nibbles, as four
// int8 n + 8 in [0, 15]: one AND-XOR (common.cuh's `nibbles` sign-extends with a byte-wise
// subtract, several instructions); the caller takes 8 x the other operand's sum off the sums.
__device__ __forceinline__ unsigned biased_nibbles(unsigned w, bool high) {
  return ((high ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// The s8 A fragments (m64nNk32) of the slice's four k32 steps from its words: steps 0 and 1
// the low nibbles (dims j of the slice's 64 bytes j), 2 and 3 the high ones (dims j + H/2),
// sign-extended to int8, or with BIASED as n + 8 (biased_nibbles). The B operand stores the
// slice's 128 dims in that order: dims j at bytes 0..63 of its 128-byte row, dims j + H/2 at
// bytes 64..127.
template <bool BIASED = false>
__device__ __forceinline__ void slice_fragments(unsigned (&a)[4][4], const unsigned (&w)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bool high = kk >= 2;
    const int m = 2 * (kk & 1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned x = w[r & 1][m + (r >> 1)];
      a[kk][r] = BIASED ? biased_nibbles(x, high) : nibbles(x, high);
    }
  }
}

// Bytes e = 2 p and 2 p + 1 of x (p = 0, 1), low nibbles, as a bf16x2 of their exact values
// (two's-complement nibbles n in [-8, 7]), with no int-to-float conversion: the bf16 bits
// 0x4300 | (x ^ 8) are 128 + (n + 8) exactly (the nibble fills the low mantissa bits of 128,
// whose ulp is 1), and one bf16x2 FMA takes 136 off both.
template <int P>
__device__ __forceinline__ unsigned nibble_pair_bf16(unsigned x) {
  const unsigned biased =
      (__byte_perm(x, 0u, P == 0 ? 0x4140 : 0x4342) & 0x000F000Fu) ^ 0x43084308u;
  unsigned v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(v)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // x 1 - 136
  return v;
}

// The bf16 A fragments (m64nNk16) of the slice's eight k16 steps from its words: step m the
// low nibbles of word m (dims 16 m + 0..15 of the slice's 64 bytes), step 4 + m the high ones
// (those dims + H/2). Within a step thread t4 gives the four dims 4 t4 .. 4 t4 + 3 of its
// word as k 2 t4, 2 t4 + 1 (a[0] / a[1]) and 2 t4 + 8, 2 t4 + 9 (a[2] / a[3]): dim 4 t + u of a
// group of 16 is column 2 t + (u & 1) + 8 (u >> 1) of the step (bf16_column), where the B
// operand stores it.
__device__ __forceinline__ void slice_fragments_bf16(unsigned (&a)[8][4],
                                                     const unsigned (&w)[2][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const unsigned x0 = hi ? w[0][m] >> 4 : w[0][m], x1 = hi ? w[1][m] >> 4 : w[1][m];
      unsigned (&f)[4] = a[4 * hi + m];
      f[0] = nibble_pair_bf16<0>(x0);
      f[1] = nibble_pair_bf16<0>(x1);
      f[2] = nibble_pair_bf16<1>(x0);
      f[3] = nibble_pair_bf16<1>(x1);
    }
}

// The column of dim offset i (0..15) of a group of 16 in a bf16 k16 step, as the fragments
// above (and flat_certified.cu's fp32 body) take them.
__host__ __device__ __forceinline__ int bf16_column(int i) {
  return 2 * (i >> 2) + (i & 1) + 8 * ((i >> 1) & 1);
}

}  // namespace drt
