// K5: per-block exact top-J of inner-product scores, one kernel.
//
// Replaces the TPU kernel `_block_topj_kernel` (denseretrievaltoolkits_tpu/ops/topk.py:37,
// launched by `_pallas_block_topj`, topk.py:336). For each (query tile, corpus block):
// scores q.c^T, rows >= n_valid masked, then the J best (score, id) pairs of the block
// with ties to the smaller id. fp32 corpora score in true fp32 (FFMA, no TF32) to match
// Precision.HIGHEST; bf16 corpora score bf16 values with fp32 accumulation.
// Output layout [Q, n_blocks, J] (vals fp32, ids int32; an empty slot is (-inf, -1)),
// which the merge reads as [Q, n_blocks * J] without a transpose.
//
// What bounds it on the H100: the 2*Q*N*H products, and the corpus, which streams from
// device memory once per query tile (the query tiles of one corpus block are adjacent
// in the grid, so their re-reads hit L2). The [Q, N] score matrix never reaches device
// memory.
//
// Design: the TPU's J iterative masked maxes over a VMEM score block and its VMEM
// block cap do not carry over. A block of 256 threads serves 64 queries and walks its
// corpus block in sub-tiles of 128 rows; each sub-tile's scores
// land in shared memory, and each warp then updates the running top-J of its queries.
// A sub-tile that cannot beat a query's J-th score is skipped with one warp vote (new
// rows always carry larger ids, so a tie never displaces an entry); otherwise J rounds
// of warp argmax merge the list (one entry per lane) with the 128 new candidates.
//
// - bf16 with H % 64 == 0: the queries resident in shared memory, scores on tensor
//   cores (mma.sync m16n8k16, fp32 accumulation), corpus k-slices of 64
//   double-buffered by 16-byte cp.async, fragments by ldmatrix.
// - fp32 (products must stay exact fp32), and other widths: register-tiled FFMA
//   (8 queries x 4 rows per thread, fed by float4 shared loads), queries and corpus
//   staged transposed in 32-wide K chunks.
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace drt;

namespace {

constexpr int TN = 128;           // corpus rows per sub-tile
constexpr int NT = 256;           // threads per block
constexpr int JMAX = 32;          // one list entry per lane
constexpr int CPL = TN / 32;      // candidates per lane in the selection
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

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

// lists of TQ queries -> out[Q, n_blocks, J]
__device__ __forceinline__ void write_lists(const float* lv, const int* li, int TQ, int q0, int Q,
                                            int blk, int n_blocks, int J, float* out_v,
                                            int* out_i) {
  for (int idx = threadIdx.x; idx < TQ * J; idx += NT) {
    const int r = idx / J, j = idx - r * J;
    if (q0 + r < Q) {
      const float v = lv[r * JMAX + j];
      const size_t o = ((size_t)(q0 + r) * n_blocks + blk) * J + j;
      out_v[o] = v;
      out_i[o] = v == -INFINITY ? -1 : li[r * JMAX + j];
    }
  }
}

// ---- tensor-core path (bf16) --------------------------------------------------------

constexpr int MQ = 64;  // queries per block
constexpr int MK = 64;  // corpus k-slice staged per step

size_t mma_smem_bytes(int H) {
  return sizeof(__nv_bfloat16) * ((size_t)MQ * (H + 8) + 2 * (size_t)TN * (MK + 8)) +
         sizeof(float) * ((size_t)MQ * (TN + 1) + (size_t)MQ * JMAX) + sizeof(int) * MQ * JMAX;
}

__global__ void __launch_bounds__(NT)
block_topj_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ corpus,
                      float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                      int n_valid, int block, int J) {
  using bf = __nv_bfloat16;
  constexpr int LDW = MK + 8;  // the 16-byte pads keep ldmatrix conflict-free
  constexpr int LDSC = TN + 1;
  const int LDQ = H + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* qs = reinterpret_cast<bf*>(smem);          // [MQ][LDQ]
  bf* cs = qs + MQ * LDQ;                        // [2][TN][LDW]
  float* sc = reinterpret_cast<float*>(cs + 2 * TN * LDW);  // [MQ][LDSC]
  float* lv = sc + MQ * LDSC;                    // [MQ][JMAX]
  int* li = reinterpret_cast<int*>(lv + MQ * JMAX);

  const int q0 = blockIdx.x * MQ;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3;           // this warp's m16 tile of queries
  const int nb = (warp >> 2) * 8;    // and its eight n8 tiles of the sub-tile's rows
  const int row_end = min(N, (blk + 1) * block);

  for (int idx = tid; idx < MQ * H / 8; idx += NT) {
    const int r = idx / (H / 8), c = (idx - r * (H / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Q) v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * H + c);
    *reinterpret_cast<uint4*>(qs + r * LDQ + c) = v;
  }
  for (int idx = tid; idx < MQ * JMAX; idx += NT) {
    lv[idx] = -INFINITY;
    li[idx] = INT_MAX;
  }
  auto load_slice = [&](int buf, int base, int k0) {
    for (int idx = tid; idx < TN * MK / 8; idx += NT) {
      const int r = idx / (MK / 8), c = (idx - r * (MK / 8)) * 8;
      bf* dst = cs + (buf * TN + r) * LDW + c;
      if (base + r < N)
        cp_async16(dst, corpus + (size_t)(base + r) * H + k0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  const int ns = H / MK;
  for (int base = blk * block; base < row_end; base += TN) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    load_slice(0, base, 0);
    cp_async_commit();
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) load_slice((s + 1) & 1, base, (s + 1) * MK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf* cb = cs + (s & 1) * TN * LDW;
#pragma unroll
      for (int kk = 0; kk < MK; kk += 16) {
        unsigned a[4];
        ldmatrix_x4(a, qs + (mt * 16 + (lane & 15)) * LDQ + s * MK + kk + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          unsigned b[4];  // rows of tiles nb+j, nb+j+1; k halves kk, kk+8
          ldmatrix_x4(b, cb + ((nb + j) * 8 + (lane & 7) + 8 * (lane >> 4)) * LDW + kk +
                             8 * ((lane >> 3) & 1));
          mma_bf16_16x8x16(acc[j], a, b[0], b[1]);
          mma_bf16_16x8x16(acc[j + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // this slice's buffer is refilled two steps on
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (nb + j) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), c = n + (e & 1);
        const int row = base + c;
        sc[r * LDSC + c] = row < n_valid && row < row_end ? acc[j][e] : -INFINITY;
      }
    }
    __syncthreads();
    for (int qi = warp * (MQ / 8); qi < (warp + 1) * (MQ / 8); ++qi)
      merge_subtile(sc + qi * LDSC, base, lv + qi * JMAX, li + qi * JMAX, J, lane);
    // the next sub-tile rewrites sc only after its first slice barrier
  }
  __syncthreads();
  write_lists(lv, li, MQ, q0, Q, blk, gridDim.y, J, out_v, out_i);
}

// ---- CUDA-core path ------------------------------------------------------------------

constexpr int TQ = 64;  // queries per block
constexpr int KT = 32;  // K chunk staged in shared memory
constexpr int LDQT = TQ + 4;  // chunk rows: float4-aligned, conflict-free column stores
constexpr int LDCT = TN + 4;

size_t smem_bytes() {
  return sizeof(float) * ((size_t)KT * LDQT + (size_t)KT * LDCT + (size_t)TQ * (TN + 1) +
                          (size_t)TQ * JMAX) +
         sizeof(int) * (size_t)TQ * JMAX;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// The K chunk a thread stages: VEC (fp32, H % 4 == 0, 16-byte aligned) as float4 of
// 4 consecutive k, else as single elements; consecutive threads read consecutive k of
// one row, so global reads coalesce. Held in registers while the previous chunk is
// scored, then stored transposed.
template <typename T, bool VEC>
struct Chunk {
  static constexpr int W = VEC ? 4 : 1;                // elements per load
  static constexpr int NC = KT * TN / (W * NT);        // corpus loads per thread
  static constexpr int NQ = KT * TQ / (W * NT);        // query loads per thread
  float cv[NC][W], qv[NQ][W];

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
  __device__ __forceinline__ void fetch(const T* corpus, const T* q, int base, int row_end,
                                        int q0, int Q, int k0, int H) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / (KT / W), k = (idx % (KT / W)) * W;
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
block_topj_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                  float* __restrict__ out_v, int* __restrict__ out_i, int Q, int N, int H,
                  int n_valid, int block, int J) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);  // [KT][LDQT]: a K chunk of the queries
  float* ct = qt + KT * LDQT;                  // [KT][LDCT]: a K chunk of the sub-tile rows
  float* sc = ct + KT * LDCT;                  // [TQ][TN+1]
  float* lv = sc + TQ * (TN + 1);              // [TQ][JMAX]
  int* li = reinterpret_cast<int*>(lv + TQ * JMAX);

  const int q0 = blockIdx.x * TQ;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // each thread scores queries 8*warp .. +7 against rows 4*lane .. +3 of the sub-tile:
  // one float4 of rows and two of queries per 32 FFMA
  for (int idx = tid; idx < TQ * JMAX; idx += NT) {
    lv[idx] = -INFINITY;
    li[idx] = INT_MAX;
  }

  const int row_end = min(N, (blk + 1) * block);
  const int nk = (H + KT - 1) / KT;
  Chunk<T, VEC> next;
  next.fetch(corpus, q, blk * block, row_end, q0, Q, 0, H);
  for (int base = blk * block; base < row_end; base += TN) {
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
      else if (base + TN < row_end)
        next.fetch(corpus, q, base + TN, row_end, q0, Q, 0, H);
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
      for (int j = 0; j < 4; ++j) {
        const int row = base + 4 * lane + j;
        sc[(8 * warp + i) * (TN + 1) + 4 * lane + j] =
            row < n_valid && row < row_end ? acc[i][j] : -INFINITY;
      }
    __syncthreads();
    for (int qi = warp * (TQ / 8); qi < (warp + 1) * (TQ / 8); ++qi)
      merge_subtile(sc + qi * (TN + 1), base, lv + qi * JMAX, li + qi * JMAX, J, lane);
  }
  __syncthreads();
  write_lists(lv, li, TQ, q0, Q, blk, gridDim.y, J, out_v, out_i);
}

template <typename T, bool VEC>
int launch(const void* q, const void* corpus, void* out_v, void* out_i, int Q, int N, int H,
           int n_valid, int block, int J, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(block_topj_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // query tiles fastest: the tiles that read one corpus block run side by side (L2 reuse)
  dim3 grid((Q + TQ - 1) / TQ, (N + block - 1) / block);
  block_topj_kernel<T, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(corpus), static_cast<float*>(out_v),
      static_cast<int*>(out_i), Q, N, H, n_valid, block, J);
  return (int)cudaGetLastError();
}

// the tensor-core path, or -1 when the shape or alignment does not fit it
int try_mma(const void* q, const void* corpus, void* out_v, void* out_i, int Q, int N, int H,
            int n_valid, int block, int J, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
  const size_t smem = mma_smem_bytes(H);
  if (H % MK != 0 || (ptrs & 15) != 0 || smem > SMEM_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(block_topj_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + MQ - 1) / MQ, (N + block - 1) / block);
  block_topj_mma_kernel<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(corpus),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, N, H, n_valid, block, J);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int drt_block_topj(const void* q, const void* corpus, void* out_v, void* out_i,
                              int Q, int N, int H, int n_valid, int block, int J, int is_bf16,
                              void* stream) {
  if (J < 1 || J > JMAX || block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus);
    if (H % 4 == 0 && (ptrs & 15) == 0)
      return launch<float, true>(q, corpus, out_v, out_i, Q, N, H, n_valid, block, J, st);
    return launch<float, false>(q, corpus, out_v, out_i, Q, N, H, n_valid, block, J, st);
  }
  const int code = try_mma(q, corpus, out_v, out_i, Q, N, H, n_valid, block, J, st);
  if (code >= 0) return code;
  return launch<__nv_bfloat16, false>(q, corpus, out_v, out_i, Q, N, H, n_valid, block, J, st);
}
