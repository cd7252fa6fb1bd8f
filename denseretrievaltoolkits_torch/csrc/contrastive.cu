// K3 and K4: the fused in-batch contrastive loss (softmax CE over q.p^T with stride
// targets) and its gradient, without the [Q, P] score matrix.
//
// Replaces the TPU kernels of denseretrievaltoolkits_tpu/ops/contrastive.py:
// - K3, `_fwd_kernel` (contrastive.py:39, launched by `_fused_fwd`, :90): per query row
//   the log-sum-exp of its scores against every passage and the score of its target
//   passage, column r * stride. The loss, sum(lse - tgt) / n_q, is a torch reduction
//   outside the kernel, as the reference takes it outside its pallas_call (:112).
// - K4, `_bwd_dq_kernel` and `_bwd_dp_kernel` (contrastive.py:121, 150, launched at
//   :186, :200): with g = (exp(s - lse) - onehot) / n_q recomputed tile by tile,
//   dq = g.p and dp = g^T.q, each times the upstream scalar.
//
// fp32 in, fp32 out, products in true fp32 on the CUDA cores (FFMA, no TF32): the
// reference's tolerances (1e-5 on the loss and the grads) leave no room for TF32. At
// the grad-cache scale (Q=4096, P=32768, H=768) each pass is 2QPH or 4QPH flops and
// reads its operands from L2, so all three bodies are bound by FFMA issue.
//
// What the design keeps out of device memory: the [Q, P] scores, probabilities and g.
// On the TPU the passage-tile axis is a sequential grid dimension carrying m/l/t in VMEM
// scratch; here blocks run in no order, so a loop inside the block walks the other side:
// - K3: a block owns 32 query rows, resident (transposed) in shared memory, and walks
//   all passages in tiles of 256, staging 32-deep k-slices (prefetched into registers
//   while the previous slice is scored). Each thread scores 8 rows x 4 columns and keeps
//   its own running max / sum of exponentials / target score per row in registers; the
//   lanes and the two warps that share a row merge once, at the end. Columns >= P never
//   enter the sums (contrastive.py:50-51 masks them).
// - K4: one body, two instances. dq: a block owns 32 query rows and walks the passages;
//   dp: a block owns 32 passage rows and walks the queries. Per walked tile of 256 rows
//   it recomputes the [32, 256] score tile, forms g in shared memory, and adds g.X (X the
//   walked rows, in 256-column chunks of H) into a [32, H] fp32 accumulator in shared
//   memory. Each output row belongs to one block, so there are no atomics and results
//   repeat bit for bit. Ragged Q and P are masked here: rows past the end load as zeros
//   and take g = 0 (the TPU's padding with lse = 1e30, contrastive.py:248-252, is not
//   carried over).
// Tensor cores (3xTF32 or wgmma) and TMA are for a later change.
#include <cstdint>

#include "common.cuh"

using namespace drt;

namespace {

constexpr int NT = 256;          // threads per block: 8 warps
constexpr int OWN = 32;          // rows a block owns: 4 warp rows x 8
constexpr int WALK = 256;        // rows of a walked tile (and columns of a product chunk)
constexpr int KT = 32;           // depth of a staged slice
constexpr int LDA = OWN + 4;     // [k][row] slices of the owned side; float4-aligned rows
constexpr int LDB = WALK + 4;    // [k][col] slices of the walked side
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[i][j] += sum_k A[k][8 wr + i] * B[k][128 wc + 4 lane + j], k < KT, for A with rows
// of LDA floats and B with rows of LDB floats in shared memory: a warp reads its 8 A
// values as two broadcast float4 and its lanes one float4 of B each, per 32 FFMA.
__device__ __forceinline__ void ffma_tile(const float* __restrict__ A, const float* __restrict__ B,
                                          float (&acc)[8][4], int wr, int wc, int lane) {
  const float* a = A + 8 * wr;
  const float* b = B + 128 * wc + 4 * lane;
#pragma unroll 8
  for (int k = 0; k < KT; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * LDA + 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * LDB);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
}

// One 32 x 32 slice of the owned rows (rows row0.., columns col0.. of a [*, H] matrix),
// one float4 per thread, stored transposed as [k][row] with rows of LDA floats. Rows
// past the end and columns >= H load as zeros.
struct OwnSlice {
  float4 v;
  __device__ __forceinline__ void fetch(const float* src, int H, int row0, int nrows, int col0) {
    const int r = threadIdx.x >> 3, c = col0 + (threadIdx.x & 7) * 4;
    v = r < nrows && c < H ? ld4(src + (size_t)(row0 + r) * H + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* dst) const {
    const int r = threadIdx.x >> 3, k = (threadIdx.x & 7) * 4;
    dst[(k + 0) * LDA + r] = v.x;
    dst[(k + 1) * LDA + r] = v.y;
    dst[(k + 2) * LDA + r] = v.z;
    dst[(k + 3) * LDA + r] = v.w;
  }
};

// One slice of the walked rows, eight float4 per thread (consecutive threads read
// consecutive 16 bytes of a row), held in registers until stored:
// - TRANS: 256 rows x 32 columns, stored [k][row] (the score product's B operand);
// - !TRANS: 32 rows x 256 columns, stored as they are, [row][col] (the g.X product's B).
template <bool TRANS>
struct WalkSlice {
  float4 v[8];
  __device__ __forceinline__ static void coords(int i, int& r, int& c) {
    const int idx = threadIdx.x + i * NT;
    if (TRANS) { r = idx >> 3; c = (idx & 7) * 4; }
    else { r = idx >> 6; c = (idx & 63) * 4; }
  }
  __device__ __forceinline__ void fetch(const float* src, int H, int row0, int nrows, int col0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int r, c;
      coords(i, r, c);
      v[i] = r < nrows && col0 + c < H ? ld4(src + (size_t)(row0 + r) * H + col0 + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int r, c;
      coords(i, r, c);
      if (TRANS) {
        dst[(c + 0) * LDB + r] = v[i].x;
        dst[(c + 1) * LDB + r] = v[i].y;
        dst[(c + 2) * LDB + r] = v[i].z;
        dst[(c + 3) * LDB + r] = v[i].w;
      } else {
        *reinterpret_cast<float4*>(dst + r * LDB + c) = v[i];
      }
    }
  }
};

// [OWN, 256] scores of the owned rows (own_s: the owned slices, resident, or a staging
// buffer refilled per slice when own_src is given) against walked rows c0.., into acc.
// On entry `next` holds the walked tile's first slice; on exit the next tile's first.
__device__ __forceinline__ void score_tile(const float* own_src, int n_own, int r0, float* own_s,
                                           const float* walk, int n_walk, int c0, int H,
                                           float* bT, WalkSlice<true>& next, float (&acc)[8][4],
                                           int wr, int wc, int lane) {
  const int nk = (H + KT - 1) / KT;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  OwnSlice a;
  if (own_src) a.fetch(own_src, H, r0, n_own - r0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();  // the previous readers of the staging buffers are done
    next.store(bT);
    if (own_src) a.store(own_s);
    __syncthreads();
    // prefetch the next slice (or the next tile's first) while this one is scored
    if (kc + 1 < nk) {
      next.fetch(walk, H, c0, n_walk - c0, (kc + 1) * KT);
      if (own_src) a.fetch(own_src, H, r0, n_own - r0, (kc + 1) * KT);
    } else if (c0 + WALK < n_walk) {
      next.fetch(walk, H, c0 + WALK, n_walk - c0 - WALK, 0);
    }
    ffma_tile(own_src ? own_s : own_s + kc * KT * LDA, bT, acc, wr, wc, lane);
  }
}

// ---- K3: per query row lse and target score --------------------------------------------

size_t fwd_smem_bytes(int H) {
  const int nk = (H + KT - 1) / KT;
  return sizeof(float) * ((size_t)nk * KT * LDA + (size_t)KT * LDB + (size_t)OWN * 3);
}

__global__ void __launch_bounds__(NT)
contrastive_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                       float* __restrict__ lse, float* __restrict__ tgt, int Q, int P, int H,
                       int stride) {
  extern __shared__ __align__(16) float smem[];
  const int nk = (H + KT - 1) / KT;
  float* qT = smem;                     // [nk * KT][LDA]: the block's query rows, resident
  float* bT = qT + nk * KT * LDA;       // [KT][LDB]: a passage slice
  float* part = bT + KT * LDB;          // [OWN][3]: warp column 1's (max, sum, target)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
  const int q0 = blockIdx.x * OWN;

  for (int kc = 0; kc < nk; ++kc) {  // published by score_tile's first barrier
    OwnSlice a;
    a.fetch(q, H, q0, Q - q0, kc * KT);
    a.store(qT + kc * KT * LDA);
  }
  // per thread and row: running max, sum of exp(s - max) and target score over its columns
  float m[8], l[8], t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { m[i] = -INFINITY; l[i] = 0.f; t[i] = 0.f; }

  WalkSlice<true> next;
  next.fetch(p, H, 0, P, 0);
  for (int c0 = 0; c0 < P; c0 += WALK) {
    float acc[8][4];
    score_tile(nullptr, Q, q0, qT, p, P, c0, H, bT, next, acc, wr, wc, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long target = (long long)(q0 + 8 * wr + i) * stride;
      float s[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 128 * wc + 4 * lane + j;
        s[j] = col < P ? acc[i][j] : -INFINITY;
        mx = fmaxf(mx, s[j]);
        if (col < P && col == target) t[i] += acc[i][j];
      }
      const float mn = fmaxf(m[i], mx);
      if (mn != -INFINITY) {  // some column of this thread is real
        float sum = l[i] * expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[j] - mn);
        l[i] = sum;
        m[i] = mn;
      }
    }
  }

  // merge the lanes of a warp, then the two warps (wc = 0, 1) that share a row
  float M[8], L[8], T[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    M[i] = warp_max(m[i]);
    L[i] = warp_sum(m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - M[i]));
    T[i] = warp_sum(t[i]);
    if (wc == 1 && lane == 0) {
      float* pr = part + (8 * wr + i) * 3;
      pr[0] = M[i]; pr[1] = L[i]; pr[2] = T[i];
    }
  }
  __syncthreads();
  if (wc == 0 && lane < 8) {
    const int i = lane, row = q0 + 8 * wr + i;
    float Mi = 0.f, Li = 0.f, Ti = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (u == i) { Mi = M[u]; Li = L[u]; Ti = T[u]; }
    const float* pr = part + (8 * wr + i) * 3;
    const float mx = fmaxf(Mi, pr[0]);
    const float sum = (Mi == -INFINITY ? 0.f : Li * expf(Mi - mx)) +
                      (pr[0] == -INFINITY ? 0.f : pr[1] * expf(pr[0] - mx));
    if (row < Q) {
      lse[row] = logf(sum) + mx;
      tgt[row] = Ti + pr[2];
    }
  }
}

// ---- K4: dq (DP = false) and dp (DP = true) ---------------------------------------------

size_t bwd_smem_bytes(int H) {
  return sizeof(float) * ((size_t)OWN * H + (size_t)KT * LDA + (size_t)KT * LDB +
                          (size_t)WALK * LDA);
}

// own: the side whose gradient this computes ([n_own, H]: q for dq, p for dp); walk: the
// other side. lse is indexed by query. out = gout * sum over walked rows of g . walk.
template <bool DP>
__global__ void __launch_bounds__(NT)
contrastive_bwd_kernel(const float* __restrict__ own, const float* __restrict__ walk,
                       const float* __restrict__ lse, const float* __restrict__ gout,
                       float* __restrict__ out, int n_own, int n_walk, int H, int stride,
                       int n_q) {
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                   // [OWN][H]: the block's gradient rows
  float* aT = acc_s + OWN * H;           // [KT][LDA]: an owned slice
  float* bT = aT + KT * LDA;             // [KT][LDB]: a walked slice (either layout)
  float* gT = bT + KT * LDB;             // [WALK][LDA]: g of the tile, transposed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
  const int r0 = blockIdx.x * OWN;

  for (int idx = threadIdx.x * 4; idx < OWN * H; idx += NT * 4)
    *reinterpret_cast<float4*>(acc_s + idx) = make_float4(0.f, 0.f, 0.f, 0.f);

  WalkSlice<true> next;
  next.fetch(walk, H, 0, n_walk, 0);
  for (int c0 = 0; c0 < n_walk; c0 += WALK) {
    float acc[8][4];
    score_tile(own, n_own, r0, aT, walk, n_walk, c0, H, bT, next, acc, wr, wc, lane);
    // g = (exp(s - lse) - onehot) / n_q, 0 outside the real rows; stored as gT[col][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 128 * wc + 4 * lane + j;
      float g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + 8 * wr + i;
        const int qi = DP ? c : r, pj = DP ? r : c;
        g[i] = 0.f;
        if (r < n_own && c < n_walk) {
          const float onehot = (long long)pj == (long long)qi * stride ? 1.f : 0.f;
          g[i] = (expf(acc[i][j] - __ldg(lse + qi)) - onehot) / (float)n_q;
        }
      }
      float* dst = gT + (128 * wc + 4 * lane + j) * LDA + 8 * wr;
      *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(g[4], g[5], g[6], g[7]);
    }
    // acc_s[:, h0:h0+256] += g . walk[c0:c0+256, h0:h0+256]
    for (int h0 = 0; h0 < H; h0 += WALK) {
      float acc2[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
      WalkSlice<false> x;
      x.fetch(walk, H, c0, n_walk - c0, h0);
      for (int kc = 0; kc < WALK / KT; ++kc) {
        __syncthreads();  // gT is written; the previous readers of bT are done
        x.store(bT);
        __syncthreads();
        if (kc + 1 < WALK / KT)
          x.fetch(walk, H, c0 + (kc + 1) * KT, n_walk - c0 - (kc + 1) * KT, h0);
        ffma_tile(gT + kc * KT * LDA, bT, acc2, wr, wc, lane);
      }
      const int h = h0 + 128 * wc + 4 * lane;
      if (h < H) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4* d = reinterpret_cast<float4*>(acc_s + (8 * wr + i) * H + h);
          float4 v = *d;
          v.x += acc2[i][0]; v.y += acc2[i][1]; v.z += acc2[i][2]; v.w += acc2[i][3];
          *d = v;
        }
      }
    }
  }
  __syncthreads();
  const float gs = *gout;  // the upstream scalar (contrastive.py:254)
  for (int idx = threadIdx.x * 4; idx < OWN * H; idx += NT * 4) {
    const int r = idx / H;
    if (r0 + r < n_own) {
      float4 v = *reinterpret_cast<const float4*>(acc_s + idx);
      v.x *= gs; v.y *= gs; v.z *= gs; v.w *= gs;
      *reinterpret_cast<float4*>(out + (size_t)r0 * H + idx) = v;
    }
  }
}

// What every entry checks: fp32 rows of H % 4 == 0 floats, 16-byte aligned, that fit.
bool takes(int n_rows_a, int n_rows_b, int H, const void* a, const void* b) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return n_rows_a > 0 && n_rows_b > 0 && H > 0 && H % 4 == 0 && (ptrs & 15) == 0 &&
         fwd_smem_bytes(H) <= SMEM_MAX && bwd_smem_bytes(H) <= SMEM_MAX;
}

template <bool DP>
int launch_bwd(const void* q, const void* p, const void* lse, const void* gout, void* out, int Q,
               int P, int H, int stride, cudaStream_t stream) {
  if (!takes(Q, P, H, q, p) || stride < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(contrastive_bwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_own = DP ? P : Q, n_walk = DP ? Q : P;
  contrastive_bwd_kernel<DP><<<(n_own + OWN - 1) / OWN, NT, smem, stream>>>(
      static_cast<const float*>(DP ? p : q), static_cast<const float*>(DP ? q : p),
      static_cast<const float*>(lse), static_cast<const float*>(gout), static_cast<float*>(out),
      n_own, n_walk, H, stride, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: lse[Q] and tgt[Q] of fp32 q [Q, H] against fp32 p [P, H]; target of row r is r * stride.
extern "C" int drt_contrastive_fwd(const void* q, const void* p, void* lse, void* tgt, int Q,
                                   int P, int H, int stride, void* stream) {
  if (!takes(Q, P, H, q, p) || stride < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(contrastive_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contrastive_fwd_kernel<<<(Q + OWN - 1) / OWN, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), static_cast<float*>(lse),
      static_cast<float*>(tgt), Q, P, H, stride);
  return (int)cudaGetLastError();
}

// K4: dq [Q, H] (dp [P, H]) = gout * g . p (g^T . q), g recomputed from q, p and lse [Q].
extern "C" int drt_contrastive_dq(const void* q, const void* p, const void* lse, const void* gout,
                                  void* dq, int Q, int P, int H, int stride, void* stream) {
  return launch_bwd<false>(q, p, lse, gout, dq, Q, P, H, stride,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int drt_contrastive_dp(const void* q, const void* p, const void* lse, const void* gout,
                                  void* dp, int Q, int P, int H, int stride, void* stream) {
  return launch_bwd<true>(q, p, lse, gout, dp, Q, P, H, stride,
                          static_cast<cudaStream_t>(stream));
}

// The widest H (a multiple of 4) the three bodies take: K3 keeps 32 query rows and K4 a
// [32, H] accumulator in shared memory.
extern "C" int drt_contrastive_max_h() {
  int H = 0;
  while (fwd_smem_bytes(H + 4) <= SMEM_MAX && bwd_smem_bytes(H + 4) <= SMEM_MAX) H += 4;
  return H;
}
