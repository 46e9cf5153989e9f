// Multi-head attention forward and backward at any head dim, bf16 and f32,
// read straight from the packed qkv projection: the form of K2 and K3 for the
// head dims and addresses that their instantiated kernels (attention.cu,
// attention_bwd.cu, attention_bwd_cluster.cu, attention_f32.cu: a head dim
// that is a multiple of 8 up to 128, qkv at a 16-byte aligned address) do
// not take: a head dim that is not a multiple of 8 (ViT-B/16's width on 64
// heads of 12), one above 128 (3 heads of 256), or a qkv view that starts
// off a 16-byte boundary.
//
// Replaces the TPU kernels chess_vision_tpu/ops/attention.py
// _kernel_attention (_attn_kernel) and _kernel_attention_bwd
// (_attn_bwd_kernel), which block qkv by whole heads and fix no head dim. For
// every (image, head), Q, K and V are the column ranges [h*Dh, (h+1)*Dh) +
// {0, D, 2D} of qkv (B, N, 3*D), D = H*Dh; the output lands in out (B, N, D)
// and the gradient in dqkv (B, N, 3*D) at the same columns.
//
// Arithmetic (f32 on the CUDA cores, FFMA; bf16 operands widened exactly):
//  scores   s = q k over the head dim in slices of 16 columns, each slice in
//           column order, so a score has the same bits in every kernel here,
//           whichever operand is read as rows.
//  forward  (the JAX kernel's) the row max m over all keys; p = exp(s - m)
//           (bf16: exp2f(fmaf(s, scale log2 e, -m scale log2 e)), the
//           instantiated kernels' form; f32: expf(fl(s scale) - m)); bf16
//           rounds p, and the row sum adds the rounded p as the JAX kernel's
//           ones column of V does; P V summed in f32, divided by the row sum
//           floored at 1e-30, one rounding of the output.
//  backward (reference_attention_bwd's rounding points) pn = p / l,
//           r = rowsum(dP * pn) with dP = g v^T, dS = pn * (dP - r) * scale
//           rounded to the input dtype, pn rounded as dV's operand; dQ = dS K,
//           dK = dS^T Q, dV = pn^T g summed in f32, each output rounded once.
//
// Design: a simple kernel that is right, built for any head dim and any
// token count. 256 threads a CTA, 16 x 16, each holding a 4 x 4 block of a
// 64 x 64 score tile (rows 4 ty + i, columns tx + 16 j); a score tile is
// summed over the head dim in slices of 16 columns copied element by element
// (no alignment asked of any column), transposed into shared memory as f32,
// zero past the head dim and past the last row. A CTA keeps one chunk of at
// most kMaxCols output columns (any_cols: 16, 32, 64 or 128, the smallest
// that holds the head dim, else 128 in ceil(Dh / 128) chunks); the grid's y
// runs over (head, chunk), so each chunk's CTA computes the score products
// over the whole head dim again: the extra work is (chunks - 1) times the
// score products, the price of keeping every accumulator in registers.
//  any_fwd_kernel    per (64 query rows, head and chunk, image): a pass over
//           the keys for the row max, a second for p, the row sums and
//           P V += p x (the chunk's columns of V), 64 keys a step.
//  any_stats_kernel  per (64 query rows, head, image): m (as a shift), l and
//           r of every row into an f32 scratch (B, H, 3, N): three passes
//           over the keys (max; sum; dP and r), as the JAX kernel's exact
//           order of max, exp-sum and normalization asks.
//  any_dq_kernel     per (64 query rows, head and chunk, image): S and dP of
//           each 64-key step, dS, dQ += dS (the chunk's columns of K).
//  any_dkv_kernel    per (64 keys, head and chunk, image): S^T and dP^T of
//           each 64-row step of queries against the scratch's statistics,
//           dV += pn^T g and dK += dS^T Q over the chunk's columns.
// No atomics, no order that depends on timing: every backward gives the same
// bits twice. The backward is three launches in one call of the entry.
// Timings, bounds and the shapes run on the card are in PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;         // query rows or keys of a tile
constexpr int kSlice = 16;        // head-dim columns a score product takes a step
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdT = kTile + 4;   // floats of a transposed row (16-byte aligned)
constexpr int kMaxCols = 128;     // output columns a CTA: one chunk of the head dim

// The output columns a CTA keeps for head dim dh: the smallest of 16, 32, 64
// and 128 that holds it, else 128 (the head dim in ceil(dh / 128) chunks).
__host__ __device__ constexpr int any_cols(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : kMaxCols;
}

// Dynamic shared memory of each kernel, in bytes, for chunks of cols
// columns: the two score slices, then the forward's and dQ's P tile and
// column tile, dK/dV's two of each; at 128 columns 58,880 and 109,056.
constexpr int kSliceFloats = 2 * kSlice * kLdT;
__host__ __device__ constexpr int any_smem_bytes(int cols, int tiles) {
  return 4 * (kSliceFloats + tiles * (kTile * kLdT + kTile * cols));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a product's operand as the JAX kernel rounds it: to bf16 for bf16 inputs
template <typename T>
__device__ __forceinline__ float operand(float x) {
  return widen(narrow<T>(x));
}

// The softmax's scores, shift and exponentials: in f32 the scaled score
// fl(s scale) and expf against the row max of those; in bf16 the raw score
// and exp2f(fmaf(s, scale log2 e, -shift)), the shift m scale log2 e.
template <typename T>
struct Softmax {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  float scale, scale_log2;
  __device__ __forceinline__ float score(float s) const {
    return kF32 ? __fmul_rn(s, scale) : s;
  }
  __device__ __forceinline__ float shift(float m) const { return kF32 ? m : m * scale_log2; }
  __device__ __forceinline__ float p(float s, float sh) const {
    return kF32 ? expf(__fsub_rn(__fmul_rn(s, scale), sh)) : exp2f(fmaf(s, scale_log2, -sh));
  }
  // dS = pn * (dP - r) * scale, in that order, rounded as the JAX kernel
  __device__ __forceinline__ float ds(float pn, float dp, float r) const {
    return operand<T>(__fmul_rn(__fmul_rn(pn, __fsub_rn(dp, r)), scale));
  }
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] = sum over d < dh of a[(4 ty + i) lda + d] b[(tx + 16 j) ldb + d]:
// rows past a_rows and b_rows, and columns past dh, read as zeros. Slices of
// 16 columns go through sa and sb transposed, each after a barrier of the
// block: shared memory that the caller read before the call is free to
// write once it returns.
template <typename T>
__device__ void score_tile(const T* a, long long lda, int a_rows, const T* b, long long ldb,
                           int b_rows, int dh, float* sa, float* sb, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int d0 = 0; d0 < dh; d0 += kSlice) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice;
      const int c = e % kSlice;
      const bool col = d0 + c < dh;
      sa[c * kLdT + r] = col && r < a_rows ? widen(a[r * lda + d0 + c]) : 0.f;
      sb[c * kLdT + r] = col && r < b_rows ? widen(b[r * ldb + d0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlice; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(sa + k * kLdT + 4 * ty);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float ys[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ys[j] = sb[k * kLdT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
      }
    }
  }
}

// x[t][c] = the tile's row t, column c0 + c of src (rows of ld elements),
// zero past `rows` rows and `cols` columns: 64 rows of 16 W columns.
template <typename T, int W>
__device__ __forceinline__ void load_cols(float* x, const T* src, long long ld, int rows,
                                          int c0, int cols) {
  constexpr int kCols = 16 * W;
  for (int e = threadIdx.x; e < kTile * kCols; e += kThreads) {
    const int r = e / kCols;
    const int c = e % kCols;
    x[e] = r < rows && c < cols ? widen(src[r * ld + c0 + c]) : 0.f;
  }
}

// p[t][4 ty + i] = v[i]: a thread's four rows of the tile's column t, one
// 16-byte store (the rows of a quarter warp fall in distinct banks)
__device__ __forceinline__ void put4(float* p, int t, const float (&v)[4]) {
  const int ty = threadIdx.x / 16;
  *reinterpret_cast<float4*>(p + t * kLdT + 4 * ty) = make_float4(v[0], v[1], v[2], v[3]);
}

// acc[i][u] += sum over t < 64 of p[t][4 ty + i] x[t][tx + 16 u], t in order
template <int W>
__device__ __forceinline__ void tile_product(const float* p, const float* x, float (&acc)[4][W]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    const float4 pv = *reinterpret_cast<const float4*>(p + t * kLdT + 4 * ty);
    const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const float xv = x[t * 16 * W + tx + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][u] = fmaf(ps[i], xv, acc[i][u]);
    }
  }
}

// dst's rows 4 ty + i < rows, columns tx + 16 u < cols: acc rounded once
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* dst, long long ld, int rows, int cols,
                                           const float (&acc)[4][W]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int c = tx + 16 * u;
      if (c < cols) dst[r * ld + c] = narrow<T>(acc[i][u]);
    }
  }
}

// What every kernel of a call shares.
struct Call {
  const void* qkv;
  const void* grad;
  void* out;      // the forward's output or the backward's dqkv
  float* stats;   // (B, H, 3, N): shift, row sum, r
  int n, heads, dh, chunks;
  float scale, scale_log2;
};

// A CTA's place: its image, head and chunk, and the head's pointers.
template <typename T>
struct Place {
  int b, h, c0, cols;
  long long rs;  // qkv's row stride, 3 D
  int d_model;
  const T* q;
  const T* k;
  const T* v;
  __device__ Place(const Call& a, int y) {
    b = blockIdx.z;
    h = y / a.chunks;
    const int chunk = y % a.chunks;
    const int w = any_cols(a.dh);
    c0 = chunk * w;
    cols = min(w, a.dh - c0);
    d_model = a.heads * a.dh;
    rs = 3LL * d_model;
    q = static_cast<const T*>(a.qkv) + (long long)b * a.n * rs + (long long)h * a.dh;
    k = q + d_model;
    v = q + 2 * d_model;
  }
};

// The row max of rows [row0, row0 + rows) over every key, as the softmax's
// shift; the same bits in the forward and in the statistics pass.
template <typename T>
__device__ void row_shift(const Call& a, const Place<T>& pl, const Softmax<T>& sm, int row0,
                          int rows, float* sa, float* sb, float (&sh)[4]) {
  const int tx = threadIdx.x % 16;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < a.n; k0 += kTile) {
    const int keys = min(kTile, a.n - k0);
    float s[4][4];
    score_tile(pl.q + row0 * pl.rs, pl.rs, rows, pl.k + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j < keys) m[i] = fmaxf(m[i], sm.score(s[i][j]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sh[i] = sm.shift(row_max(m[i]));
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) any_fwd_kernel(Call a) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kSlice * kLdT;
  float* sp = sb + kSlice * kLdT;
  float* sx = sp + kTile * kLdT;
  const int tx = threadIdx.x % 16;
  const Softmax<T> sm{a.scale, a.scale_log2};
  const Place<T> pl(a, blockIdx.y);
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.n - row0);

  float sh[4];
  row_shift(a, pl, sm, row0, rows, sa, sb, sh);
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float o[4][W] = {};
  for (int k0 = 0; k0 < a.n; k0 += kTile) {
    const int keys = min(kTile, a.n - k0);
    float s[4][4];
    score_tile(pl.q + row0 * pl.rs, pl.rs, rows, pl.k + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = tx + 16 * j < keys ? operand<T>(sm.p(s[i][j], sh[i])) : 0.f;
        l[i] += p[i];
      }
      put4(sp, tx + 16 * j, p);
    }
    load_cols<T, W>(sx, pl.v + k0 * pl.rs, pl.rs, keys, pl.c0, pl.cols);
    __syncthreads();
    tile_product<W>(sp, sx, o);
    // the next score_tile's first barrier frees sp and sx again
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = fmaxf(row_sum(l[i]), 1e-30f);
#pragma unroll
    for (int u = 0; u < W; ++u) o[i][u] = __fdiv_rn(o[i][u], sum);
  }
  T* out = static_cast<T*>(a.out) + ((long long)pl.b * a.n + row0) * pl.d_model +
           (long long)pl.h * a.dh + pl.c0;
  store_rows<T, W>(out, pl.d_model, rows, pl.cols, o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) any_stats_kernel(Call a) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kSlice * kLdT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const Softmax<T> sm{a.scale, a.scale_log2};
  const Place<T> pl(a, blockIdx.y * a.chunks);
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.n - row0);
  const T* g = static_cast<const T*>(a.grad) + ((long long)pl.b * a.n + row0) * pl.d_model +
               (long long)pl.h * a.dh;
  const T* q = pl.q + row0 * pl.rs;

  float sh[4];
  row_shift(a, pl, sm, row0, rows, sa, sb, sh);
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < a.n; k0 += kTile) {
    const int keys = min(kTile, a.n - k0);
    float s[4][4];
    score_tile(q, pl.rs, rows, pl.k + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j < keys) l[i] += sm.p(s[i][j], sh[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = row_sum(l[i]);
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < a.n; k0 += kTile) {
    const int keys = min(kTile, a.n - k0);
    float s[4][4], dp[4][4];
    score_tile(q, pl.rs, rows, pl.k + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, s);
    score_tile(g, pl.d_model, rows, pl.v + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j < keys) {
          const float pn = __fdiv_rn(sm.p(s[i][j], sh[i]), l[i]);
          r[i] += __fmul_rn(dp[i][j], pn);
        }
      }
    }
  }
  float* st = a.stats + ((long long)pl.b * a.heads + pl.h) * 3 * a.n + row0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ri = row_sum(r[i]);
    const int row = 4 * ty + i;
    if (tx == 0 && row < rows) {
      st[row] = sh[i];
      st[a.n + row] = l[i];
      st[2 * a.n + row] = ri;
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) any_dq_kernel(Call a) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kSlice * kLdT;
  float* sp = sb + kSlice * kLdT;
  float* sx = sp + kTile * kLdT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const Softmax<T> sm{a.scale, a.scale_log2};
  const Place<T> pl(a, blockIdx.y);
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.n - row0);
  const T* g = static_cast<const T*>(a.grad) + ((long long)pl.b * a.n + row0) * pl.d_model +
               (long long)pl.h * a.dh;
  const T* q = pl.q + row0 * pl.rs;
  const float* st = a.stats + ((long long)pl.b * a.heads + pl.h) * 3 * a.n + row0;
  float sh[4], l[4], r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = min(4 * ty + i, rows - 1);  // a row past the last: any real row's
    sh[i] = st[row];
    l[i] = st[a.n + row];
    r[i] = st[2 * a.n + row];
  }

  float dq[4][W] = {};
  for (int k0 = 0; k0 < a.n; k0 += kTile) {
    const int keys = min(kTile, a.n - k0);
    float s[4][4], dp[4][4];
    score_tile(q, pl.rs, rows, pl.k + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, s);
    score_tile(g, pl.d_model, rows, pl.v + k0 * pl.rs, pl.rs, keys, a.dh, sa, sb, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pn = __fdiv_rn(sm.p(s[i][j], sh[i]), l[i]);
        ds[i] = tx + 16 * j < keys ? sm.ds(pn, dp[i][j], r[i]) : 0.f;
      }
      put4(sp, tx + 16 * j, ds);
    }
    load_cols<T, W>(sx, pl.k + k0 * pl.rs, pl.rs, keys, pl.c0, pl.cols);
    __syncthreads();
    tile_product<W>(sp, sx, dq);
  }
  T* out = static_cast<T*>(a.out) + ((long long)pl.b * a.n + row0) * pl.rs +
           (long long)pl.h * a.dh + pl.c0;
  store_rows<T, W>(out, pl.rs, rows, pl.cols, dq);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) any_dkv_kernel(Call a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCols = 16 * W;
  float* sa = smem;
  float* sb = sa + kSlice * kLdT;
  float* spn = sb + kSlice * kLdT;  // pn^T rounded, then dS^T: [query][key]
  float* sds = spn + kTile * kLdT;
  float* sg = sds + kTile * kLdT;   // the query step's g and Q columns
  float* sq = sg + kTile * kCols;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const Softmax<T> sm{a.scale, a.scale_log2};
  const Place<T> pl(a, blockIdx.y);
  const int key0 = blockIdx.x * kTile;
  const int keys = min(kTile, a.n - key0);
  const T* grad = static_cast<const T*>(a.grad) + (long long)pl.b * a.n * pl.d_model +
                  (long long)pl.h * a.dh;
  const float* st = a.stats + ((long long)pl.b * a.heads + pl.h) * 3 * a.n;

  float dk[4][W] = {}, dv[4][W] = {};
  for (int q0 = 0; q0 < a.n; q0 += kTile) {
    const int rows = min(kTile, a.n - q0);
    float s[4][4], dp[4][4];
    score_tile(pl.k + key0 * pl.rs, pl.rs, keys, pl.q + q0 * pl.rs, pl.rs, rows, a.dh, sa, sb, s);
    score_tile(pl.v + key0 * pl.rs, pl.rs, keys, grad + q0 * pl.d_model, pl.d_model, rows, a.dh,
               sa, sb, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tx + 16 * j;   // the query of column j
      const bool real = t < rows;
      const int row = q0 + (real ? t : 0);
      const float sh = st[row], l = st[a.n + row], r = st[2 * a.n + row];
      float pn[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = real && 4 * ty + i < keys;
        const float p = __fdiv_rn(sm.p(s[i][j], sh), l);
        pn[i] = ok ? operand<T>(p) : 0.f;
        ds[i] = ok ? sm.ds(p, dp[i][j], r) : 0.f;
      }
      put4(spn, t, pn);
      put4(sds, t, ds);
    }
    load_cols<T, W>(sg, grad + q0 * pl.d_model, pl.d_model, rows, pl.c0, pl.cols);
    load_cols<T, W>(sq, pl.q + q0 * pl.rs, pl.rs, rows, pl.c0, pl.cols);
    __syncthreads();
    tile_product<W>(spn, sg, dv);
    tile_product<W>(sds, sq, dk);
  }
  T* out = static_cast<T*>(a.out) + ((long long)pl.b * a.n + key0) * pl.rs +
           (long long)pl.h * a.dh + pl.c0;
  store_rows<T, W>(out + pl.d_model, pl.rs, keys, pl.cols, dk);
  store_rows<T, W>(out + 2 * pl.d_model, pl.rs, keys, pl.cols, dv);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int W>
cudaError_t launch_fwd(const Call& a, int batch, cudaStream_t stream) {
  const int bytes = any_smem_bytes(16 * W, 1);
  cudaError_t err = allow_smem(any_fwd_kernel<T, W>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads * a.chunks, batch);
  any_fwd_kernel<T, W><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_bwd(const Call& a, int batch, cudaStream_t stream) {
  const int tiles = (a.n + kTile - 1) / kTile;
  any_stats_kernel<T><<<dim3(tiles, a.heads, batch), kThreads, 4 * kSliceFloats, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int dq_bytes = any_smem_bytes(16 * W, 1);
  const int dkv_bytes = any_smem_bytes(16 * W, 2);
  if ((err = allow_smem(any_dq_kernel<T, W>, dq_bytes)) != cudaSuccess) return err;
  if ((err = allow_smem(any_dkv_kernel<T, W>, dkv_bytes)) != cudaSuccess) return err;
  const dim3 grid(tiles, a.heads * a.chunks, batch);
  any_dq_kernel<T, W><<<grid, kThreads, dq_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  any_dkv_kernel<T, W><<<grid, kThreads, dkv_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool backward, const Call& a, int batch, cudaStream_t s) {
  switch (any_cols(a.dh)) {
    case 16: return backward ? launch_bwd<T, 1>(a, batch, s) : launch_fwd<T, 1>(a, batch, s);
    case 32: return backward ? launch_bwd<T, 2>(a, batch, s) : launch_fwd<T, 2>(a, batch, s);
    case 64: return backward ? launch_bwd<T, 4>(a, batch, s) : launch_fwd<T, 4>(a, batch, s);
    default: return backward ? launch_bwd<T, 8>(a, batch, s) : launch_fwd<T, 8>(a, batch, s);
  }
}

// Checks a call's shape and fills what its kernels share; false for a shape
// the grid cannot hold.
bool make_call(Call& a, const void* qkv, const void* grad, void* out, void* stats, int batch,
               int n, int heads, int head_dim, float scale) {
  if (batch < 1 || n < 1 || heads < 1 || head_dim < 1 || batch > 65535) return false;
  const int cols = any_cols(head_dim);
  const long long chunks = (head_dim + cols - 1) / cols;
  if (heads * chunks > 65535) return false;
  a = Call{qkv, grad, out, static_cast<float*>(stats), n, heads, head_dim, (int)chunks,
           scale, scale * 1.4426950408889634f};  // log2(e)
  return true;
}

cudaError_t run(bool backward, const Call& a, int batch, int f32, cudaStream_t s) {
  return f32 ? dispatch<float>(backward, a, batch, s) : dispatch<__nv_bfloat16>(backward, a, batch, s);
}

}  // namespace

// qkv: (batch, n, 3 * heads * head_dim), bf16 (f32 = 0) or f32 (f32 = 1),
// contiguous; any head_dim >= 1, any alignment of the dtype. out: the same
// dtype, (batch, n, heads * head_dim). scale: the softmax temperature
// (1 / sqrt(head_dim)). Returns the launch's cudaError_t.
extern "C" int cvt_attention_fwd_any(const void* qkv, void* out, int batch, int n, int heads,
                                     int head_dim, int f32, float scale, void* stream) {
  Call a;
  if (!make_call(a, qkv, nullptr, out, nullptr, batch, n, heads, head_dim, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run(false, a, batch, f32, static_cast<cudaStream_t>(stream));
}

// qkv as for the forward; grad: the output's cotangent, (batch, n, heads *
// head_dim), contiguous; dqkv: (batch, n, 3 * heads * head_dim); stats: an f32
// scratch of batch * heads * 3 * n floats. Three launches on the stream.
extern "C" int cvt_attention_bwd_any(const void* qkv, const void* grad, void* dqkv, void* stats,
                                     int batch, int n, int heads, int head_dim, int f32,
                                     float scale, void* stream) {
  Call a;
  if (stats == nullptr ||
      !make_call(a, qkv, grad, dqkv, stats, batch, n, heads, head_dim, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run(true, a, batch, f32, static_cast<cudaStream_t>(stream));
}
