// The f32 attention backward's long route: K3 on f32 inputs above the
// cluster route's 512 tokens (attention_f32.cu, whose thread-block cluster
// holds at most 8 x 64 keys). ops/attention.bwd_route sends a call here
// when n > F32_MAX_TOKENS (ViT-B/16 at 384 px has 577 tokens); no
// configuration of the repo has such n.
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention_bwd (_attn_bwd_kernel) for f32 inputs at long token
// counts. Arithmetic: reference_attention_bwd's rounding points in f32 on
// the CUDA cores (FFMA, accurate expf, no TF32): s = (q k) * scale,
// pn = exp(s - m) / l, dV = pn^T g, dP = g v^T, r = rowsum(dP * pn),
// dS = pn * (dP - r) * scale, dQ = dS K, dK = dS^T Q, each output written
// once; m, l and r come from one online pass (r as rowsum(dP * p) / l).
//
// Design (the first f32 backward, kept for this route): both token axes
// tiled by 64, two kernels through an f32 (B, H, 3, N) statistics scratch:
//  attention_bwd_dq_f32_kernel  one block per 64 query rows: pass 1 the
//           online statistics (m, l, r) into the scratch, pass 2
//           dQ = dS K over the key tiles.
//  attention_bwd_dkv_f32_kernel  one block per 64 keys: walks the query
//           tiles with their statistics, dV = pn^T g and dK = dS^T Q.
// 9 products on 64-padded tiles where the function needs 5; both kernels
// deterministic (no atomics). Bound: operations (5 products of 2 n^2 Dh
// FLOP an (image, head) at 67 TFLOP/s). Timings in PERF.md section 6.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // query rows or keys a block, keys or queries a tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kRowPad = 4;     // row-major tiles: rows 4 apart fall 16 banks apart
constexpr int kTPad = 1;       // transposed tiles: column c of row d at d*65 + c

template <int Dh>
struct Layout {
  static constexpr int kLd = Dh + kRowPad;       // a row-major (row, Dh) tile
  static constexpr int kLdT = kTile + kTPad;     // a transposed (Dh, kTile) tile
  static constexpr int kLdP = kTile + kRowPad;   // a (kTile, kTile) tile
  static constexpr int kRowTile = kTile * kLd;
  static constexpr int kTTile = Dh * kLdT;
  static constexpr int kPTile = kTile * kLdP;
};

// rows [row0, row0 + 64) x Dh columns of `src` (row stride `stride`), times
// `mul`, into a row-major tile; rows at or past n are zero
template <int Dh>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride,
                                           int row0, int n, float mul) {
  constexpr int kQuads = Dh / 4;
  for (int idx = threadIdx.x; idx < kTile * kQuads; idx += kThreads) {
    const int r = idx / kQuads;
    const int c = (idx % kQuads) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    float* at = dst + r * Layout<Dh>::kLd + c;
    at[0] = v.x * mul;
    at[1] = v.y * mul;
    at[2] = v.z * mul;
    at[3] = v.w * mul;
  }
}

// the same rows transposed: element (row r, column d) at dst[d * 65 + r]
template <int Dh>
__device__ __forceinline__ void stage_cols(float* dst, const float* src, long long stride,
                                           int row0, int n) {
  constexpr int kQuads = Dh / 4;
  for (int idx = threadIdx.x; idx < kTile * kQuads; idx += kThreads) {
    const int r = idx % kTile;
    const int c = (idx / kTile) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    constexpr int ld = Layout<Dh>::kLdT;
    dst[(c + 0) * ld + r] = v.x;
    dst[(c + 1) * ld + r] = v.y;
    dst[(c + 2) * ld + r] = v.z;
    dst[(c + 3) * ld + r] = v.w;
  }
}

// acc[i][j] = sum_d rows[ty*4 + i][d] * cols[d][tx + 16 j]
template <int Dh>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* rows,
                                             const float* cols, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  // four d at a time: a row's four values in one 16-byte load
#pragma unroll 2
  for (int d = 0; d < Dh; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(rows + (ty * 4 + i) * Layout<Dh>::kLd + d);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cols[(d + e) * Layout<Dh>::kLdT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
      }
    }
  }
}

// acc[i][jd] += sum_c p[ty*4 + i][c] * t[(tx + 16 jd) * 65 + c]: a (64, 64)
// tile times the transposed (Dh, 64) tile t, into 4 rows x Dh/16 columns
template <int Dh>
__device__ __forceinline__ void accumulate_product(float (&acc)[4][Dh / 16], const float* p,
                                                   const float* t, int ty, int tx) {
  // four c at a time: a row of p's four values in one 16-byte load
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * Layout<Dh>::kLdP + c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[Dh / 16];
#pragma unroll
      for (int jd = 0; jd < Dh / 16; ++jd) b[jd] = t[(tx + 16 * jd) * Layout<Dh>::kLdT + c + e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int jd = 0; jd < Dh / 16; ++jd) acc[i][jd] = fmaf(ai, b[jd], acc[i][jd]);
      }
    }
  }
}

// reductions over the 16 threads of a row (tx = lane % 16)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ grad,
                            float* __restrict__ dqkv, float* __restrict__ stats, int n,
                            int heads, float scale) {
  using L = Layout<Dh>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + L::kRowTile;
  float* kt = gs + L::kRowTile;
  float* vt = kt + L::kTTile;
  float* dss = vt + L::kTTile;
  const int d_model = heads * Dh;
  const long long stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kTile;
  const float* base = qkv + (long long)b * n * stride + h * Dh;
  const float* g_base = grad + (long long)b * n * d_model + h * Dh;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  stage_rows<Dh>(qs, base, stride, row0, n, 1.f);
  stage_rows<Dh>(gs, g_base, d_model, row0, n, 1.f);

  // pass 1: m, l = rowsum(exp(s - m)) and rowsum(dP * exp(s - m)), online
  float m[4], l[4], racc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = racc[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage_cols<Dh>(kt, base + d_model, stride, k0, n);
    stage_cols<Dh>(vt, base + 2 * d_model, stride, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product<Dh>(s, qs, kt, ty, tx);
    tile_product<Dh>(dp, gs, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < n ? __fmul_rn(s[i][j], scale) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
      racc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        racc[i] = fmaf(dp[i][j], p, racc[i]);
      }
    }
  }
  float r[4];
  float* st = stats + ((long long)b * heads + h) * 3 * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = row_sum(l[i]);
    r[i] = row_sum(racc[i]) / l[i];
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < n) {
      st[row] = m[i];
      st[n + row] = l[i];
      st[2 * n + row] = r[i];
    }
  }

  // pass 2: dS per key tile, then dQ += dS K
  float dq[4][Dh / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jd = 0; jd < Dh / 16; ++jd) dq[i][jd] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage_cols<Dh>(kt, base + d_model, stride, k0, n);
    stage_cols<Dh>(vt, base + 2 * d_model, stride, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product<Dh>(s, qs, kt, ty, tx);
    tile_product<Dh>(dp, gs, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool key_ok = k0 + tx + 16 * j < n;
        const float pn = key_ok ? expf(__fmul_rn(s[i][j], scale) - m[i]) / l[i] : 0.f;
        dss[(ty * 4 + i) * L::kLdP + tx + 16 * j] = pn * (dp[i][j] - r[i]) * scale;
      }
    }
    __syncthreads();
    accumulate_product<Dh>(dq, dss, kt, ty, tx);
  }
  float* o_base = dqkv + (long long)b * n * stride + h * Dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int jd = 0; jd < Dh / 16; ++jd) o_base[row * stride + tx + 16 * jd] = dq[i][jd];
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ grad,
                             float* __restrict__ dqkv, const float* __restrict__ stats, int n,
                             int heads, float scale) {
  using L = Layout<Dh>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + L::kRowTile;
  float* qt = vs + L::kRowTile;
  float* gt = qt + L::kTTile;
  float* pt = gt + L::kTTile;
  float* dst = pt + L::kPTile;
  float* st_m = dst + L::kPTile;
  float* st_l = st_m + kTile;
  float* st_r = st_l + kTile;
  const int d_model = heads * Dh;
  const long long stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x * kTile;
  const float* base = qkv + (long long)b * n * stride + h * Dh;
  const float* g_base = grad + (long long)b * n * d_model + h * Dh;
  const float* st = stats + ((long long)b * heads + h) * 3 * n;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  stage_rows<Dh>(ks, base + d_model, stride, key0, n, 1.f);
  stage_rows<Dh>(vs, base + 2 * d_model, stride, key0, n, 1.f);
  float dk[4][Dh / 16], dv[4][Dh / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jd = 0; jd < Dh / 16; ++jd) dk[i][jd] = dv[i][jd] = 0.f;
  }
  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    stage_cols<Dh>(qt, base, stride, q0, n);
    stage_cols<Dh>(gt, g_base, d_model, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < n;
      st_m[i] = ok ? st[q0 + i] : 0.f;
      st_l[i] = ok ? st[n + q0 + i] : 1.f;
      st_r[i] = ok ? st[2 * n + q0 + i] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are this block's keys, columns 64 queries
    float s[4][4], dp[4][4];
    tile_product<Dh>(s, ks, qt, ty, tx);
    tile_product<Dh>(dp, vs, gt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        const bool ok = q0 + q < n;
        const float pn = ok ? expf(__fmul_rn(s[i][j], scale) - st_m[q]) / st_l[q] : 0.f;
        pt[(ty * 4 + i) * L::kLdP + q] = pn;
        dst[(ty * 4 + i) * L::kLdP + q] = pn * (dp[i][j] - st_r[q]) * scale;
      }
    }
    __syncthreads();
    accumulate_product<Dh>(dv, pt, gt, ty, tx);
    accumulate_product<Dh>(dk, dst, qt, ty, tx);
  }
  float* o_base = dqkv + (long long)b * n * stride + h * Dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + ty * 4 + i;
    if (key >= n) continue;
#pragma unroll
    for (int jd = 0; jd < Dh / 16; ++jd) {
      o_base[key * stride + d_model + tx + 16 * jd] = dk[i][jd];
      o_base[key * stride + 2 * d_model + tx + 16 * jd] = dv[i][jd];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Dh>
cudaError_t launch_bwd(const void* qkv, const void* grad, void* dqkv, void* stats, int batch,
                       int n, int heads, float scale, cudaStream_t stream) {
  using L = Layout<Dh>;
  const int dq_bytes = 4 * (2 * L::kRowTile + 2 * L::kTTile + L::kPTile);
  const int dkv_bytes = 4 * (2 * L::kRowTile + 2 * L::kTTile + 2 * L::kPTile + 3 * kTile);
  cudaError_t err = allow_smem(attention_bwd_dq_f32_kernel<Dh>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(attention_bwd_dkv_f32_kernel<Dh>, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  attention_bwd_dq_f32_kernel<Dh><<<grid, kThreads, dq_bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(grad),
      static_cast<float*>(dqkv), static_cast<float*>(stats), n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_f32_kernel<Dh><<<grid, kThreads, dkv_bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(grad),
      static_cast<float*>(dqkv), static_cast<const float*>(stats), n, heads, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads) {
  return batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535;
}

}  // namespace

// qkv: f32 (batch, n, 3 * heads * head_dim); grad: f32 (batch, n, heads *
// head_dim); dqkv: f32, the shape of qkv; stats: f32 scratch of
// batch * heads * 3 * n values (m, l, r per row). All contiguous and 16-byte
// aligned. scale: the softmax temperature. Two launches, dQ then dK/dV.
// Returns the launches' cudaError_t.
extern "C" int cvt_attention_bwd_f32_long(const void* qkv, const void* grad, void* dqkv,
                                          void* stats, int batch, int n, int heads,
                                          int head_dim, float scale, void* stream) {
  if (bad_shape(batch, n, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch_bwd<16>(qkv, grad, dqkv, stats, batch, n, heads, scale, s);
    case 32: return (int)launch_bwd<32>(qkv, grad, dqkv, stats, batch, n, heads, scale, s);
    case 64: return (int)launch_bwd<64>(qkv, grad, dqkv, stats, batch, n, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
