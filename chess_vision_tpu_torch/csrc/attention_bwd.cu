// Multi-head attention backward into the packed dqkv layout.
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention_bwd (_attn_bwd_kernel): from the saved packed projection
// qkv (B, N, 3*D), D = H*Dh, and the cotangent g (B, N, D) of the attention
// output, for every (image, head):
//   S = Q K^T * scale (f32), pn = softmax(S) (max-shifted, normalized in f32),
//   dV = bf16(pn)^T g,  dP = g V^T,  r = rowsum(dP * pn),
//   dS = bf16(pn * (dP - r) * scale),  dQ = dS K,  dK = dS^T Q,
// f32 accumulation, one bf16 rounding of each output, written at columns
// h*Dh, D + h*Dh and 2*D + h*Dh of dqkv (B, N, 3*D): no permute copy. The
// N x N tiles never reach device memory.
//
// Bound on this card: at the ViT-B shape (B 256, N 257, Dh 64) the call reads
// qkv (303 MB) and g (101 MB) and writes dqkv (303 MB): 0.21 ms at 3.35 TB/s;
// its five products are 130 GFLOP, 0.13 ms at 989 TFLOP/s. Bytes bound it.
//
// Design. dK and dV sum over query rows, dQ over keys, and blocks share
// nothing, so there are two kernels behind one entry point, both
// deterministic (no atomics: two runs agree bit for bit):
//  1. attention_bwd_dq_kernel, one block of 4 warps per (64-query tile, head,
//     image), each warp 16 query rows with its Q and g fragments in
//     registers. The row max and row sum are recomputed here from qkv (the
//     forward saves nothing but qkv, as the JAX package's; the serving
//     forward pays nothing for training). Pass 1 walks the key tiles with an
//     online max-shifted sum for l = rowsum(exp(S - m)) and, rescaled the
//     same way, rowsum(dP * exp(S - m)), which gives r. It writes the row
//     statistics (m, 1/l, r) to an f32 scratch (B, H, 3, N). Pass 2 walks
//     the key tiles again in steps of 16 keys: S and dP for the step, dS
//     re-packed in registers as the A fragment of dS K (K staged transposed).
//  2. attention_bwd_dkv_kernel, one block per (64-key tile, head, image),
//     each warp 16 keys with its K and V fragments in registers. It walks
//     the query tiles, staging Q and g both row-major (B operands of
//     S^T = K Q^T and dP^T = V g^T) and transposed (B operands of
//     dV = pn^T g and dK = dS^T Q), and reads the row statistics.
//  It costs 9 products where the TPU kernel does 5. mma.sync m16n8k16 tiles,
//  shared-memory rows padded by 8 bf16, exp2 with scale*log2(e) folded.
//  Pass 2 and kernel 2 work 16 keys (queries) at a time, so S and dP never
//  exist as whole 64 x 64 tiles in registers: ptxas -v (CUDA 12.8, -O3) reports
//  127 registers for the dQ kernel and 133 for the dK/dV kernel at Dh = 64
//  (96/83 at 32, 92/58 at 16), no spills, 27.6 and 37.6 KB of shared memory.
//  The ragged key tail is masked to -inf (pn = 0, dS = 0) and zero-filled in
//  shared memory; query rows past N load zeros, get statistics (0, 0, 0) in
//  kernel 2 so they add nothing to dK and dV, and are not stored.
// Against the JAX kernel the arithmetic differs only in f32 rounding order:
// pn = exp2(...) * (1/l) for exp(...) / l, and r from the online sum.
// Not yet done (later work): wgmma, TMA, double buffering, fewer
// recomputations (a forward that also writes the log-sum-exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // query rows (kernel 1) or keys (kernel 2) per block
constexpr int kPad = 8;             // bf16 padding per shared-memory row

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 rows x Dh columns at `base` (row stride `stride`) as m16n8k16 A
// fragments; rows at or past `n` read as zeros.
template <int Dh>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[Dh / 16][4],
                                                 const __nv_bfloat16* base,
                                                 long long stride, int r0,
                                                 int n, int t) {
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk) {
    const __nv_bfloat16* lo = base + (long long)r0 * stride + kk * 16 + t * 2;
    const __nv_bfloat16* hi = lo + 8 * stride;
    const bool lo_ok = r0 < n, hi_ok = r0 + 8 < n;
    a[kk][0] = lo_ok ? load_pair(lo) : 0u;
    a[kk][1] = hi_ok ? load_pair(hi) : 0u;
    a[kk][2] = lo_ok ? load_pair(lo + 8) : 0u;
    a[kk][3] = hi_ok ? load_pair(hi + 8) : 0u;
  }
}

// Stage 64 rows x Dh columns starting at row `row0` of `src` (row stride
// `stride`) into shared memory: row-major into `rows` and, when `cols` is not
// null, transposed into `cols`. Rows at or past `n` are zero-filled.
template <int Dh>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16 (*rows)[Dh + kPad], __nv_bfloat16 (*cols)[kTile + kPad],
    const __nv_bfloat16* src, long long stride, int row0, int n) {
  constexpr int kChunks = Dh / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c);
    }
    if (rows != nullptr) *reinterpret_cast<uint4*>(&rows[r][c]) = v;
    if (cols != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[c + j][r] = e[j];
    }
  }
}

// acc (16 x 8, n-block `nb` of the tile) = A (16 x Dh) * rows[nb*8.., :]^T
template <int Dh>
__device__ __forceinline__ void product_block(
    float (&acc)[4], const uint32_t (&a)[Dh / 16][4],
    __nv_bfloat16 (*rows)[Dh + kPad], int nb, int g, int t) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk) {
    const __nv_bfloat16* br = &rows[nb * 8 + g][kk * 16 + t * 2];
    mma_bf16_16816(acc, a[kk], load_pair(br), load_pair(br + 8));
  }
}

template <int Dh>
__global__ void __launch_bounds__(32 * kWarps)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ grad,
                        __nv_bfloat16* __restrict__ dqkv,
                        float* __restrict__ stats, int n, int heads,
                        float scale, float scale_log2) {
  static_assert(Dh % 16 == 0 && Dh <= 64, "head dim must be 16, 32, 48 or 64");
  __shared__ __align__(16) __nv_bfloat16 ks[kTile][Dh + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile][Dh + kPad];
  __shared__ __align__(16) __nv_bfloat16 kt[Dh][kTile + kPad];

  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;
  const __nv_bfloat16* g_base = grad + (long long)b * n * d_model + h * Dh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;  // rows r0 and r0 + 8

  uint32_t qa[Dh / 16][4], ga[Dh / 16][4];
  load_a_fragments<Dh>(qa, q_base, row_stride, r0, n, t);
  load_a_fragments<Dh>(ga, g_base, d_model, r0, n, t);

  // Pass 1: row max m (raw score units), l = sum exp(scale * (S - m)) and
  // racc = sum dP * exp(scale * (S - m)), online over the key tiles.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float racc[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage_tile<Dh>(ks, nullptr, q_base + d_model, row_stride, k0, n);
    stage_tile<Dh>(vs, nullptr, q_base + 2 * d_model, row_stride, k0, n);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      product_block<Dh>(s[nb], qa, ks, nb, g, t);
      product_block<Dh>(dp[nb], ga, vs, nb, g, t);
    }
    if (k0 + kTile > n) {
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + nb * 8 + t * 2 + (j & 1) >= n) s[nb][j] = -INFINITY;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float shift[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // every tile holds a valid key, so mx is finite; exp2(-inf) = 0
      const float alpha = exp2f((m[i] - mx[i]) * scale_log2);
      l[i] *= alpha;
      racc[i] *= alpha;
      m[i] = mx[i];
      shift[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const float p = exp2f(fmaf(s[nb][j], scale_log2, -shift[i]));
        l[i] += p;
        racc[i] = fmaf(dp[nb][j], p, racc[i]);
      }
    }
  }
  float shift[2], inv[2], rr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], 1);
    racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], 2);
    shift[i] = m[i] * scale_log2;
    inv[i] = 1.f / l[i];
    rr[i] = racc[i] * inv[i];
  }
  if (t == 0) {
    float* st = stats + ((long long)b * heads + h) * 3 * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < n) {
        st[r] = shift[i];
        st[n + r] = inv[i];
        st[2 * n + r] = rr[i];
      }
    }
  }

  // Pass 2: dQ = dS K, 16 keys at a time.
  float dq[Dh / 8][4];
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    dq[nb][0] = dq[nb][1] = dq[nb][2] = dq[nb][3] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage_tile<Dh>(ks, kt, q_base + d_model, row_stride, k0, n);
    stage_tile<Dh>(vs, nullptr, q_base + 2 * d_model, row_stride, k0, n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = kk * 2 + half;
        float s[4], dp[4], ds[4];
        product_block<Dh>(s, qa, ks, nb, g, t);
        product_block<Dh>(dp, ga, vs, nb, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          float pn = exp2f(fmaf(s[j], scale_log2, -shift[i])) * inv[i];
          if (k0 + nb * 8 + t * 2 + (j & 1) >= n) pn = 0.f;
          ds[j] = pn * (dp[j] - rr[i]) * scale;
        }
        dsa[half * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        dsa[half * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        const __nv_bfloat16* kr = &kt[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(dq[nb], dsa, load_pair(kr), load_pair(kr + 8));
      }
    }
  }
  __nv_bfloat16* o_base = dqkv + (long long)b * n * row_stride + h * Dh;
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    const int c = nb * 8 + t * 2;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(o_base + (long long)r0 * row_stride + c) =
          pack_bf16x2(dq[nb][0], dq[nb][1]);
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(o_base + (long long)(r0 + 8) * row_stride + c) =
          pack_bf16x2(dq[nb][2], dq[nb][3]);
    }
  }
}

template <int Dh>
__global__ void __launch_bounds__(32 * kWarps)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ grad,
                         __nv_bfloat16* __restrict__ dqkv,
                         const float* __restrict__ stats, int n, int heads,
                         float scale, float scale_log2) {
  static_assert(Dh % 16 == 0 && Dh <= 64, "head dim must be 16, 32, 48 or 64");
  __shared__ __align__(16) __nv_bfloat16 qs[kTile][Dh + kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[kTile][Dh + kPad];
  __shared__ __align__(16) __nv_bfloat16 qt[Dh][kTile + kPad];
  __shared__ __align__(16) __nv_bfloat16 gt[Dh][kTile + kPad];
  __shared__ float st_shift[kTile], st_inv[kTile], st_r[kTile];

  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;
  const __nv_bfloat16* g_base = grad + (long long)b * n * d_model + h * Dh;
  const float* st = stats + ((long long)b * heads + h) * 3 * n;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;  // keys r0 and r0 + 8
  const bool key_ok[2] = {r0 < n, r0 + 8 < n};

  uint32_t ka[Dh / 16][4], va[Dh / 16][4];
  load_a_fragments<Dh>(ka, q_base + d_model, row_stride, r0, n, t);
  load_a_fragments<Dh>(va, q_base + 2 * d_model, row_stride, r0, n, t);

  float dk[Dh / 8][4], dv[Dh / 8][4];
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    dk[nb][0] = dk[nb][1] = dk[nb][2] = dk[nb][3] = 0.f;
    dv[nb][0] = dv[nb][1] = dv[nb][2] = dv[nb][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    stage_tile<Dh>(qs, qt, q_base, row_stride, q0, n);
    stage_tile<Dh>(gs, gt, g_base, d_model, q0, n);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool ok = q0 + i < n;  // rows past n: pn = exp2(0) * 0 = 0
      st_shift[i] = ok ? st[q0 + i] : 0.f;
      st_inv[i] = ok ? st[n + q0 + i] : 0.f;
      st_r[i] = ok ? st[2 * n + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // transposed tiles: rows are this warp's keys, columns 16 queries
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = kk * 2 + half;
        float s[4], dp[4], pn[4], ds[4];
        product_block<Dh>(s, ka, qs, nb, g, t);
        product_block<Dh>(dp, va, gs, nb, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nb * 8 + t * 2 + (j & 1);
          const float p = exp2f(fmaf(s[j], scale_log2, -st_shift[col])) * st_inv[col];
          pn[j] = key_ok[j >> 1] ? p : 0.f;
          ds[j] = pn[j] * (dp[j] - st_r[col]) * scale;
        }
        pa[half * 2 + 0] = pack_bf16x2(pn[0], pn[1]);
        pa[half * 2 + 1] = pack_bf16x2(pn[2], pn[3]);
        dsa[half * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        dsa[half * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        const __nv_bfloat16* gr = &gt[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(dv[nb], pa, load_pair(gr), load_pair(gr + 8));
        const __nv_bfloat16* qr = &qt[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(dk[nb], dsa, load_pair(qr), load_pair(qr + 8));
      }
    }
  }
  __nv_bfloat16* o_base = dqkv + (long long)b * n * row_stride + h * Dh;
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    const int c = nb * 8 + t * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!key_ok[i]) continue;
      __nv_bfloat16* row = o_base + (long long)(r0 + 8 * i) * row_stride + c;
      *reinterpret_cast<uint32_t*>(row + d_model) =
          pack_bf16x2(dk[nb][2 * i], dk[nb][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(row + 2 * d_model) =
          pack_bf16x2(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  }
}

template <int Dh>
void launch(const void* qkv, const void* grad, void* dqkv, void* stats,
            int batch, int n, int heads, float scale, cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  attention_bwd_dq_kernel<Dh><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(grad),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(stats), n, heads,
      scale, scale_log2);
  attention_bwd_dkv_kernel<Dh><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(grad),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<const float*>(stats), n,
      heads, scale, scale_log2);
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim); grad: bf16 (batch, n, heads *
// head_dim); dqkv: bf16, the shape of qkv; stats: f32 scratch of
// batch * heads * 3 * n values. All contiguous and 16-byte aligned. scale:
// the softmax temperature (1 / sqrt(head_dim)). Returns the launches'
// cudaError_t.
extern "C" int cvt_attention_bwd(const void* qkv, const void* grad, void* dqkv,
                                 void* stats, int batch, int n, int heads,
                                 int head_dim, float scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(qkv, grad, dqkv, stats, batch, n, heads, scale, s); break;
    case 32: launch<32>(qkv, grad, dqkv, stats, batch, n, heads, scale, s); break;
    case 64: launch<64>(qkv, grad, dqkv, stats, batch, n, heads, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
