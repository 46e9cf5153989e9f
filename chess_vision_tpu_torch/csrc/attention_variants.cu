// The attention-variant sweep: attention + per-token int8 quantization with
// eight ways of doing the softmax's scale, shift and exponential.
//
// Replaces the TPU kernel experiments/attn_variants.py _make_variant, K15
// (the sweep behind `attn_variants.py sweep`). Per image and head, from the
// packed bf16 qkv (B, N, 3*D): scores, p rounded to bf16 feeding both P V and
// the row sum, o = (P V) / rowsum with NO floor on the row sum, then the row
// quant of the (N, D) f32 output over all heads. The variants keep the JAX
// kernel's arithmetic, which is what the sweep compares:
//
//   base       s = (q . k) * scale in f32; m = row max; p = exp(s - m)
//   foldscale  q' = bf16(q * bf16(scale)); s = q' . k; m = row max
//   noshift    folded q; p = exp(s - 24)
//   noexp      folded q; m = row max; p = s - m (no exponential: a cost probe)
//   fexp       q' = bf16(q * bf16(scale * log2 e)); m = row max;
//              p = 2^(s - m) by a cubic on the fraction spliced with the
//              exponent bits, the argument clipped to +-120
//   fexp_ns    as fexp with the constant shift 110
//   bf16s      folded q; s rounded to bf16; max, subtraction and exp in bf16
//   normbound  folded q; m_i = sqrt(|q'_i|^2 * max_j |k_j|^2) - 40 per head
//
// The factor folded into q is rounded to bf16 first and the product rounds
// again, as `q * jnp.asarray(fold, q.dtype)` does; the caller passes the
// rounded factor.
//
// Bound on this card: as K4, the exp on the CUDA cores and the two products
// at ~130 FLOP per byte, below the bf16 ridge; the variants move the CUDA-core
// share, which is what the sweep reads.
//
// Design: one kernel template over (head dim, variant) on K4's loop (4 warps
// per 64-query tile, head and image; 64-key K and V tiles in shared memory;
// mma.sync m16n8k16), then the row pass of rowquant.cuh in the same entry
// point. A variant's p must be taken against its FINAL row statistic to keep
// its arithmetic (bf16s subtracts in bf16, noexp has no exponential to
// rescale), so a row-max variant walks the key tiles twice: scores and max
// first, then scores again, p and P V. The fixed-shift variants and normbound
// walk them once (normbound after a pass over K alone for max_j |k_j|^2) and
// carry no online rescale. `bb` images share one block, one after another: it
// changes the grouping and nothing else, as in the JAX kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_quant.cuh"
#include "rowquant.cuh"

using namespace cvt;

namespace {

enum Variant : int {
  kBase = 0,
  kFoldScale = 1,
  kNoShift = 2,
  kNoExp = 3,
  kFexp = 4,
  kFexpNs = 5,
  kBf16s = 6,
  kNormBound = 7,
  kVariants = 8,
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// q' = bf16(q * fold) on a packed pair
__device__ __forceinline__ uint32_t fold_pair(uint32_t raw, float fold) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(f.x, fold), __fmul_rn(f.y, fold));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float pair_sq(uint32_t raw) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return __fadd_rn(__fmul_rn(f.x, f.x), __fmul_rn(f.y, f.y));
}

// 2^t: cubic on the fraction, exponent bits spliced in (attn_variants.py
// _fastexp2), every product and sum rounded on its own.
__device__ __forceinline__ float fastexp2(float t) {
  t = fminf(fmaxf(t, -120.f), 120.f);
  const float i = floorf(t);
  const float f = __fsub_rn(t, i);
  float p = __fadd_rn(0.2401536f, __fmul_rn(f, 0.0558282f));
  p = __fadd_rn(0.6931471f, __fmul_rn(f, p));
  p = __fadd_rn(1.0f, __fmul_rn(f, p));
  return __fmul_rn(__int_as_float(((int)i + 127) << 23), p);
}

template <int V>
constexpr bool kTakesMax = V == kBase || V == kFoldScale || V == kNoExp || V == kFexp ||
                           V == kBf16s;

// The probability of one score against its row's shift, before it is
// rounded to bf16.
template <int V>
__device__ __forceinline__ float prob(float s, float m) {
  if (V == kNoExp) return __fsub_rn(s, m);
  if (V == kFexp || V == kFexpNs) return fastexp2(__fsub_rn(s, m));
  if (V == kBf16s) return expf(bf16_round(__fsub_rn(s, m)));  // bf16 in, bf16 out
  return expf(__fsub_rn(s, m));
}

template <int Dh, int V>
__global__ void __launch_bounds__(kAttnThreads)
attention_variant_kernel(const __nv_bfloat16* __restrict__ qkv, float* __restrict__ out,
                         int n, int heads, int bb, float scale, float fold) {
  __shared__ __align__(16) AttnSmem<Dh> sm;
  __shared__ float red[kAttnWarps];

  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = blockIdx.x * kAttnQTile + warp * 16 + g;  // rows r0 and r0 + 8

  for (int img = 0; img < bb; ++img) {
    const int b = blockIdx.z * bb + img;
    const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;

    uint32_t qa[Dh / 16][4];
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      const __nv_bfloat16* lo = q_base + (long long)r0 * row_stride + c;
      const __nv_bfloat16* hi = lo + 8 * row_stride;
      const bool lo_ok = r0 < n, hi_ok = r0 + 8 < n;
      qa[kk][0] = lo_ok ? load_pair(lo) : 0u;
      qa[kk][1] = hi_ok ? load_pair(hi) : 0u;
      qa[kk][2] = lo_ok ? load_pair(lo + 8) : 0u;
      qa[kk][3] = hi_ok ? load_pair(hi + 8) : 0u;
      if (V != kBase) {
#pragma unroll
        for (int j = 0; j < 4; ++j) qa[kk][j] = fold_pair(qa[kk][j], fold);
      }
    }

    // scores of one key tile against the thread's two rows, as the variant's
    // softmax reads them; a key past the image is -inf
    auto scores = [&](float (&s)[kAttnKTile / 8][4], int k0) {
#pragma unroll
      for (int nb = 0; nb < kAttnKTile / 8; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < Dh / 16; ++kk) {
          const __nv_bfloat16* kr = &sm.ks[nb * 8 + g][kk * 16 + t * 2];
          mma_bf16_16816(s[nb], qa[kk], load_pair(kr), load_pair(kr + 8));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = s[nb][j];
          if (V == kBase) v = __fmul_rn(v, scale);
          if (V == kBf16s) v = bf16_round(v);
          s[nb][j] = k0 + nb * 8 + t * 2 + (j & 1) < n ? v : -INFINITY;
        }
      }
    };

    // the shift of rows r0 (0) and r0 + 8 (1)
    float m[2] = {0.f, 0.f};
    if (V == kNoShift) m[0] = m[1] = 24.f;
    if (V == kFexpNs) m[0] = m[1] = 110.f;
    if (kTakesMax<V>) {
      m[0] = m[1] = -INFINITY;
      for (int k0 = 0; k0 < n; k0 += kAttnKTile) {
        group_sync(0);
        load_kv_tile<Dh>(sm, q_base, row_stride, d_model, k0, n, tid);
        group_sync(0);
        float s[kAttnKTile / 8][4];
        scores(s, k0);
#pragma unroll
        for (int nb = 0; nb < kAttnKTile / 8; ++nb) {
          m[0] = fmaxf(m[0], fmaxf(s[nb][0], s[nb][1]));
          m[1] = fmaxf(m[1], fmaxf(s[nb][2], s[nb][3]));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
    }
    if (V == kNormBound) {
      // max_j |k_j|^2 over the image's keys of this head
      float kmax = 0.f;
      for (int k0 = 0; k0 < n; k0 += kAttnKTile) {
        group_sync(0);
        load_kv_tile<Dh>(sm, q_base, row_stride, d_model, k0, n, tid);
        group_sync(0);
        if (tid < kAttnKTile && k0 + tid < n) {
          float sq = 0.f;
#pragma unroll
          for (int c = 0; c < Dh; c += 2) sq = __fadd_rn(sq, pair_sq(load_pair(&sm.ks[tid][c])));
          kmax = fmaxf(kmax, sq);
        }
      }
      kmax = warp_max(kmax);
      group_sync(0);  // red may still be read for the image before
      if (lane == 0) red[warp] = kmax;
      group_sync(0);
      kmax = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
      float qn2[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < Dh / 16; ++kk) {
        qn2[0] = __fadd_rn(qn2[0], __fadd_rn(pair_sq(qa[kk][0]), pair_sq(qa[kk][2])));
        qn2[1] = __fadd_rn(qn2[1], __fadd_rn(pair_sq(qa[kk][1]), pair_sq(qa[kk][3])));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qn2[i] = __fadd_rn(qn2[i], __shfl_xor_sync(0xffffffffu, qn2[i], 1));
        qn2[i] = __fadd_rn(qn2[i], __shfl_xor_sync(0xffffffffu, qn2[i], 2));
        m[i] = __fsub_rn(__fsqrt_rn(__fmul_rn(qn2[i], kmax)), 40.f);
      }
    }

    float o[Dh / 8][4];
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
    float l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += kAttnKTile) {
      group_sync(0);
      load_kv_tile<Dh>(sm, q_base, row_stride, d_model, k0, n, tid);
      group_sync(0);
      float s[kAttnKTile / 8][4];
      scores(s, k0);
      uint32_t pa[kAttnKTile / 16][4];
#pragma unroll
      for (int nb = 0; nb < kAttnKTile / 8; ++nb) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // a key past the image adds nothing, whatever the variant's p of -inf
          p[j] = s[nb][j] == -INFINITY ? 0.f : prob<V>(s[nb][j], m[j / 2]);
        }
        pa[nb / 2][(nb % 2) * 2 + 0] = round_pair(p[0], p[1], l[0]);
        pa[nb / 2][(nb % 2) * 2 + 1] = round_pair(p[2], p[3], l[1]);
      }
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
#pragma unroll
        for (int kk = 0; kk < kAttnKTile / 16; ++kk) {
          const __nv_bfloat16* vr = &sm.vt[nb * 8 + g][kk * 16 + t * 2];
          mma_bf16_16816(o[nb], pa[kk], load_pair(vr), load_pair(vr + 8));
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
    }
    float* o_base = out + (long long)b * n * d_model + h * Dh;
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) {
      const int c = nb * 8 + t * 2;
      if (r0 < n) {  // the raw row sum: no floor in this kernel
        *reinterpret_cast<float2*>(o_base + (long long)r0 * d_model + c) =
            make_float2(__fdiv_rn(o[nb][0], l[0]), __fdiv_rn(o[nb][1], l[0]));
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<float2*>(o_base + (long long)(r0 + 8) * d_model + c) =
            make_float2(__fdiv_rn(o[nb][2], l[1]), __fdiv_rn(o[nb][3], l[1]));
      }
    }
  }
}

template <int Dh, int V>
cudaError_t launch_variant(const void* qkv, float* out, int batch, int n, int heads, int bb,
                           float scale, float fold, cudaStream_t stream) {
  const dim3 grid((n + kAttnQTile - 1) / kAttnQTile, heads, batch / bb);
  attention_variant_kernel<Dh, V><<<grid, kAttnThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, n, heads, bb, scale, fold);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch(int variant, const void* qkv, float* out, int batch, int n, int heads,
                   int bb, float scale, float fold, cudaStream_t s) {
  switch (variant) {
    case kBase: return launch_variant<Dh, kBase>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kFoldScale:
      return launch_variant<Dh, kFoldScale>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kNoShift:
      return launch_variant<Dh, kNoShift>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kNoExp: return launch_variant<Dh, kNoExp>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kFexp: return launch_variant<Dh, kFexp>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kFexpNs:
      return launch_variant<Dh, kFexpNs>(qkv, out, batch, n, heads, bb, scale, fold, s);
    case kBf16s: return launch_variant<Dh, kBf16s>(qkv, out, batch, n, heads, bb, scale, fold, s);
    default:
      return launch_variant<Dh, kNormBound>(qkv, out, batch, n, heads, bb, scale, fold, s);
  }
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim), contiguous, 16-byte aligned.
// scratch: f32 (batch, n, heads * head_dim). oq: int8 (batch, n, heads *
// head_dim); os: f32 (batch, n). variant: the Variant enum's value. bb:
// images per block, a divisor of batch. scale: the softmax temperature (base
// multiplies the scores by it); fold: the bf16-rounded factor the other
// variants multiply q by. Returns the first failing launch's cudaError_t.
extern "C" int cvt_attention_variant(const void* qkv, void* scratch, void* oq, void* os,
                                     int variant, int batch, int n, int heads, int head_dim,
                                     int bb, float scale, float fold, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || bb < 1 || batch % bb || batch / bb > 65535 ||
      heads > 65535 || variant < 0 || variant >= kVariants) {
    return (int)cudaErrorInvalidValue;
  }
  float* out = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 32: err = launch<32>(variant, qkv, out, batch, n, heads, bb, scale, fold, s); break;
    case 64: err = launch<64>(variant, qkv, out, batch, n, heads, bb, scale, fold, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rowquant(static_cast<const float*>(out), (long long)batch * n,
                              heads * head_dim, kRowNone, nullptr, nullptr, 0.f,
                              static_cast<int8_t*>(oq), static_cast<float*>(os), s);
}
