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
// Bound on this card: at (256, 257, 2304) the call reads qkv (303 MB) and
// writes the codes (51 MB) and scales: 0.1057 ms at 3.35 TB/s, above its
// products' 0.053 ms at 989 TFLOP/s (4 B H N^2 Dh); the exp on the CUDA
// cores as in K4, and the variants move the CUDA-core share, which is what
// the sweep reads.
//
// Design: K4's (attention_quant.cu) on the loop of attention_loop.cuh: one
// block of 3 warps per (chunk of up to 96 query rows, head, group of bb
// images); rows and keys cut at 16; a 2-stage cp.async ring of 64-key tiles;
// operands by ldmatrix. A variant is a compile-time policy (VariantPolicy):
// its score transform, its exponential, and the row statistic it takes p
// against. That statistic must be FINAL before any p is formed, because the
// variants round p where the JAX kernel does (bf16s subtracts in bf16, noexp
// has no exponential to rescale), so no variant runs K4's online rescale;
// each is a row statistic, then one walk over the keys with that fixed shift
// per row (flash_fixed_step):
//   - noshift, fexp_ns: a constant; one walk;
//   - normbound: max_j |k_j|^2 from the head's K rows in device memory
//     (flash_key_norm_max, shared with K4's bound), then the per-row bound
//     from the folded q's norm; then the walk;
//   - base, foldscale, noexp, fexp, bf16s: walk 1 over K alone takes S and
//     the row max (flash_max_step: no V tiles, no P V), walk 2 forms p
//     against that max.
// The row sum adds the rounded pairs in key order, S and P V come from the
// same mma.sync on the same fragments, and max is exact in any order, so the
// codes and scales are those of the earlier design (one 4-warp tile per 64
// rows, o written to an f32 (B, N, D) scratch, then a row-pass launch) bit
// for bit. The per-token scale spans all heads: as K4, the blocks of a row
// chunk's H heads form a thread-block cluster (dims (1, H, 1)) and exchange
// their row maxima through distributed shared memory (K4's epilogue
// without its rowsum floor), so at most 16 heads, no scratch and no second
// launch. `bb` images share a block (and its cluster) one after another: it
// changes the grouping and nothing else, as in the JAX kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_loop.cuh"
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

constexpr int kWarps = 3;      // warps a block, 32 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;  // blocks an SM, as K4
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr int kRows = 32 * kWarps;  // query rows per chunk
constexpr int kMaxHeads = 16;       // the largest cluster Hopper schedules

// q' = bf16(q * fold) on a packed pair
__device__ __forceinline__ uint32_t fold_pair(uint32_t raw, float fold) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(f.x, fold), __fmul_rn(f.y, fold));
  return *reinterpret_cast<uint32_t*>(&v);
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

// A variant's softmax: how its scores are formed (kScore, FlashScore), the
// row statistic its p is taken against (kRowMax: the row max of walk 1;
// kShift: a constant; else normbound's bound), and its p before the bf16
// rounding (prob).
template <int V>
struct VariantPolicy {
  static constexpr int kScore = V == kBase ? kScoreScaled : V == kBf16s ? kScoreBf16 : kScoreRaw;
  static constexpr bool kRowMax =
      V == kBase || V == kFoldScale || V == kNoExp || V == kFexp || V == kBf16s;
  static constexpr float kShift = V == kFexpNs ? 110.f : 24.f;  // noshift, fexp_ns
  __device__ __forceinline__ float operator()(float s, float m) const {
    if (V == kNoExp) return __fsub_rn(s, m);
    if (V == kFexp || V == kFexpNs) return fastexp2(__fsub_rn(s, m));
    if (V == kBf16s) return expf(flash_bf16_round(__fsub_rn(s, m)));  // bf16 in, bf16 out
    return expf(__fsub_rn(s, m));
  }
};

template <int Dh>
constexpr int smem_bytes() {
  // the ring and the Q rows; part and amax_s (kRows floats each); normbound's
  // per-warp key-norm maxima
  return 2 * flash_smem_elems<Dh, kWarps, kStages>() + (2 * kRows + kWarps) * 4;
}

template <int Dh, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_variant_kernel(const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ oq,
                         float* __restrict__ os, int n, int heads, int bb, float scale,
                         float fold) {
  using Policy = VariantPolicy<V>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = smem + flash_q_offset<Dh, kStages>();
  float* part = reinterpret_cast<float*>(smem_raw + 2 * flash_smem_elems<Dh, kWarps, kStages>());
  float* amax_s = part + kRows;
  float* red = amax_s + kRows;
  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;  // = the block's rank in its cluster
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cb = flash_chunk_blocks(n, gridDim.x);  // row blocks of a chunk
  const int row0 = blockIdx.x * cb * 16;
  const int cblocks = min(cb, (n + 15) / 16 - blockIdx.x * cb);
  const bool has[2] = {warp < cblocks, warp + kWarps < cblocks};

  for (int img = 0; img < bb; ++img) {
    const int b = blockIdx.z * bb + img;
    const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;
    flash_sync<kWarps>(0);  // the image before is done with the Q tile (its codes' staging)
    flash_copy_q<Dh, kWarps>(qs, q_base, row_stride, row0, cblocks, n, tid);
    flash_commit();
    // Q's fragments, folded: taken in the image's first walk, once Q has landed
    uint32_t qa[2][Dh / 16][4];
    auto take_q = [&] {
      flash_load_qa<Dh, kWarps>(qa, qs, has, warp, lane);
      if constexpr (V != kBase) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kk = 0; kk < Dh / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[j][kk][e] = fold_pair(qa[j][kk][e], fold);
      }
    };

    // the shift of rows g (index 0) and g + 8 (1) of the warp's row blocks
    float m[2][2];
    if constexpr (Policy::kRowMax) {
      // walk 1: S and the row max, over K alone
#pragma unroll
      for (int j = 0; j < 2; ++j) m[j][0] = m[j][1] = -INFINITY;
      flash_walk<Dh, kWarps, kStages, false>(
          q_base, row_stride, d_model, n, smem, tid, 0, take_q,
          [&](const __nv_bfloat16* ks, const __nv_bfloat16*, int k0, bool full) {
            flash_for_rows(has, full, [&](auto nb, auto whole) {
              flash_max_step<Dh, Policy::kScore, decltype(nb)::value, decltype(whole)::value>(
                  ks, k0, n, scale, qa, m, lane);
            });
          });
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m[j][i] = fmaxf(m[j][i], __shfl_xor_sync(0xffffffffu, m[j][i], 1));
          m[j][i] = fmaxf(m[j][i], __shfl_xor_sync(0xffffffffu, m[j][i], 2));
        }
    } else if constexpr (V == kNormBound) {
      // max_j |k_j|^2 over the image's keys of this head, then each row's
      // bound from its folded fragments
      const float kmax =
          flash_key_norm_max<Dh, kWarps>(q_base, row_stride, d_model, n, tid, 0, red, take_q);
      flash_norm_bound<Dh>(qa, has, kmax, 1.f, 40.f, m);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) m[j][0] = m[j][1] = Policy::kShift;
    }

    // the walk: p against the row's shift, P V and the row sum
    float o[2][Dh / 8][4];
    float l[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j][0] = l[j][1] = 0.f;
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) o[j][nb][0] = o[j][nb][1] = o[j][nb][2] = o[j][nb][3] = 0.f;
    }
    auto walk = [&](const __nv_bfloat16* ks, const __nv_bfloat16* vs, int k0, bool full) {
      flash_for_rows(has, full, [&](auto nb, auto whole) {
        flash_fixed_step<Dh, Policy::kScore, decltype(nb)::value, decltype(whole)::value>(
            ks, vs, k0, n, scale, qa, m, l, o, lane, Policy{});
      });
    };
    // Q's fragments, unless a walk before this one took them
    auto first = [&] {
      if constexpr (!Policy::kRowMax && V != kNormBound) take_q();
    };
    flash_walk<Dh, kWarps, kStages, true>(q_base, row_stride, d_model, n, smem, tid, 0, first, walk);
    // the row sums over the four threads of a row
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 1));
        l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 2));
      }
    // K4's exchange (attention_quant.cu), with no floor on the row sum:
    // 1. o / rowsum, and this head's share of each row's max |o|
    flash_quant_normalize<Dh, kWarps, false>(o, l, has, part, warp, lane);
    flash_cluster_arrive();
    flash_cluster_wait();
    // 2. row tid's amax over all heads; rank 0 writes its scale
    if (tid < cblocks * 16 && row0 + tid < n) {
      float amax = 0.f;
      for (int rank = 0; rank < heads; ++rank) {
        amax = fmaxf(amax, flash_cluster_load(part + tid, rank));
      }
      amax = fmaxf(amax, 1e-8f);
      amax_s[tid] = amax;
      if (h == 0) os[(long long)b * n + row0 + tid] = __fmul_rn(amax, kInv127);
    }
    // the cluster's wait comes after the store: no block leaves, nor writes
    // part for its next image, while a peer may still read it
    flash_cluster_arrive();
    __syncthreads();
    // 3. this head's codes, staged in the warp's own rows of the Q tile
    flash_quant_store<Dh, kWarps>(o, has, amax_s, reinterpret_cast<int8_t*>(qs),
                                  oq + (long long)b * n * d_model + h * Dh, d_model, row0, n,
                                  warp, lane);
    flash_cluster_wait();
  }
}

template <int Dh, int V>
cudaError_t launch_variant(const void* qkv, void* oq, void* os, int batch, int n, int heads,
                           int bb, float scale, float fold, cudaStream_t stream) {
  auto kernel = attention_variant_kernel<Dh, V>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err =
      flash_cluster_config(kernel, dim3(flash_chunks(n, kWarps), heads, batch / bb), kThreads,
                           smem_bytes<Dh>(), stream, config, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(qkv),
                            static_cast<int8_t*>(oq), static_cast<float*>(os), n, heads, bb,
                            scale, fold);
}

template <int Dh>
cudaError_t launch(int variant, const void* qkv, void* oq, void* os, int batch, int n,
                   int heads, int bb, float scale, float fold, cudaStream_t s) {
  switch (variant) {
    case kBase: return launch_variant<Dh, kBase>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kFoldScale:
      return launch_variant<Dh, kFoldScale>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kNoShift:
      return launch_variant<Dh, kNoShift>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kNoExp:
      return launch_variant<Dh, kNoExp>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kFexp: return launch_variant<Dh, kFexp>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kFexpNs:
      return launch_variant<Dh, kFexpNs>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case kBf16s:
      return launch_variant<Dh, kBf16s>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    default:
      return launch_variant<Dh, kNormBound>(qkv, oq, os, batch, n, heads, bb, scale, fold, s);
  }
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim), contiguous, 16-byte aligned;
// heads at most 16 (one cluster holds every head of a row chunk). oq: int8
// (batch, n, heads * head_dim); os: f32 (batch, n). variant: the Variant
// enum's value. bb: images per block, a divisor of batch. scale: the softmax
// temperature (base multiplies the scores by it); fold: the bf16-rounded
// factor the other variants multiply q by. Returns the launch's cudaError_t.
extern "C" int cvt_attention_variant(const void* qkv, void* oq, void* os, int variant, int batch,
                                     int n, int heads, int head_dim, int bb, float scale,
                                     float fold, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || heads > kMaxHeads || bb < 1 || batch % bb ||
      batch / bb > 65535 || variant < 0 || variant >= kVariants) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return (int)launch<32>(variant, qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    case 64: return (int)launch<64>(variant, qkv, oq, os, batch, n, heads, bb, scale, fold, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
