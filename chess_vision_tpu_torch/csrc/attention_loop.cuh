// The attention forward loop of K2 (attention.cu), K4 / K5
// (attention_quant.cu) and K15 (attention_variants.cu): one block of W warps
// takes up to 32 * W query rows of one (image, head) and walks that head's
// keys in steps of 64 through a cp.async ring in shared memory. The kernels
// differ only in the softmax arithmetic (kQuant for K2 and K4; K15's variants
// walk with flash_walk and a fixed shift per row, see below), which each
// keeps bit for bit from its earlier design; what each computes, its bound
// and its numbers are in its own source.
//
// Layout and schedule:
//  - Query rows are cut into blocks of 16 and keys into sub-steps of 16, so
//    257 tokens cost 272 x 272 scores (1.12x), not the 320 x 320 of 64-row
//    tiles. A warp owns two row blocks (w and w + W of its chunk), so every
//    K or V fragment it reads feeds four mma.sync m16n8k16, not two.
//  - The chunk's Q rows and each 64-key K/V tile are copied from device
//    memory by cp.async, 16 bytes a thread, into rows padded by 8 bf16: the
//    eight row addresses of an ldmatrix then fall in distinct banks. Q and K
//    are read by ldmatrix.x4 as they lie, V by ldmatrix.x4.trans (no scalar
//    transpose). A ring of `Stages` tiles is in flight: the copy of the next
//    tile runs under the products of this one.
//  - The online max (K2, and K4 without a fixed shift) is rescaled once per
//    64-key step, as before, but each step computes S twice, 16 keys at a
//    time (flash_step): once for the step's max, once for p and P V. That
//    keeps 8 scores a thread live instead of 32, so 12 warps share an SM in
//    168 registers; with all 32 live, 8 warps an SM were slower.
//  - 16-key sub-steps wholly past the last key are not computed. Their p would
//    be exact zeros, which add nothing to a row sum or to P V, so the skip
//    leaves every bit as it was.
//  - Rows past the image's rows load zeros and are not stored; keys past
//    n_keys are zero-filled, masked to -inf, and give p = 0.
//  - K15's variants take p against a row statistic known before the walk
//    (a constant, a bound from a pass over K, or the row max of a first walk
//    over K alone), so their walk carries no online rescale: flash_walk runs
//    the ring with a step of the caller's (flash_max_step, flash_fixed_step),
//    and the row sum adds each rounded pair as it comes, in key order.
//  - K4/K5/K14's shift (FlashShift): the exact row max (online, as above), a
//    fixed shift, or the JAX package's default "bound", |q_i| max_j |k_j| - 45
//    per row and head: max_j |k_j|^2 from the head's K rows in device memory
//    (flash_key_norm_max, which K15's normbound runs too), the
//    row's |q|^2 from its fragments (flash_norm_bound), then the loop with
//    that shift per row, as with a fixed one.
//  - K4/K5's int8 legs (the JAX package's qk_int8 / pv_int8) walk the keys
//    with flash_walk and the steps here (flash_max_step_with,
//    flash_fixed_step_with) on scores from int8 codes quantized in shared
//    memory; the codes, the int8 P V step and the schedule are in
//    attention_quant.cu.
// The f32 accumulators come back to the caller, which writes them. The loop
// runs on a block of 32 W threads, or on one group of 32 W threads of a
// larger block (the whole-block kernel, fused_block.cu, runs four), which
// then names its thread index within the group and a barrier of its own.
// The quantizing kernels (K4/K5, K15) end in the two halves of the
// quantizing epilogue, between which the blocks of a row chunk's heads,
// a thread-block cluster, exchange their row maxima through distributed
// shared memory (flash_cluster_load; attention_quant.cu's header).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_quant.cuh"  // mma_bf16_16816, round_pair
#include "rowquant.cuh"         // quant1

namespace cvt {

constexpr int kFlashKTile = 64;  // keys per step (the online max's rescaling step)
constexpr int kFlashPad = 8;     // bf16 padding per shared-memory row

// The instantiation of the attention kernels (K2, K3, bf16 and f32) that
// runs head dim dh: the smallest of 16, 32, 64, 80 and 128 that holds it,
// for dh a multiple of 8 up to 128 (0 for another dh, which the
// any-head-dim kernels of attention_any.cu run). A head dim between
// two runs the larger one with its extra columns zero in shared memory: a
// zero column adds an exact zero to every dot product, and is never stored.
// The quantizing kernels (K4/K5, K14, K15) take 16, 32 and 64 alone.
__host__ __device__ constexpr int flash_head_dim(int dh) {
  return dh < 8 || dh > 128 || dh % 8 ? 0
         : dh <= 16                   ? 16
         : dh <= 32                   ? 32
         : dh <= 64                   ? 64
         : dh <= 80                   ? 80
                                      : 128;
}

// The shift p = exp(s - shift) is taken against (K4/K5, K14): the exact row
// max, a fixed shift, or the bound |q_i| |k|max - kBoundOffset per row.
enum FlashShift : int { kShiftMax = 0, kShiftFixed = 1, kShiftBound = 2 };
constexpr float kBoundOffset = 45.f;  // the JAX package's _BOUND_OFFSET

// What flash_sub_scores does to a score before the mask: nothing (K2, which
// scales inside its exp2; K15's variants that fold the scale into q),
// fl(s * scale) (K4, K15's base), or a rounding to bf16 (K15's bf16s).
enum FlashScore : int { kScoreRaw = 0, kScoreScaled = 1, kScoreBf16 = 2 };

// Barrier of the 32 W threads that run the loop: the block's (bar 0), or
// named barrier `bar` of their group.
template <int W>
__device__ __forceinline__ void flash_sync(int bar) {
  if (bar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * W) : "memory");
  }
}

// Bf16 elements from the start of shared memory to the chunk's Q rows, for
// a ring of `Stages` K/V tiles.
template <int Dh, int Stages>
__host__ __device__ constexpr int flash_q_offset() {
  return Stages * 2 * kFlashKTile * (Dh + kFlashPad);
}

__device__ __forceinline__ uint32_t flash_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared memory, or 16 zero bytes when !ok (src is not read).
__device__ __forceinline__ void flash_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(flash_smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void flash_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void flash_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ void flash_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(flash_smem_u32(p)));
}

__device__ __forceinline__ void flash_ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(flash_smem_u32(p)));
}

__device__ __forceinline__ uint32_t flash_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of one block, in bf16 elements: the K/V ring
// ([stages][K | V][64][Dh + 8]), then the chunk's Q rows ([32 W][Dh + 8]),
// which the caller may reuse to stage its output once the loop has returned.
template <int Dh, int W, int Stages>
__host__ __device__ constexpr int flash_smem_elems() {
  return flash_q_offset<Dh, Stages>() + 32 * W * (Dh + kFlashPad);
}

// Row chunks per (image, head): as many as 2 W row blocks each need, the row
// blocks then spread evenly (257 tokens, W = 3: chunks of 6, 6 and 5 blocks).
__host__ __device__ __forceinline__ int flash_chunks(int n, int w) {
  return ((n + 15) / 16 + 2 * w - 1) / (2 * w);
}

__host__ __device__ __forceinline__ int flash_chunk_blocks(int n, int chunks) {
  return ((n + 15) / 16 + chunks - 1) / chunks;
}

// Keys k0 .. k0 + 63 of one head into ring stage `st`; keys >= n_keys are
// zero, and so are the columns at or past the head's dh (a head dim that
// runs on the next larger instantiation Dh). kV: V too (a walk that takes
// scores alone copies K only).
template <int Dh, int W, bool kV = true>
__device__ __forceinline__ void flash_copy_kv(__nv_bfloat16* st, const __nv_bfloat16* q_base,
                                              long long row_stride, int d_model, int k0,
                                              int n_keys, int tid, int dh = Dh) {
  constexpr int kLd = Dh + kFlashPad;
  constexpr int kChunks = Dh / 8;
  for (int idx = tid; idx < kFlashKTile * kChunks; idx += 32 * W) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = k0 + r < n_keys && c < dh;
    const __nv_bfloat16* src = q_base + (long long)(ok ? k0 + r : 0) * row_stride + c;
    flash_cp16(st + r * kLd + c, src + d_model, ok);
    if (kV) flash_cp16(st + (kFlashKTile + r) * kLd + c, src + 2 * d_model, ok);
  }
}

// The chunk's Q rows row0 .. row0 + 16 cblocks - 1 into qs; rows >= n and
// columns >= dh are zero.
template <int Dh, int W>
__device__ __forceinline__ void flash_copy_q(__nv_bfloat16* qs, const __nv_bfloat16* q_base,
                                             long long row_stride, int row0, int cblocks, int n,
                                             int tid, int dh = Dh) {
  constexpr int kLd = Dh + kFlashPad;
  constexpr int kChunks = Dh / 8;
  for (int idx = tid; idx < cblocks * 16 * kChunks; idx += 32 * W) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = row0 + r < n && c < dh;
    flash_cp16(qs + r * kLd + c, q_base + (long long)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

// The A fragments of the warp's row blocks (w and w + W) from the Q rows.
template <int Dh, int W>
__device__ __forceinline__ void flash_load_qa(uint32_t (&qa)[2][Dh / 16][4],
                                              const __nv_bfloat16* qs, const bool (&has)[2],
                                              int warp, int lane) {
  constexpr int kLd = Dh + kFlashPad;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const __nv_bfloat16* at = qs + ((warp + j * W) * 16 + lane % 16) * kLd + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      if (has[j]) flash_ldsm_x4(qa[j][kk], at + kk * 16);
    }
  }
}

__device__ __forceinline__ float flash_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x0^2 + x1^2 of a packed bf16 pair, each product and the sum rounded.
__device__ __forceinline__ float flash_pair_sq(uint32_t raw) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return __fadd_rn(__fmul_rn(f.x, f.x), __fmul_rn(f.y, f.y));
}

// S for sub-step hs (keys k0 + 16 hs .. + 15) of the NB row blocks: n-blocks
// of 8 keys from one ldmatrix.x4 each; kScore (FlashScore) applied, masked
// keys -inf.
template <int Dh, int kScore, int NB, bool kFull>
__device__ __forceinline__ void flash_sub_scores(float (&s)[NB][2][4], const __nv_bfloat16* ks,
                                                 int hs, int k0, int n_keys, float scale,
                                                 const uint32_t (&qa)[2][Dh / 16][4], int lane) {
  constexpr int kLd = Dh + kFlashPad;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) s[j][h][0] = s[j][h][1] = s[j][h][2] = s[j][h][3] = 0.f;
  const __nv_bfloat16* kr = ks + (hs * 16 + lane % 8 + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk) {
    uint32_t b[4];
    flash_ldsm_x4(b, kr + kk * 16);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mma_bf16_16816(s[j][0], qa[j][kk], b[0], b[1]);
      mma_bf16_16816(s[j][1], qa[j][kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_ok = kFull || k0 + hs * 16 + h * 8 + t * 2 + (e & 1) < n_keys;
        if (kScore == kScoreScaled) {
          s[j][h][e] = key_ok ? __fmul_rn(s[j][h][e], scale) : -INFINITY;
        } else if (kScore == kScoreBf16) {
          s[j][h][e] = key_ok ? flash_bf16_round(s[j][h][e]) : -INFINITY;
        } else if (!key_ok) {
          s[j][h][e] = -INFINITY;
        }
      }
}

// o of the NB row blocks += P V for sub-step hs: pa is P's A fragment, V's
// B fragments come by ldmatrix.x4.trans from the stage's V rows.
template <int Dh, int NB>
__device__ __forceinline__ void flash_sub_pv(float (&o)[2][Dh / 8][4], const uint32_t (&pa)[NB][4],
                                             const __nv_bfloat16* vs, int hs, int lane) {
  constexpr int kLd = Dh + kFlashPad;
  const __nv_bfloat16* vr =
      vs + (hs * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;
#pragma unroll
  for (int dp = 0; dp < Dh / 16; ++dp) {
    uint32_t b[4];
    flash_ldsm_x4_trans(b, vr + dp * 16);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mma_bf16_16816(o[j][2 * dp], pa[j], b[0], b[1]);
      mma_bf16_16816(o[j][2 * dp + 1], pa[j], b[2], b[3]);
    }
  }
}

// One 64-key step for the NB (1 or 2) row blocks of a warp. S is computed
// twice, 16 keys at a time: a first pass takes the step's row max, a second
// forms p and adds P V sub-step by sub-step. So a row block holds 8 scores a
// thread, not 32: with 2 row blocks a warp, 12 warps an SM fit in 168
// registers a thread, for half as much tensor work again (none in K4's
// fixed-shift mode, which needs no max). The values and every order of
// summation are those of one pass over the step: the same mma.sync on the
// same fragments gives the same S, max is exact in any order, the row sum
// takes the n-blocks in the same order and o is rescaled before the step's
// P V. kFull: every key of the step is below n_keys, nothing is masked and no
// sub-step skipped; the last, ragged step of a head takes kFull = false.
// Each case is its own straight-line code, so the compiler can interleave the
// two row blocks' work.
template <int Dh, bool kQuant, int NB, bool kFull, bool kExpBf16>
__device__ __forceinline__ void flash_step(const __nv_bfloat16* ks,
                                                    const __nv_bfloat16* vs, int k0,
                                                    int n_keys, float scale, bool fixed,
                                                    const uint32_t (&qa)[2][Dh / 16][4],
                                                    float (&m)[2][2], float (&l)[2][2],
                                                    float (&o)[2][Dh / 8][4], int lane) {
  constexpr int kScore = kQuant ? kScoreScaled : kScoreRaw;
  const int nsub = kFull ? 4 : min(4, (n_keys - k0 + 15) / 16);
  float alpha[NB][2], shift[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) alpha[j][0] = alpha[j][1] = 1.f;
  if (!kQuant || !fixed) {
    float mx[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) mx[j][0] = m[j][0], mx[j][1] = m[j][1];
#pragma unroll
    for (int hs = 0; hs < 4; ++hs) {
      if (!kFull && hs >= nsub) continue;  // its scores are -inf: no effect on the max
      float s[NB][2][4];
      flash_sub_scores<Dh, kScore, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[j][0] = fmaxf(mx[j][0], fmaxf(s[j][h][0], s[j][h][1]));
          mx[j][1] = fmaxf(mx[j][1], fmaxf(s[j][h][2], s[j][h][3]));
        }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[j][i] = fmaxf(mx[j][i], __shfl_xor_sync(0xffffffffu, mx[j][i], 1));
        mx[j][i] = fmaxf(mx[j][i], __shfl_xor_sync(0xffffffffu, mx[j][i], 2));
        if (kQuant) {
          alpha[j][i] = expf(__fsub_rn(m[j][i], mx[j][i]));
        } else {
          alpha[j][i] = exp2f((m[j][i] - mx[j][i]) * scale);
          shift[j][i] = mx[j][i] * scale;
        }
        m[j][i] = mx[j][i];
      }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) {
      o[j][nb][0] *= alpha[j][0];
      o[j][nb][1] *= alpha[j][0];
      o[j][nb][2] *= alpha[j][1];
      o[j][nb][3] *= alpha[j][1];
    }
  float rs[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) rs[j][0] = rs[j][1] = 0.f;
#pragma unroll
  for (int hs = 0; hs < 4; ++hs) {
    if (!kFull && hs >= nsub) continue;  // p = 0 exactly: nothing to add
    float s[NB][2][4];
    flash_sub_scores<Dh, kScore, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
    uint32_t pa[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kQuant) {
          // kExpBf16: the argument rounded to bf16 first (CHESS_VISION_ATTN_EXP=bf16)
          auto arg = [](float x, float mx) {
            const float d = __fsub_rn(x, mx);
            return kExpBf16 ? flash_bf16_round(d) : d;
          };
          const float p0 = expf(arg(s[j][h][0], m[j][0]));
          const float p1 = expf(arg(s[j][h][1], m[j][0]));
          const float p2 = expf(arg(s[j][h][2], m[j][1]));
          const float p3 = expf(arg(s[j][h][3], m[j][1]));
          pa[j][h * 2 + 0] = round_pair(p0, p1, rs[j][0]);
          pa[j][h * 2 + 1] = round_pair(p2, p3, rs[j][1]);
        } else {
          const float p0 = exp2f(fmaf(s[j][h][0], scale, -shift[j][0]));
          const float p1 = exp2f(fmaf(s[j][h][1], scale, -shift[j][0]));
          const float p2 = exp2f(fmaf(s[j][h][2], scale, -shift[j][1]));
          const float p3 = exp2f(fmaf(s[j][h][3], scale, -shift[j][1]));
          rs[j][0] += p0 + p1;
          rs[j][1] += p2 + p3;
          pa[j][h * 2 + 0] = flash_pack(p0, p1);
          pa[j][h * 2 + 1] = flash_pack(p2, p3);
        }
      }
    flash_sub_pv<Dh, NB>(o, pa, vs, hs, lane);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kQuant) {
        l[j][i] = __fadd_rn(__fmul_rn(l[j][i], alpha[j][i]), rs[j][i]);
      } else {
        l[j][i] = l[j][i] * alpha[j][i] + rs[j][i];
      }
    }
}

// A 64-key step of a walk over K alone: each row's max score into m (per
// thread; the caller reduces over the four threads of a row once the walk is
// done). Sub-steps wholly past n_keys are skipped: their scores are -inf.
// scores(s, hs) fills S of sub-step hs, masked keys -inf (flash_sub_scores, or
// the int8 legs' sub_scores_i8 in attention_quant.cu).
template <int NB, bool kFull, typename Scores>
__device__ __forceinline__ void flash_max_step_with(int k0, int n_keys, Scores&& scores,
                                                    float (&m)[2][2]) {
  const int nsub = kFull ? 4 : min(4, (n_keys - k0 + 15) / 16);
#pragma unroll
  for (int hs = 0; hs < 4; ++hs) {
    if (!kFull && hs >= nsub) continue;
    float s[NB][2][4];
    scores(s, hs);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[j][0] = fmaxf(m[j][0], fmaxf(s[j][h][0], s[j][h][1]));
        m[j][1] = fmaxf(m[j][1], fmaxf(s[j][h][2], s[j][h][3]));
      }
  }
}

template <int Dh, int kScore, int NB, bool kFull>
__device__ __forceinline__ void flash_max_step(const __nv_bfloat16* ks, int k0, int n_keys,
                                               float scale, const uint32_t (&qa)[2][Dh / 16][4],
                                               float (&m)[2][2], int lane) {
  flash_max_step_with<NB, kFull>(k0, n_keys, [&](float (&s)[NB][2][4], int hs) {
    flash_sub_scores<Dh, kScore, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
  }, m);
}

// A 64-key step with a shift per row fixed before the walk (m: rows g and
// g + 8 of each row block): p = prob(s, m) rounded to bf16 feeds P V and the
// row sum l, which adds each rounded pair as it comes, in key order, with no
// rescale. A masked key's p is 0 whatever prob gives for -inf; a full step
// has none, and leaves out the test (a compare and a select a score, on the
// chain of arithmetic that sets the walk's pace: 14-19% of the kernel's time).
// Scores as for flash_max_step_with.
template <int Dh, int NB, bool kFull, typename Scores, typename Prob>
__device__ __forceinline__ void flash_fixed_step_with(const __nv_bfloat16* vs, int k0, int n_keys,
                                                      Scores&& scores, const float (&m)[2][2],
                                                      float (&l)[2][2], float (&o)[2][Dh / 8][4],
                                                      int lane, Prob prob) {
  const int nsub = kFull ? 4 : min(4, (n_keys - k0 + 15) / 16);
#pragma unroll
  for (int hs = 0; hs < 4; ++hs) {
    if (!kFull && hs >= nsub) continue;  // p = 0 exactly: nothing to add
    float s[NB][2][4];
    scores(s, hs);
    uint32_t pa[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = !kFull && s[j][h][e] == -INFINITY ? 0.f : prob(s[j][h][e], m[j][e / 2]);
        }
        pa[j][h * 2 + 0] = round_pair(p[0], p[1], l[j][0]);
        pa[j][h * 2 + 1] = round_pair(p[2], p[3], l[j][1]);
      }
    flash_sub_pv<Dh, NB>(o, pa, vs, hs, lane);
  }
}

template <int Dh, int kScore, int NB, bool kFull, typename Prob>
__device__ __forceinline__ void flash_fixed_step(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                                 int k0, int n_keys, float scale,
                                                 const uint32_t (&qa)[2][Dh / 16][4],
                                                 const float (&m)[2][2], float (&l)[2][2],
                                                 float (&o)[2][Dh / 8][4], int lane, Prob prob) {
  flash_fixed_step_with<Dh, NB, kFull>(
      vs, k0, n_keys,
      [&](float (&s)[NB][2][4], int hs) {
        flash_sub_scores<Dh, kScore, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
      },
      m, l, o, lane, prob);
}

// step(nb, full) with nb = std::integral_constant<int, NB>, full =
// std::bool_constant: the warp's row blocks (NB = 2 when it has both, 1 when
// only the first) and whether the step is free of masked keys. A warp with no
// row block in the chunk does nothing.
template <typename Step>
__device__ __forceinline__ void flash_for_rows(const bool (&has)[2], bool full, Step&& step) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (has[1]) {
    if (full) {
      step(Two{}, std::true_type{});
    } else {
      step(Two{}, std::false_type{});
    }
  } else if (has[0]) {
    if (full) {
      step(One{}, std::true_type{});
    } else {
      step(One{}, std::false_type{});
    }
  }
}

// A walk over the keys 0 .. n_keys - 1 of one (image, head) through
// the ring: the 64-key tiles of K (and of V when kV) land in turn, and
// step(ks, vs, k0, full) runs on each (ks, vs: the tile's K and V rows, vs
// meaningless without kV; full: no key of the tile is masked). first() runs
// once, after the first tile's barrier, when everything the caller copied
// before the walk has landed too (the chunk's Q rows). A walk may follow
// another on the same ring: it waits first for every thread to be done with
// the tiles before. Arguments as for flash_attention_rows. K15 walks with it,
// and so do K4/K5's bound and int8 legs.
template <int Dh, int W, int Stages, bool kV, typename First, typename Step>
__device__ __forceinline__ void flash_walk(const __nv_bfloat16* q_base, long long row_stride,
                                           int d_model, int n_keys, __nv_bfloat16* smem,
                                           int tid, int bar, First&& first, Step&& step) {
  static_assert(flash_head_dim(Dh) == Dh, "Dh must be an instantiated head dim");
  static_assert(Stages >= 2, "the ring needs two stages");
  constexpr int kLd = Dh + kFlashPad;
  const int ntiles = (n_keys + kFlashKTile - 1) / kFlashKTile;
  flash_sync<W>(bar);  // every thread is done with the ring's tiles of a walk before
#pragma unroll
  for (int st = 0; st < Stages - 1; ++st) {
    if (st < ntiles) {
      flash_copy_kv<Dh, W, kV>(smem + st * 2 * kFlashKTile * kLd, q_base, row_stride, d_model,
                               st * kFlashKTile, n_keys, tid);
    }
    flash_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    flash_wait<Stages - 2>();
    flash_sync<W>(bar);  // tile `tile` has landed; every warp is done with tile - 1
    if (tile == 0) first();
    const int next = tile + Stages - 1;
    if (next < ntiles) {
      flash_copy_kv<Dh, W, kV>(smem + (next % Stages) * 2 * kFlashKTile * kLd, q_base,
                               row_stride, d_model, next * kFlashKTile, n_keys, tid);
    }
    flash_commit();
    const __nv_bfloat16* ks = smem + (tile % Stages) * 2 * kFlashKTile * kLd;
    const int k0 = tile * kFlashKTile;
    step(ks, ks + kFlashKTile * kLd, k0, k0 + kFlashKTile <= n_keys);
  }
  flash_wait<0>();
}

// max_j |k_j|^2 over the keys 0 .. n_keys - 1 of one (image, head): three
// keys a thread at a time, their rows read from device memory in 16-byte loads
// through L1 (the 32 rows of a warp's load come in as whole lines, which the
// row's other loads then hit), all issued before the arithmetic; each key's
// columns summed a pair at a time in order; then the maximum over the warps
// through red (W floats of shared memory, free until the caller's next
// barrier). Every thread returns it. first() runs after that barrier, once
// everything the caller copied before has landed (the chunk's Q rows).
// K15's normbound and the bound shift of K4/K5 and K14 (whose qkv, written
// by its own earlier stage, no block has read into L1 before). A walk over
// the K tiles through the ring, one barrier a tile, cost K4 a fifth of its
// time at 257 tokens, and loads that bypass L1 (16 of each 32-byte sector
// used) a third.
template <int Dh, int W, typename First>
__device__ __forceinline__ float flash_key_norm_max(const __nv_bfloat16* q_base,
                                                    long long row_stride, int d_model,
                                                    int n_keys, int tid, int bar, float* red,
                                                    First&& first) {
  constexpr int kAtOnce = 3;  // keys a thread has in flight: 257 in one round at W = 3
  float kmax = 0.f;
  for (int key0 = tid; key0 < n_keys; key0 += kAtOnce * 32 * W) {
    uint4 raw[kAtOnce][Dh / 8];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      const int key = key0 + u * 32 * W;
      const uint4* kr =
          reinterpret_cast<const uint4*>(q_base + (long long)key * row_stride + d_model);
#pragma unroll
      for (int c = 0; c < Dh / 8; ++c) raw[u][c] = key < n_keys ? kr[c] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      float sq = 0.f;  // a key past n_keys: 0, which leaves the max alone
#pragma unroll
      for (int c = 0; c < Dh / 8; ++c) {
        sq = __fadd_rn(sq, flash_pair_sq(raw[u][c].x));
        sq = __fadd_rn(sq, flash_pair_sq(raw[u][c].y));
        sq = __fadd_rn(sq, flash_pair_sq(raw[u][c].z));
        sq = __fadd_rn(sq, flash_pair_sq(raw[u][c].w));
      }
      kmax = fmaxf(kmax, sq);
    }
  }
  kmax = warp_max(kmax);
  if (tid % 32 == 0) red[tid / 32] = kmax;
  flash_wait<0>();
  flash_sync<W>(bar);
  first();
  kmax = red[0];
#pragma unroll
  for (int w = 1; w < W; ++w) kmax = fmaxf(kmax, red[w]);
  return kmax;
}

// The bound shift of the warp's rows (g: index 0, g + 8: 1, of each row block
// it has): sqrt(fl(|q|^2 * q2scale) * kmax) - offset, |q|^2 summed over the
// row's fragments a pair at a time, then over the row's four threads. q2scale
// turns the |q|^2 of the fragments into that of the folded q (K4: scale^2,
// exact for a power-of-two scale; K15, whose fragments are folded: 1).
template <int Dh>
__device__ __forceinline__ void flash_norm_bound(const uint32_t (&qa)[2][Dh / 16][4],
                                                 const bool (&has)[2], float kmax,
                                                 float q2scale, float offset,
                                                 float (&m)[2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!has[j]) continue;  // the same for the whole warp
    float qn2[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      qn2[0] = __fadd_rn(qn2[0], __fadd_rn(flash_pair_sq(qa[j][kk][0]), flash_pair_sq(qa[j][kk][2])));
      qn2[1] = __fadd_rn(qn2[1], __fadd_rn(flash_pair_sq(qa[j][kk][1]), flash_pair_sq(qa[j][kk][3])));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qn2[i] = __fadd_rn(qn2[i], __shfl_xor_sync(0xffffffffu, qn2[i], 1));
      qn2[i] = __fadd_rn(qn2[i], __shfl_xor_sync(0xffffffffu, qn2[i], 2));
      m[j][i] = __fsub_rn(__fsqrt_rn(__fmul_rn(__fmul_rn(qn2[i], q2scale), kmax)), offset);
    }
  }
}

// The loop. q_base points at q of this (image, head) (k at + d_model, v at
// + 2 d_model, rows row_stride apart). The chunk is rows row0 .. row0 + 16 *
// cblocks - 1 of the image's n rows; keys 0 .. n_keys - 1 take part.
// K2 (kQuant false): scale = softmax scale * log2(e); p = exp2(s * scale -
// m * scale). K4 (kQuant true): s = fl(s * scale); p = bf16(exp(s - m)) with
// m by `shift` (FlashShift): fixed_shift, the bound (a walk over K first;
// red: W floats of shared memory for it, unused otherwise) or the running
// max; kExpBf16 rounds s - m to bf16 before the exp. On return o holds
// P V and l the full row sums of warp row block j (j = 0, 1: blocks w and
// w + W of the chunk) for rows g (index 0) and g + 8 (index 1); has[j] says
// whether the block lies in the chunk. tid: the thread's index among the 32 W
// that run the loop; bar: their barrier (flash_sync). dh: the head's columns
// (up to Dh; the rest of Q, K and V is zero).
template <int Dh, int W, int Stages, bool kQuant, bool kExpBf16 = false>
__device__ __forceinline__ void flash_attention_rows(
    const __nv_bfloat16* __restrict__ q_base, long long row_stride, int d_model, int row0,
    int cblocks, int n, int n_keys, float scale, float fixed_shift, int shift, float* red,
    __nv_bfloat16* smem, float (&o)[2][Dh / 8][4], float (&l)[2][2], bool (&has)[2], int tid,
    int bar, int dh = Dh) {
  static_assert(flash_head_dim(Dh) == Dh, "Dh must be an instantiated head dim");
  constexpr int kLd = Dh + kFlashPad;
  constexpr int kStages = Stages;
  static_assert(kStages >= 2, "the ring needs two stages");
  const int warp = tid / 32;
  const int lane = tid % 32;
  __nv_bfloat16* qs = smem + flash_q_offset<Dh, Stages>();
  const bool bound = kQuant && shift == kShiftBound;
  const bool fixed = kQuant && shift != kShiftMax;  // a shift per row before the walk

  // Q of the chunk, then the first tiles of the ring
  flash_copy_q<Dh, W>(qs, q_base, row_stride, row0, cblocks, n, tid, dh);
  const int ntiles = (n_keys + kFlashKTile - 1) / kFlashKTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) {
      flash_copy_kv<Dh, W>(smem + st * 2 * kFlashKTile * kLd, q_base, row_stride, d_model,
                           st * kFlashKTile, n_keys, tid, dh);
    }
    flash_commit();
  }
  // the bound's key norms, read while the copies above are in flight
  const float kmax = bound ? flash_key_norm_max<Dh, W>(q_base, row_stride, d_model, n_keys, tid,
                                                       bar, red, [] {})
                           : 0.f;

  has[0] = warp < cblocks;
  has[1] = warp + W < cblocks;
  uint32_t qa[2][Dh / 16][4];
  float m[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[j][i] = fixed ? fixed_shift : -INFINITY;
      l[j][i] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) o[j][nb][0] = o[j][nb][1] = o[j][nb][2] = o[j][nb][3] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    flash_wait<kStages - 2>();
    flash_sync<W>(bar);  // tile `tile` has landed; every warp is done with tile - 1
    if (tile == 0) {
      flash_load_qa<Dh, W>(qa, qs, has, warp, lane);
      if (bound) flash_norm_bound<Dh>(qa, has, kmax, __fmul_rn(scale, scale), kBoundOffset, m);
    }
    {
      const int next = tile + kStages - 1;
      if (next < ntiles) {
        flash_copy_kv<Dh, W>(smem + (next % kStages) * 2 * kFlashKTile * kLd, q_base,
                             row_stride, d_model, next * kFlashKTile, n_keys, tid, dh);
      }
      flash_commit();
    }
    const __nv_bfloat16* ks = smem + (tile % kStages) * 2 * kFlashKTile * kLd;
    const __nv_bfloat16* vs = ks + kFlashKTile * kLd;
    const int k0 = tile * kFlashKTile;
    const bool full = k0 + kFlashKTile <= n_keys;
    if (has[1]) {
      if (full) {
        flash_step<Dh, kQuant, 2, true, kExpBf16>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o,
                                                     lane);
      } else {
        flash_step<Dh, kQuant, 2, false, kExpBf16>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o,
                                                     lane);
      }
    } else if (has[0]) {
      if (full) {
        flash_step<Dh, kQuant, 1, true, kExpBf16>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o,
                                                     lane);
      } else {
        flash_step<Dh, kQuant, 1, false, kExpBf16>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o,
                                                     lane);
      }
    }
  }
  flash_wait<0>();

  // the row sums over the four threads of a row, in the earlier order
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kQuant) {
        l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 1));
        l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 2));
      } else {
        l[j][i] += __shfl_xor_sync(0xffffffffu, l[j][i], 1);
        l[j][i] += __shfl_xor_sync(0xffffffffu, l[j][i], 2);
      }
    }
  }
}

// The quantizing epilogue, first half: o / max(rowsum, 1e-30) in place (K4;
// K15, kFloor false, divides by the row sum as it is), and the max |o| over
// the head's Dh columns of each of the warp's rows into part[row] (row = its
// index in the chunk).
template <int Dh, int W, bool kFloor = true>
__device__ __forceinline__ void flash_quant_normalize(float (&o)[2][Dh / 8][4],
                                                      const float (&l)[2][2],
                                                      const bool (&has)[2], float* part,
                                                      int warp, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!has[j]) continue;
    const int rb = warp + j * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // rowsum floor: an underflowed row -> 0
      const float den = kFloor ? fmaxf(l[j][i], 1e-30f) : l[j][i];
      float mx = 0.f;
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        o[j][nb][2 * i] = __fdiv_rn(o[j][nb][2 * i], den);
        o[j][nb][2 * i + 1] = __fdiv_rn(o[j][nb][2 * i + 1], den);
        mx = fmaxf(mx, fmaxf(fabsf(o[j][nb][2 * i]), fabsf(o[j][nb][2 * i + 1])));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0) part[rb * 16 + g + 8 * i] = mx;
    }
  }
}

// The quantizing epilogue, second half: the head's codes of the warp's rows, with
// amax_s[row] the row's max |o| over all heads (floored at 1e-8), staged in
// the warp's own rows of `stage` (the chunk's Q tile) and stored 16 bytes a
// lane to q_out (this head's first column of the chunk's image; rows d_model
// bytes apart), rows past n left alone.
template <int Dh, int W>
__device__ __forceinline__ void flash_quant_store(const float (&o)[2][Dh / 8][4],
                                                  const bool (&has)[2], const float* amax_s,
                                                  int8_t* stage, int8_t* q_out, int d_model,
                                                  int row0, int n, int warp, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!has[j]) continue;
    const int rb = warp + j * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rb * 16 + g + 8 * i;
      const float inv = __fdiv_rn(127.f, amax_s[row]);
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        const uint32_t lo = (uint8_t)quant1(o[j][nb][2 * i], inv);
        const uint32_t hi = (uint8_t)quant1(o[j][nb][2 * i + 1], inv);
        *reinterpret_cast<uint16_t*>(stage + row * Dh + nb * 8 + t * 2) =
            (uint16_t)(lo | (hi << 8));
      }
    }
    __syncwarp();
    constexpr int kChunks = Dh / 16;  // 16-byte chunks of a row's codes
    for (int idx = lane; idx < 16 * kChunks; idx += 32) {
      const int row = rb * 16 + idx / kChunks;
      const int c = (idx % kChunks) * 16;
      if (row0 + row < n) {
        *reinterpret_cast<uint4*>(q_out + (long long)(row0 + row) * d_model + c) =
            *reinterpret_cast<const uint4*>(stage + row * Dh + c);
      }
    }
  }
}

// The value at `local` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float flash_cluster_load(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(flash_smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void flash_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void flash_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch of a quantizing kernel of 32 W threads a block on `grid` (row
// chunks, heads, image groups), the blocks of one row chunk's heads forming a
// cluster of dims (1, heads, 1): beyond the portable 8 blocks, up to 16.
// Sets the kernel's attributes; returns their error.
template <typename Kernel>
cudaError_t flash_cluster_config(Kernel kernel, dim3 grid, int threads, int smem_bytes,
                                 cudaStream_t stream, cudaLaunchConfig_t& config,
                                 cudaLaunchAttribute& attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace cvt
