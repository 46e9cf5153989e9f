// The attention forward loop of K2 (attention.cu) and K4 / K5
// (attention_quant.cu): one block of W warps takes up to 32 * W query rows of
// one (image, head) and walks that head's keys in steps of 64 through a
// cp.async ring in shared memory. The two kernels differ only in the softmax
// arithmetic (kQuant), which each keeps bit for bit from its earlier design;
// what each computes, its bound and its numbers are in its own source.
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
// The f32 accumulators come back to the caller, which writes them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_quant.cuh"  // mma_bf16_16816, round_pair

namespace cvt {

constexpr int kFlashKTile = 64;  // keys per step (the online max's rescaling step)
constexpr int kFlashPad = 8;     // bf16 padding per shared-memory row

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

// Keys k0 .. k0 + 63 of one head into ring stage `st`; keys >= n_keys are zero.
template <int Dh, int W>
__device__ __forceinline__ void flash_copy_kv(__nv_bfloat16* st, const __nv_bfloat16* q_base,
                                              long long row_stride, int d_model, int k0,
                                              int n_keys, int tid) {
  constexpr int kLd = Dh + kFlashPad;
  constexpr int kChunks = Dh / 8;
  for (int idx = tid; idx < kFlashKTile * kChunks; idx += 32 * W) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = k0 + r < n_keys;
    const __nv_bfloat16* src = q_base + (long long)(ok ? k0 + r : 0) * row_stride + c;
    flash_cp16(st + r * kLd + c, src + d_model, ok);
    flash_cp16(st + (kFlashKTile + r) * kLd + c, src + 2 * d_model, ok);
  }
}

// S for sub-step hs (keys k0 + 16 hs .. + 15) of the NB row blocks: n-blocks
// of 8 keys from one ldmatrix.x4 each; K4's scale applied, masked keys -inf.
template <int Dh, bool kQuant, int NB, bool kFull>
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
        if (kQuant) {
          s[j][h][e] = key_ok ? __fmul_rn(s[j][h][e], scale) : -INFINITY;
        } else if (!key_ok) {
          s[j][h][e] = -INFINITY;
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
template <int Dh, bool kQuant, int NB, bool kFull>
__device__ __forceinline__ void flash_step(const __nv_bfloat16* ks,
                                                    const __nv_bfloat16* vs, int k0,
                                                    int n_keys, float scale, bool fixed,
                                                    const uint32_t (&qa)[2][Dh / 16][4],
                                                    float (&m)[2][2], float (&l)[2][2],
                                                    float (&o)[2][Dh / 8][4], int lane) {
  constexpr int kLd = Dh + kFlashPad;
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
      flash_sub_scores<Dh, kQuant, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
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
    flash_sub_scores<Dh, kQuant, NB, kFull>(s, ks, hs, k0, n_keys, scale, qa, lane);
    uint32_t pa[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kQuant) {
          const float p0 = expf(__fsub_rn(s[j][h][0], m[j][0]));
          const float p1 = expf(__fsub_rn(s[j][h][1], m[j][0]));
          const float p2 = expf(__fsub_rn(s[j][h][2], m[j][1]));
          const float p3 = expf(__fsub_rn(s[j][h][3], m[j][1]));
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

// The loop. q_base points at q of this (image, head) (k at + d_model, v at
// + 2 d_model, rows row_stride apart). The chunk is rows row0 .. row0 + 16 *
// cblocks - 1 of the image's n rows; keys 0 .. n_keys - 1 take part.
// K2 (kQuant false): scale = softmax scale * log2(e); p = exp2(s * scale -
// m * scale). K4 (kQuant true): s = fl(s * scale); p = bf16(exp(s - m)) with
// m the fixed shift when `fixed`, else the running max. On return o holds
// P V and l the full row sums of warp row block j (j = 0, 1: blocks w and
// w + W of the chunk) for rows g (index 0) and g + 8 (index 1); has[j] says
// whether the block lies in the chunk.
template <int Dh, int W, int Stages, bool kQuant>
__device__ __forceinline__ void flash_attention_rows(
    const __nv_bfloat16* __restrict__ q_base, long long row_stride, int d_model, int row0,
    int cblocks, int n, int n_keys, float scale, float fixed_shift, bool fixed,
    __nv_bfloat16* smem, float (&o)[2][Dh / 8][4], float (&l)[2][2], bool (&has)[2]) {
  static_assert(Dh == 16 || Dh == 32 || Dh == 64, "head dim must be 16, 32 or 64");
  constexpr int kLd = Dh + kFlashPad;
  constexpr int kChunks = Dh / 8;
  constexpr int kStages = Stages;
  static_assert(kStages >= 2, "the ring needs two stages");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  __nv_bfloat16* qs = smem + flash_q_offset<Dh, Stages>();

  // Q of the chunk, then the first tiles of the ring
  for (int idx = tid; idx < cblocks * 16 * kChunks; idx += 32 * W) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = row0 + r < n;
    flash_cp16(qs + r * kLd + c, q_base + (long long)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
  const int ntiles = (n_keys + kFlashKTile - 1) / kFlashKTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) {
      flash_copy_kv<Dh, W>(smem + st * 2 * kFlashKTile * kLd, q_base, row_stride, d_model,
                           st * kFlashKTile, n_keys, tid);
    }
    flash_commit();
  }

  has[0] = warp < cblocks;
  has[1] = warp + W < cblocks;
  uint32_t qa[2][Dh / 16][4];
  float m[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[j][i] = kQuant && fixed ? fixed_shift : -INFINITY;
      l[j][i] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) o[j][nb][0] = o[j][nb][1] = o[j][nb][2] = o[j][nb][3] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    flash_wait<kStages - 2>();
    __syncthreads();  // tile `tile` has landed; every warp is done with tile - 1
    if (tile == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* at = qs + ((warp + j * W) * 16 + lane % 16) * kLd + (lane / 16) * 8;
#pragma unroll
        for (int kk = 0; kk < Dh / 16; ++kk) {
          if (has[j]) flash_ldsm_x4(qa[j][kk], at + kk * 16);
        }
      }
    }
    {
      const int next = tile + kStages - 1;
      if (next < ntiles) {
        flash_copy_kv<Dh, W>(smem + (next % kStages) * 2 * kFlashKTile * kLd, q_base,
                             row_stride, d_model, next * kFlashKTile, n_keys, tid);
      }
      flash_commit();
    }
    const __nv_bfloat16* ks = smem + (tile % kStages) * 2 * kFlashKTile * kLd;
    const __nv_bfloat16* vs = ks + kFlashKTile * kLd;
    const int k0 = tile * kFlashKTile;
    const bool full = k0 + kFlashKTile <= n_keys;
    if (has[1]) {
      if (full) {
        flash_step<Dh, kQuant, 2, true>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o, lane);
      } else {
        flash_step<Dh, kQuant, 2, false>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o, lane);
      }
    } else if (has[0]) {
      if (full) {
        flash_step<Dh, kQuant, 1, true>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o, lane);
      } else {
        flash_step<Dh, kQuant, 1, false>(ks, vs, k0, n_keys, scale, fixed, qa, m, l, o, lane);
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

}  // namespace cvt
