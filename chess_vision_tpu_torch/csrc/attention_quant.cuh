// Device code of the quantizing attention: one (64-query tile, head, image)
// work item of K4 / K5, run by a group of 4 warps.
//
// attention_quant.cu launches it one item per 128-thread block; the
// whole-block kernel (fused_block.cu) runs two groups side by side in one
// 256-thread block, each on its own shared-memory tile and its own named
// barrier. attention_variants.cu shares the fragment helpers. What the loop
// computes, its numerics and its bound are in attention_quant.cu's header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cvt {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = 32 * kAttnWarps;  // one group
constexpr int kAttnQTile = 16 * kAttnWarps;    // query rows per work item
constexpr int kAttnKTile = 64;                 // keys per shared-memory tile
constexpr int kAttnPad = 8;                    // bf16 padding per shared-memory row

template <int Dh>
struct AttnSmem {
  __nv_bfloat16 ks[kAttnKTile][Dh + kAttnPad];
  __nv_bfloat16 vt[Dh][kAttnKTile + kAttnPad];
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p0, p1 rounded to bf16: the packed pair, and their sum as rounded values.
__device__ __forceinline__ uint32_t round_pair(float p0, float p1, float& sum) {
  __nv_bfloat162 v = __floats2bfloat162_rn(p0, p1);
  const float2 f = __bfloat1622float2(v);
  sum = __fadd_rn(sum, __fadd_rn(f.x, f.y));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Barrier among the kAttnThreads threads of one group: barrier 0 for a block
// of exactly one group (__syncthreads()), a named barrier of its own for
// each group of a larger block.
__device__ __forceinline__ void group_sync(int bar) {
  if (bar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kAttnThreads) : "memory");
  }
}

// Copy keys k0 .. k0 + 63 of one head into shared memory: K as it lies, V
// transposed. Keys at index >= n_keys are zero-filled and never read from
// global memory.
template <int Dh>
__device__ __forceinline__ void load_kv_tile(AttnSmem<Dh>& sm, const __nv_bfloat16* q_base,
                                             long long row_stride, int d_model, int k0,
                                             int n_keys, int tid) {
  constexpr int kChunks = Dh / 8;
  for (int idx = tid; idx < kAttnKTile * kChunks; idx += kAttnThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u);
    uint4 vv = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < n_keys) {
      const __nv_bfloat16* src = q_base + (long long)(k0 + r) * row_stride + c;
      kv = *reinterpret_cast<const uint4*>(src + d_model);
      vv = *reinterpret_cast<const uint4*>(src + 2 * d_model);
    }
    *reinterpret_cast<uint4*>(&sm.ks[r][c]) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.vt[c + j][r] = ve[j];
  }
}

// One work item: queries qtile * 64 .. + 63 of head h of image b, against
// keys 0 .. n_keys - 1 of that image; the f32 result goes to out (rows of
// d_model floats). n is the rows per image (the stride between images and the
// bound on the query rows); n_keys <= n the keys that take part. K4 passes
// n_keys = n. K5 passes the padded row count as n and the real token count
// as n_keys: the key loop ends at n_keys and the ragged last tile is masked
// by n_keys, so a padded row is never a key. A padded QUERY row is computed
// like any other (its own q against the real keys); whatever it holds stays
// in its own output row, and the row pass that follows is per row, so it
// cannot reach a real row.
template <int Dh>
__device__ __forceinline__ void attention_quant_tile(
    const __nv_bfloat16* __restrict__ qkv, float* __restrict__ out, int n, int n_keys,
    int heads, float scale, float fixed_shift, int fixed, int qtile, int h, int b,
    AttnSmem<Dh>& sm, int tid, int bar) {
  static_assert(Dh % 16 == 0 && Dh <= 128, "head dim must be 16..128, x16");
  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = qtile * kAttnQTile + warp * 16 + g;  // rows r0 and r0 + 8

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
  }

  float o[Dh / 8][4];
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  // Shift per row (fixed, or the running max) and per-thread partial row
  // sums of the rounded probabilities, for rows r0 (0) and r0 + 8 (1).
  float m[2] = {fixed ? fixed_shift : -INFINITY, fixed ? fixed_shift : -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_keys; k0 += kAttnKTile) {
    group_sync(bar);
    load_kv_tile<Dh>(sm, q_base, row_stride, d_model, k0, n_keys, tid);
    group_sync(bar);

    float s[kAttnKTile / 8][4];
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
        // a masked key: exp(-inf - shift) is exactly 0, in P V and the row sum
        s[nb][j] = k0 + nb * 8 + t * 2 + (j & 1) < n_keys ? __fmul_rn(s[nb][j], scale)
                                                           : -INFINITY;
      }
    }

    float alpha[2] = {1.f, 1.f};
    if (!fixed) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < kAttnKTile / 8; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // every tile holds a valid key, so mx is finite; exp(-inf) = 0
        alpha[i] = expf(__fsub_rn(m[i], mx[i]));
        m[i] = mx[i];
      }
    }

    uint32_t pa[kAttnKTile / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kAttnKTile / 8; ++nb) {
      const float p0 = expf(__fsub_rn(s[nb][0], m[0]));
      const float p1 = expf(__fsub_rn(s[nb][1], m[0]));
      const float p2 = expf(__fsub_rn(s[nb][2], m[1]));
      const float p3 = expf(__fsub_rn(s[nb][3], m[1]));
      pa[nb / 2][(nb % 2) * 2 + 0] = round_pair(p0, p1, rs[0]);
      pa[nb / 2][(nb % 2) * 2 + 1] = round_pair(p2, p3, rs[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), rs[i]);
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
#pragma unroll
      for (int kk = 0; kk < kAttnKTile / 16; ++kk) {
        const __nv_bfloat16* vr = &sm.vt[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(o[nb], pa[kk], load_pair(vr), load_pair(vr + 8));
      }
    }
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
    den[i] = fmaxf(l[i], 1e-30f);  // rowsum floor: an underflowed row -> 0
  }
  float* o_base = out + (long long)b * n * d_model + h * Dh;
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    const int c = nb * 8 + t * 2;
    if (r0 < n) {
      *reinterpret_cast<float2*>(o_base + (long long)r0 * d_model + c) =
          make_float2(__fdiv_rn(o[nb][0], den[0]), __fdiv_rn(o[nb][1], den[0]));
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<float2*>(o_base + (long long)(r0 + 8) * d_model + c) =
          make_float2(__fdiv_rn(o[nb][2], den[1]), __fdiv_rn(o[nb][3], den[1]));
    }
  }
}

}  // namespace cvt
