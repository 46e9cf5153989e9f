// Device code of the bf16 attention loops: the mma.sync fragment helpers
// that attention_loop.cuh (K2, K4/K5, K14's attention stage) builds on, and
// the 4-warp work item shape with its shared-memory tile
// (AttnSmem, load_kv_tile, group_sync) that the attention-variant sweep
// (attention_variants.cu, K15) still runs. What the loops compute and their
// numerics are in attention_quant.cu's header.

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

}  // namespace cvt
