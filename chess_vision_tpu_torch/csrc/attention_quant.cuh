// Device code of the bf16 attention loops: the mma.sync fragment helpers
// that attention_loop.cuh (K2, K4/K5, K14's attention stage, K15) builds on,
// and the int8 product of K4/K5's int8 legs.
// What the loops compute and their numerics are in attention_quant.cu's
// header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cvt {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the int8 tensor cores: A 16 x 32 (row), B 32 x 8 (col), s32
// accumulators in the layout of mma_bf16_16816's.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

}  // namespace cvt
