// Device code of the int8 x int8 -> int32 GEMM that the split kernels and
// the whole-block kernel share: the epilogues' names, the operand struct, the
// GELUs, and gemm_tile, the mma.sync main loop (one 128 x 128 output tile per
// call by a 256-thread block).
//
// gemm_tile is kept for the whole-block kernel (fused_block.cu) alone, which
// walks a cooperative 256-thread block, two per SM, over many tiles of each
// of its four products. The split kernels (int8_matmul.cu) run a wgmma main
// loop of their own, which wants one 384-thread block per SM and 160 KB of
// shared memory and does not fit that block shape. Both give the same bits
// (int32 sums are exact in any order and the epilogue arithmetic is the
// same), which chip_smoke.py holds them to. The numerics and the bound are
// in int8_matmul.cu's header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rowquant.cuh"

namespace cvt {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;  // bytes of K per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRowBytes = kBK + 16;  // padded shared-memory row
constexpr int kTileBytes = kBM * kRowBytes;
constexpr int kStageBytes = 2 * kTileBytes;  // A tile + B tile (kBN == kBM)
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kLoadIters = kBM * (kBK / 16) / kThreads;  // 16-byte copies
static_assert(kBN == kBM, "one tile size for A and B");
static_assert(kLoadIters * kThreads == kBM * (kBK / 16), "whole tiles per stage");

enum Epilogue : int {
  kEpiBias = 0,     // bf16(y)                     qkv
  kEpiRes = 1,      // bf16(res + y)               K10
  kEpiResLnQ = 2,   // bf16(res + y), then LN row quant   K9
  kEpiGeluQ = 3,    // f32 gelu(y), then row quant        K8
};

enum Gelu : int { kGeluErf = 0, kGeluSigmoid = 1, kGeluHard = 2 };

struct GemmArgs {
  const int8_t* xq;      // (m, k)
  const float* xs;       // (m,)
  const int8_t* w;       // (o, k)
  const float* ws;       // (o,)
  const float* bias;     // (o,)
  const __nv_bfloat16* res;  // (m, o) for the residual epilogues
  void* out;             // (m, o) bf16, or f32 for kEpiGeluQ
  long long m;
  int k;
  int o;
  int gelu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu(float x, int mode) {
  return mode == kGeluSigmoid ? gelu_sigmoid_div(x)
         : mode == kGeluHard  ? gelu_hard(x)
                              : gelu_erf(x);
}

// One 128 x 128 output tile, rows m0 .. and columns n0 .., by the kThreads
// threads of a block, through kSmemBytes of shared memory at smem. A caller
// that runs several tiles one after another (fused_block.cu) calls it again
// with the same smem: the barrier at the top keeps a tile's first loads off
// the stage that a slower warp still reads for the tile before.
template <int Epi>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, uint8_t* smem, long long m0,
                                          int n0) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  __syncthreads();
  const int wm = (warp / 4) * 64;  // warp's rows within the tile
  const int wn = (warp % 4) * 32;  // warp's columns within the tile

  auto load_stage = [&](int stage, int kt) {
    uint8_t* sa = smem + stage * kStageBytes;
    uint8_t* sb = sa + kTileBytes;
    const int kb = kt * kBK;
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kBK / 16);
      const int c = (i % (kBK / 16)) * 16;
      const bool k_ok = kb + c < p.k;
      const bool a_ok = k_ok && m0 + r < p.m;
      const bool b_ok = k_ok && n0 + r < p.o;
      cp_async16(sa + r * kRowBytes + c, a_ok ? p.xq + (m0 + r) * p.k + kb + c : p.xq,
                 a_ok);
      cp_async16(sb + r * kRowBytes + c,
                 b_ok ? p.w + (long long)(n0 + r) * p.k + kb + c : p.w, b_ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % kStages) * kStageBytes;
    const uint8_t* sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(a[mt], sa + (wm + mt * 16 + lane % 16) * kRowBytes + kk +
                               (lane / 16) * 16);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn + np * 16 + lane % 8 + (lane / 16) * 8) * kRowBytes +
                           kk + ((lane / 8) % 2) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread holds rows (g, g + 8) x columns (2t, 2t + 1) of each
  // 16 x 8 tile.
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= p.m) continue;
      const float xs = p.xs[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + t * 2;
        if (col >= p.o) continue;  // o % 8 == 0: both columns or neither
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __fmul_rn(__fmul_rn((float)acc[mt][nt][half * 2 + e], xs),
                                    p.ws[col + e]);
          y[e] = __fadd_rn(a, p.bias[col + e]);
        }
        const long long at = row * p.o + col;
        if (Epi == kEpiGeluQ) {
          float2 v = make_float2(gelu(y[0], p.gelu), gelu(y[1], p.gelu));
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = v;
        } else {
          if (Epi != kEpiBias) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.res + at));
            y[0] = __fadd_rn(r.x, y[0]);
            y[1] = __fadd_rn(r.y, y[1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
  }
}

}  // namespace cvt
