// Device code of the int8 x int8 -> int32 GEMM that the split kernels
// (int8_matmul.cu) and the whole-block kernel (fused_block.cu) share: the
// epilogues' names, the GELUs, and the wgmma main loop with its TMA ring and
// epilogues, as the device functions wgmma_produce and wgmma_consume, which a
// kernel's producer warpgroup and consumer warpgroups call once per product
// (wgmma_product: both, for a kernel of one product). The residual kernels
// of int8_matmul.cu (K9 on a cluster, K10) run the same products of a tile
// (tile_products) with their own epilogue. The numerics, the design and the
// bound are in int8_matmul.cu's header; fused_block.cu's says how it runs
// four products in one launch.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rowquant.cuh"

namespace cvt {

enum Epilogue : int {
  kEpiBias = 0,     // bf16(y)                     qkv
  kEpiRes = 1,      // bf16(res + y)               K10
  kEpiResLnQ = 2,   // bf16(res + y), then LN row quant   K9
  kEpiGeluQ = 3,    // rowquant(gelu(y))                  K8
};

enum Gelu : int { kGeluErf = 0, kGeluSigmoid = 1, kGeluHard = 2 };
constexpr int kGeluAny = -1;  // wgmma_consume: take the GELU from WgArgs::gelu
// K8's bf16 epilogue (rowquant.cuh gelu_bf16): WgArgs::gelu 3 + the form (0
// erf, 1 sigmoid, 2 hard), one instantiation for the three
constexpr int kGeluBf16 = 3;
constexpr int kGeluLast = kGeluBf16 + kGeluHard;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float gelu(float x, int mode) {
  return mode == kGeluSigmoid ? gelu_sigmoid_div(x)
         : mode == kGeluHard  ? gelu_hard(x)
                              : gelu_erf(x);
}

constexpr int kTileM = 64;    // rows of an output tile: one warpgroup's wgmma M
constexpr int kTileN = 256;   // columns of an output tile: wgmma N
constexpr int kStageK = 128;  // bytes of K per stage: one 128-byte swizzle row (K8: 64)
constexpr int kRing = 4;
constexpr int kWgThreads = 384;  // two consumer warpgroups + the producer's
constexpr int kSliceN = 64;            // accumulator columns staged at a time
constexpr int kSlices = kTileN / kSliceN;
constexpr int kSliceLd = kSliceN + 8;  // staging row of int32, padded against bank conflicts
constexpr int kSliceWords = 16 * kSliceLd;  // a warp's 16 rows of one slice
constexpr uint32_t kSpinLimit = 1u << 24;  // a wait that never ends traps

// Timing-only variants of the residual product (kWgRes), which
// experiments/kernel_ab.py builds into a library of its own with
// -DCVT_GEMM_PROBE=1 or 2 to see what bounds the main loop; the port's library
// is never built with them. 1: the weight tile is loaded into each ring stage
// once, by the block's first kRing steps, and never again (the products read
// stale weights: no weight bytes from L2 after the first tile). 2: the
// epilogue neither loads the residual nor stores x' (its arithmetic stays).
// 1 and 2 send K9 and K10 to the two-launch route (int8_matmul.cu), whose
// split kernel they time. 3 keeps K9 on its cluster route and skips the
// LayerNorm's rows (its barriers stay): what the fold costs.
#ifndef CVT_GEMM_PROBE
#define CVT_GEMM_PROBE 0
#endif
constexpr int kProbe = CVT_GEMM_PROBE;

enum WgEpilogue : int {
  kWgBias = 0,       // out = bf16(y)
  kWgRes = 1,        // out = bf16(res + y)
  kWgGeluQuant = 2,  // yq, ys = rowquant(gelu(y)), the row maxima through amax
};

// Shared memory by epilogue. Bias and residual: a ring of 4 stages, and per
// consumer warp one slice of staging. K8 keeps a warp's whole tile of gelu(y)
// (4 slices of f32) from the pass that takes the row maxima to the pass that
// quantizes, and pays for the room with stages of 64 bytes of K (64-byte
// swizzle) instead of 128: half the bytes in flight; its products have the
// other warpgroup's GELU arithmetic to hide under.
__host__ __device__ constexpr int stage_k(int epi) { return epi == kWgGeluQuant ? 64 : kStageK; }
__host__ __device__ constexpr int ring_stage_bytes(int epi) {
  return (kTileM + kTileN) * stage_k(epi);
}
__host__ __device__ constexpr int warp_stage_bytes(int epi) {
  return (epi == kWgGeluQuant ? kSlices : 1) * kSliceWords * 4 + 32 * 4;  // + 2 values per row
}
__host__ __device__ constexpr int wg_smem_bytes(int epi) {
  return kRing * ring_stage_bytes(epi) + 8 * warp_stage_bytes(epi) +
         1024;  // + alignment slack
}
static_assert(wg_smem_bytes(kWgGeluQuant) + 64 <= 232448, "a block's shared memory");

struct WgArgs {
  const float* xs;            // (m,)
  const float* ws;            // (o,)
  const float* bias;          // (o,)
  const __nv_bfloat16* res;   // (m, o), kWgRes
  __nv_bfloat16* out;         // (m, o), kWgBias and kWgRes
  float* amax;                // (m,), zeroed: the rows' max |gelu(y)|, kWgGeluQuant
  unsigned int* arrived;      // (panels,), zeroed: warps done with a panel's maxima
  int8_t* yq;                 // (m, o), kWgGeluQuant
  float* ys;                  // (m,), kWgGeluQuant
  long long m;
  int k;
  int o;
  int gelu;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the swizzled layout of
// RowBytes (128 or 64) bytes of K a row, 8-row groups 8 * RowBytes apart, at a
// stage aligned to that plus a whole number of 32-byte K slices.
template <int RowBytes>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  static_assert(RowBytes == 128 || RowBytes == 64, "128- or 64-byte swizzle");
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * RowBytes >> 4) << 32) | ((RowBytes == 128 ? 1ull : 2ull) << 62);
}

// D (64 x 256, s32, 128 registers a thread) (+)= A (64 x 32 s8, K-major) * B (256 x 32 s8, K-major)^T,
// both read from shared memory through their descriptors; `accumulate` == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Accumulator columns [Slice * kSliceN, + kSliceN) of the warp's 16 rows into its
// staging tile: a thread holds rows (g, g + 8) and columns (2t, 2t + 1) of
// each column group of 8.
template <int Slice>
__device__ __forceinline__ void stage_slice(const int (&acc)[128], int* stage, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kSliceN / 8; ++j) {
    const int nb = Slice * (kSliceN / 8) + j;
    *reinterpret_cast<int2*>(stage + g * kSliceLd + j * 8 + t * 2) =
        make_int2(acc[nb * 4], acc[nb * 4 + 1]);
    *reinterpret_cast<int2*>(stage + (g + 8) * kSliceLd + j * 8 + t * 2) =
        make_int2(acc[nb * 4 + 2], acc[nb * 4 + 3]);
  }
}

constexpr int kLanesPerRow = kSliceN / 4;          // a lane owns 4 adjacent columns
constexpr int kRowsPerIter = 32 / kLanesPerRow;
constexpr int kSliceIters = 16 / kRowsPerIter;

// The residual values a lane needs for one slice (columns c0 .. c0 + 63) of
// its warp's 16 rows.
__device__ __forceinline__ void load_residual(uint2 (&dst)[kSliceIters], const WgArgs& p,
                                              long long m0, int c0, int lane) {
  const int col = c0 + (lane % kLanesPerRow) * 4;
#pragma unroll
  for (int it = 0; it < kSliceIters; ++it) {
    if (kProbe == 2) {
      dst[it] = make_uint2(0u, 0u);
      continue;
    }
    const long long row = m0 + it * kRowsPerIter + lane / kLanesPerRow;
    // where the tile reaches past the matrix any valid address will do: the
    // value is not stored. volatile: the load is issued here, a slice ahead
    // of its use, and not moved down to it.
    const __nv_bfloat16* src = col < p.o && row < p.m ? p.res + row * p.o + col : p.res;
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(dst[it].x), "=r"(dst[it].y)
                 : "l"(src));
  }
}

// Before a tile's main loop, per row of the warp: xs into rowv; the first
// slice's residual into registers. Their latency passes under the products.
template <int Epi>
__device__ __forceinline__ void tile_prologue(const WgArgs& p, long long m0, int n0, int lane,
                                              float* rowv, uint2 (&res)[kSliceIters]) {
  __syncwarp();  // the tile before is done with rowv
  if (lane < 16) {
    const long long row = m0 + lane;
    const bool ok = row < p.m;
    rowv[lane] = ok ? __ldg(p.xs + row) : 0.f;
  }
  if (Epi == kWgRes) load_residual(res, p, m0, n0, lane);
  __syncwarp();
}

// Slice sl (columns c0 .. c0 + 63) of the warp's accumulators through `slice`
// into y = ((acc * xs) * ws) + bias of the lane's 4 columns (from c0 + sub * 4)
// of 8 rows; returns whether those columns lie inside the matrix (o % 8 == 0:
// all four or none; past o, y = 0). `staged` runs once the slice is staged,
// before it is read: the place to issue loads whose latency should pass under
// the arithmetic. The caller syncs the warp before `slice` is written again.
template <typename Staged>
__device__ __forceinline__ bool slice_values(const WgArgs& p, const int (&acc)[128], int sl,
                                             int* slice, const float* rowv, int c0, int lane,
                                             float (&y)[kSliceIters][4], Staged&& staged) {
  switch (sl) {
    case 0: stage_slice<0>(acc, slice, lane); break;
    case 1: stage_slice<1>(acc, slice, lane); break;
    case 2: stage_slice<2>(acc, slice, lane); break;
    default: stage_slice<3>(acc, slice, lane); break;
  }
  __syncwarp();
  staged();
  const int sub = lane % kLanesPerRow;
  const int r0 = lane / kLanesPerRow;
  const int col = c0 + sub * 4;
  const bool col_ok = col < p.o;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 w4 = col_ok ? __ldg(reinterpret_cast<const float4*>(p.ws + col)) : zero4;
  const float4 b4 = col_ok ? __ldg(reinterpret_cast<const float4*>(p.bias + col)) : zero4;
  const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
  const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int it = 0; it < kSliceIters; ++it) {
    const int r = r0 + it * kRowsPerIter;
    const int4 a4 = *reinterpret_cast<const int4*>(slice + r * kSliceLd + sub * 4);
    const int a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float xs = rowv[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[it][e] = __fadd_rn(__fmul_rn(__fmul_rn((float)a[e], xs), ws[e]), bs[e]);
    }
  }
  return col_ok;
}

// The epilogue of one 64 x 256 tile, by each consumer warp for its 16 rows.
// The accumulators pass through the warp's staging tile in shared memory 64
// columns at a time, so that the arithmetic is a loop over the four slices
// (unrolled over all 128 accumulators it outgrows the instruction cache) in
// which a lane owns 4 adjacent columns of 8 rows: 8-byte bf16 and 4-byte int8
// stores, half a warp writing one row's 64 columns. A slice's 32 values per
// lane are one straight-line block, loads first and stores last, so that
// their dependent chains interleave: in the ping-pong schedule one warp per
// scheduler runs the epilogue, and nothing else hides its latencies. The
// residual of the next slice is loaded while this one is computed.
template <int Epi>
__device__ __forceinline__ void tile_epilogue(const WgArgs& p, const int (&acc)[128],
                                              long long m0, int n0, int lane, int* stage,
                                              const float* rowv, uint2 (&res)[kSliceIters]) {
  const int sub = lane % kLanesPerRow;
  const int r0 = lane / kLanesPerRow;  // the lane's rows: r0 + it * kRowsPerIter
#pragma unroll 1
  for (int sl = 0; sl < kSlices; ++sl) {
    const int c0 = n0 + sl * kSliceN;
    if (c0 >= p.o) break;
    uint2 res_next[kSliceIters];
    const int col = c0 + sub * 4;
    float y[kSliceIters][4];
    const bool col_ok = slice_values(p, acc, sl, stage, rowv, c0, lane, y, [&] {
      if (Epi == kWgRes) load_residual(res_next, p, m0, c0 + kSliceN, lane);
    });
    __syncwarp();  // the slice is read to its end before the next overwrites it
    uint2 out[kSliceIters];
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {
      if (Epi == kWgRes) {
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[it].x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[it].y));
        y[it][0] = __fadd_rn(lo.x, y[it][0]);
        y[it][1] = __fadd_rn(lo.y, y[it][1]);
        y[it][2] = __fadd_rn(hi.x, y[it][2]);
        y[it][3] = __fadd_rn(hi.y, y[it][3]);
        res[it] = res_next[it];
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[it][0], y[it][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[it][2], y[it][3]);
      out[it] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                           *reinterpret_cast<const uint32_t*>(&hi));
    }
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {
      const long long row = m0 + r0 + it * kRowsPerIter;
      // probe 2 stores only a value no tile holds (a NaN), so that the
      // arithmetic stays
      const bool keep = kProbe == 2 && Epi == kWgRes ? out[it].x == 0x7FC17FC1u
                                                     : col_ok && row < p.m;
      if (keep) *reinterpret_cast<uint2*>(p.out + row * p.o + col) = out[it];
    }
  }
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K8's epilogue of one 64 x 256 tile, by each consumer warp for its 16 rows:
// yq, ys = rowquant(gelu(y)) with the abs-max taken over the whole output row,
// of which this tile holds 256 columns. The tiles of one 64-row panel are
// computed at the same time by blocks on different SMs (the launch is
// cooperative, so all blocks are resident). Pass 1 stages the accumulators as
// the other epilogues do, a slice at a time into the slice's own part of the
// warp's tile, computes gelu(y) once and writes it back over the staged
// integers as f32; the lane's row maxima of |gelu(y)| go into amax with
// atomicMax on the bit pattern (non-negative floats order as their bits:
// exact in any order, so deterministic). The warp then counts itself in
// arrived[panel], waits until all `expected` warps of the panel have, reads
// its rows' maxima back, and pass 2 quantizes the f32 values in shared memory
// with rowquant.cuh's formula. The other warpgroup's products run under all
// of it, the wait included.
template <int Gelu>
__device__ __forceinline__ void tile_epilogue_gelu_quant(const WgArgs& p, const int (&acc)[128],
                                                         long long m0, int n0, int lane,
                                                         int* stage, const float* rowv,
                                                         unsigned int* arrived,
                                                         unsigned int expected) {
  const int sub = lane % kLanesPerRow;
  const int r0 = lane / kLanesPerRow;  // the lane's rows: r0 + it * kRowsPerIter
  float vmax[kSliceIters];             // max |gelu(y)| of the lane's columns, by row
#pragma unroll
  for (int it = 0; it < kSliceIters; ++it) vmax[it] = 0.f;
#pragma unroll 1
  for (int sl = 0; sl < kSlices; ++sl) {
    const int c0 = n0 + sl * kSliceN;
    if (c0 >= p.o) break;
    int* slice = stage + sl * kSliceWords;
    float y[kSliceIters][4];
    slice_values(p, acc, sl, slice, rowv, c0, lane, y, [] {});
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {
      // a lane past o holds y = 0: gelu(0) = 0
      if constexpr (Gelu == kGeluBf16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[it][e] = gelu_bf16(y[it][e], p.gelu - kGeluBf16);
      } else {
        gelu4<Gelu>(y[it]);
      }
      vmax[it] = fmaxf(fmaxf(vmax[it], fmaxf(fabsf(y[it][0]), fabsf(y[it][1]))),
                       fmaxf(fabsf(y[it][2]), fabsf(y[it][3])));
    }
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {  // a lane reads back only what it wrote
      const int r = r0 + it * kRowsPerIter;
      *reinterpret_cast<float4*>(slice + r * kSliceLd + sub * 4) =
          make_float4(y[it][0], y[it][1], y[it][2], y[it][3]);
    }
  }
#pragma unroll
  for (int it = 0; it < kSliceIters; ++it) {
    float v = vmax[it];
#pragma unroll
    for (int d = kLanesPerRow / 2; d > 0; d >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
    }
    if constexpr (Gelu == kGeluBf16) v = bf16_round(v);  // the amax in bf16
    const long long row = m0 + r0 + it * kRowsPerIter;
    // a row past m holds gelu(bias): not a value of the matrix
    if (sub == 0 && row < p.m) {
      atomicMax(reinterpret_cast<unsigned int*>(p.amax + row), __float_as_uint(v));
    }
  }
  __syncwarp();
  if (lane == 0) {
    // release: the fence orders the warp's maxima (before it through the
    // warp barrier) before the count; acquire: the last poll, and the warp
    // barrier after it, order every lane's reads of amax after the counts
    __threadfence();
    atomicAdd(arrived, 1u);
    for (uint32_t spins = 0; ld_acquire(arrived) < expected; ++spins) {
      if (spins > kSpinLimit) __trap();
      __nanosleep(32);
    }
  }
  __syncwarp();
  float inv[kSliceIters];
#pragma unroll
  for (int it = 0; it < kSliceIters; ++it) {
    const long long row = m0 + r0 + it * kRowsPerIter;
    const float amax = fmaxf(row < p.m ? __ldcg(p.amax + row) : 0.f, 1e-8f);
    inv[it] = __fdiv_rn(127.f, amax);
    if (n0 == 0 && sub == 0 && row < p.m) p.ys[row] = __fmul_rn(amax, kInv127);
  }
#pragma unroll 1
  for (int sl = 0; sl < kSlices; ++sl) {
    const int col = n0 + sl * kSliceN + sub * 4;
    if (n0 + sl * kSliceN >= p.o) break;
    const int* slice = stage + sl * kSliceWords;
    uint32_t q[kSliceIters];
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {
      const float4 v =
          *reinterpret_cast<const float4*>(slice + (r0 + it * kRowsPerIter) * kSliceLd + sub * 4);
      q[it] = quant1_byte(v.x, inv[it]) | quant1_byte(v.y, inv[it]) << 8 |
              quant1_byte(v.z, inv[it]) << 16 | quant1_byte(v.w, inv[it]) << 24;
    }
#pragma unroll
    for (int it = 0; it < kSliceIters; ++it) {
      const long long row = m0 + r0 + it * kRowsPerIter;
      if (col < p.o && row < p.m) *reinterpret_cast<uint32_t*>(p.yq + row * p.o + col) = q[it];
    }
  }
  __syncwarp();  // the tile is read to its end before the next is staged
}

// The output tiles one block walks, in its order. Bias and residual: tile
// blockIdx.x + i * gridDim.x of the row-major tile grid (column tiles fastest,
// so blocks at work at one time share their rows of xq in L2). K8: the grid is
// groups of tiles_n blocks; a group takes 64-row panels group, group + groups,
// ... and its block of rank r column tile r of each, so that the tiles of a
// panel are computed at the same time and can exchange their row maxima.
struct TileWalk {
  long long count;   // tiles of this block
  long long first;   // its first tile (row tile for K8)
  long long stride;
  int tiles_n;
  int rank;          // K8: the block's column tile; else -1
  __device__ long long row_tile(long long i) const {
    const long long t = first + i * stride;
    return rank < 0 ? t / tiles_n : t;
  }
  __device__ int col_tile(long long i) const {
    return rank < 0 ? (int)((first + i * stride) % tiles_n) : rank;
  }
};

template <int Epi>
__device__ __forceinline__ TileWalk tile_walk(const WgArgs& p) {
  TileWalk w;
  w.tiles_n = (p.o + kTileN - 1) / kTileN;
  const long long panels = (p.m + kTileM - 1) / kTileM;
  if (Epi == kWgGeluQuant) {
    w.rank = blockIdx.x % w.tiles_n;
    w.first = blockIdx.x / w.tiles_n;
    w.stride = gridDim.x / w.tiles_n;
    // blocks past the last whole group (a grid that is not a multiple of
    // tiles_n, as the whole-block kernel's) take no tile
    const bool grouped = blockIdx.x < w.stride * w.tiles_n;
    w.count = grouped && w.first < panels ? (panels - w.first + w.stride - 1) / w.stride : 0;
  } else {
    w.rank = -1;
    w.first = blockIdx.x;
    w.stride = gridDim.x;
    const long long tiles = panels * w.tiles_n;
    w.count = w.first < tiles ? (tiles - w.first + w.stride - 1) / w.stride : 0;
  }
  return w;
}

// The ring of one block: its shared memory, its barriers, and the ring steps
// the block has taken so far. A kernel that runs several products one after
// another (fused_block.cu) carries `step` on from one to the next, so that
// every mbarrier's phase parity stays in step with the count of its uses and
// the barriers are initialized once.
struct GemmRing {
  uint8_t* raw;     // the block's dynamic shared memory
  uint32_t ring;    // its shared address, rounded up to 1024 bytes
  uint32_t full0;   // kRing full barriers, 8 bytes apart
  uint32_t empty0;  // kRing empty barriers
  uint32_t step;
};

// Called by every thread of the block; __syncthreads() follows before the
// first product.
__device__ __forceinline__ GemmRing ring_init(uint8_t* raw, uint64_t* full_bar,
                                              uint64_t* empty_bar) {
  const GemmRing r{raw, (smem_addr(raw) + 1023u) & ~1023u, smem_addr(full_bar),
                   smem_addr(empty_bar), 0u};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(r.full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(r.empty0 + 8 * s, 4);  // one lane of each warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return r;
}

// Registers a thread of a kWgThreads block holds at launch (one block per
// SM: 65,536 / 384, rounded down to a multiple of 8), and the producer
// warpgroup's and the consumers' counts once they have split (setmaxnreg).
// ptxas allots registers by these counts only where the two roles split once
// and never join again: with the split undone after each product and redone
// before the next (fused_block.cu, as first built) it kept the consumers at
// 168 registers, spilled and serialized the wgmma.
constexpr int kRegsLaunch = 168;
constexpr int kRegsProducer = 40;
constexpr int kRegsConsumer = 232;
static_assert(kRegsProducer * 128 + kRegsConsumer * 256 <= kRegsLaunch * kWgThreads,
              "the consumers take what the producer gives away");

// Ring steps a tile of a product takes (bytes of K per stage(Epi)).
template <int Epi>
__device__ __forceinline__ int product_ksteps(const WgArgs& p) {
  return (p.k + stage_k(Epi) - 1) / stage_k(Epi);
}

// The producer's half of one product y = xq @ w^T with epilogue Epi over the
// tiles of `walk` (tile_walk<Epi>), ksteps ring steps a tile: called by the
// producer warpgroup (2) after its setmaxnreg; one thread keeps the TMA ring
// full. map_a and map_b are the tensor maps of xq (m, k) and w (o, k), boxes
// of kTileM and kTileN rows by stage_k(Epi) bytes of K. Advances r.step past
// the product.
template <int Epi>
__device__ __forceinline__ void wgmma_produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                              const TileWalk& walk, int ksteps, GemmRing& r) {
  constexpr int kStage = stage_k(Epi);  // bytes of K per stage
  constexpr int kABytes = kTileM * kStage;
  constexpr int kRingStageBytes = ring_stage_bytes(Epi);
  if (threadIdx.x == 256) {
    uint32_t step = r.step;
    for (long long i = 0; i < walk.count; ++i) {
      const int m0 = (int)walk.row_tile(i) * kTileM;
      const int n0 = walk.col_tile(i) * kTileN;
      for (int ks = 0; ks < ksteps; ++ks, ++step) {
        const uint32_t stage = step % kRing;
        const uint32_t round = (step / kRing) & 1u;
        mbar_wait(r.empty0 + 8 * stage, round ^ 1u);  // passes at once in round 0
        const bool load_b = kProbe != 1 || Epi != kWgRes || step < (uint32_t)kRing;
        mbar_expect_tx(r.full0 + 8 * stage, load_b ? kRingStageBytes : kABytes);
        const uint32_t dst = r.ring + stage * kRingStageBytes;
        tma_load_2d(dst, map_a, r.full0 + 8 * stage, ks * kStage, m0);
        if (load_b) tma_load_2d(dst + kABytes, map_b, r.full0 + 8 * stage, ks * kStage, n0);
      }
    }
  }
  r.step += (uint32_t)(walk.count * ksteps);
}

// One warpgroup's products of one 64 x 256 tile into acc: ksteps ring steps
// from `step` on, out of a ring of kStages stages of kStage bytes of K (A
// first, then B) at shared address `ring`, each waited for on its full
// barrier (full0 + 8 * stage). release(stage) runs once a stage is read to
// its end (by every thread of the warpgroup; the caller picks who arrives).
template <int kStage, int kStages, typename Release>
__device__ __forceinline__ void tile_products(int (&acc)[128], uint32_t ring, uint32_t full0,
                                              uint32_t step, int ksteps, Release&& release) {
  constexpr int kABytes = kTileM * kStage;
  constexpr int kStageBytes = (kTileM + kTileN) * kStage;
  for (int ks = 0; ks < ksteps; ++ks, ++step) {
    const uint32_t stage = step % kStages;
    mbar_wait(full0 + 8 * stage, (step / kStages) & 1u);
    const uint64_t da = smem_desc<kStage>(ring + stage * kStageBytes);
    const uint64_t db = smem_desc<kStage>(ring + stage * kStageBytes + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStage / 32; ++kk) {
      // 32 bytes of K further: 2 in the descriptor's 16-byte units
      wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
    }
    wgmma_commit();
    if (ks > 0) {
      wgmma_wait<1>();  // the stage before is read to its end
      release((step - 1) % kStages);
    }
  }
  wgmma_wait<0>();
  release((step - 1) % kStages);
}

// The consumers' half: called by warpgroups 0 and 1 after their setmaxnreg;
// they take the block's tiles in turns, each tile's products by
// tile_products, its epilogue from the staged accumulators: bf16(y) for
// qkv, x' with the residual loaded from device memory a slice ahead (K10 on
// the two-launch route and in K14), K8's row-maxima exchange. K9 and, off
// the two-launch route, K10 run int8_matmul.cu's residual kernel instead,
// whose epilogue takes the residual and leaves x' by TMA and whose K9 folds
// the LayerNorm in through a cluster. Gelu: the fc1 epilogue's GELU, or
// kGeluAny to take it from p.gelu. kDrain: the kernel runs another product
// after this one (fused_block.cu), so the one barrier arrival the ping-pong
// leaves over is taken and named barriers 1 and 2 end complete. Advances
// r.step past the product.
template <int Epi, int Gelu, bool kDrain>
__device__ __forceinline__ void wgmma_consume(const WgArgs& p, const TileWalk& walk, int ksteps,
                                              GemmRing& r) {
  constexpr int kStage = stage_k(Epi);  // bytes of K per stage
  constexpr int kRingStageBytes = ring_stage_bytes(Epi);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* mine = r.raw + (r.ring - smem_addr(r.raw)) + kRing * kRingStageBytes +
                  (wg * 4 + warp) * warp_stage_bytes(Epi);
  int* stage = reinterpret_cast<int*>(mine);
  float* rowv = reinterpret_cast<float*>(mine + warp_stage_bytes(Epi) - 32 * 4);
  // named barrier 1 + w: warpgroup w may run its main loop
  if (wg == 1) named_bar_arrive(1, 256);
  int acc[128];
  for (long long i = wg; i < walk.count; i += 2) {  // the block's tiles in turns
    const long long m0 = walk.row_tile(i) * kTileM;
    const int n0 = walk.col_tile(i) * kTileN;
    uint32_t step = r.step + (uint32_t)(i * ksteps);
    uint2 res[kSliceIters];
    tile_prologue<Epi>(p, m0 + warp * 16, n0, lane, rowv, res);
    named_bar_sync(1 + wg, 256);
    tile_products<kStage, kRing>(acc, r.ring, r.full0, step, ksteps, [&](uint32_t stage) {
      if (lane == 0) mbar_arrive(r.empty0 + 8 * stage);
    });
    named_bar_arrive(1 + (wg ^ 1), 256);
    if constexpr (Epi == kWgGeluQuant) {
      unsigned int* arrived = p.arrived + walk.row_tile(i);
      const unsigned int expected = 4u * walk.tiles_n;
      if constexpr (Gelu != kGeluAny) {
        tile_epilogue_gelu_quant<Gelu>(p, acc, m0 + warp * 16, n0, lane, stage, rowv,
                                       arrived, expected);
      } else if (p.gelu == kGeluSigmoid) {
        tile_epilogue_gelu_quant<kGeluSigmoid>(p, acc, m0 + warp * 16, n0, lane, stage, rowv,
                                               arrived, expected);
      } else if (p.gelu == kGeluHard) {
        tile_epilogue_gelu_quant<kGeluHard>(p, acc, m0 + warp * 16, n0, lane, stage, rowv,
                                            arrived, expected);
      } else {
        tile_epilogue_gelu_quant<kGeluErf>(p, acc, m0 + warp * 16, n0, lane, stage, rowv,
                                           arrived, expected);
      }
    } else {
      tile_epilogue<Epi>(p, acc, m0 + warp * 16, n0, lane, stage, rowv, res);
    }
  }
  // warpgroup (count % 2), whose turn the next tile would have been, takes
  // the arrival left over
  if (kDrain && wg == (int)(walk.count % 2)) named_bar_sync(1 + wg, 256);
  r.step += (uint32_t)(walk.count * ksteps);
}

// One product by all kWgThreads threads of a block, which then ends
// (int8_matmul.cu): warpgroup 2 gives registers away and produces, warpgroups
// 0 and 1 take them and consume.
template <int Epi, int Gelu>
__device__ __forceinline__ void wgmma_product(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                              const WgArgs& p, GemmRing& r) {
  // the walk before the split: computed after it, it cost the residual
  // epilogue 10% (more registers live in the consumers' loop)
  const int ksteps = product_ksteps<Epi>(p);
  const TileWalk walk = tile_walk<Epi>(p);
  if (threadIdx.x / 128 == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    wgmma_produce<Epi>(map_a, map_b, walk, ksteps, r);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));
    wgmma_consume<Epi, Gelu, false>(p, walk, ksteps, r);
  }
}


// Host side: tensor maps, encoded by cuTensorMapEncodeTiled (libcuda),
// reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) sym = nullptr;
    return reinterpret_cast<EncodeTiled>(sym);
  }();
  return fn;
}

// Tensor map of an int8 (rows, k) matrix, K contiguous, read in boxes of
// `box_rows` rows x `box_k` (128 or 64) bytes of K into the swizzled layout of
// that row length; what a box reaches past the matrix reads as zeros.
inline bool make_map(CUtensorMap* map, const void* base, long long rows, int k, int box_rows,
                     int box_k) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_k == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a bf16 (rows, cols) matrix, row-major (cols * 2 a multiple
// of 16 bytes), read and written in boxes of box_rows rows x 64 columns laid
// out in shared memory as 128-byte rows in the 128-byte swizzle (16-byte
// chunk k of row r at chunk k ^ (r % 8); the box 1024-byte aligned); what a
// box reaches past the matrix reads as zeros and is not written.
inline bool make_map_bf16(CUtensorMap* map, const void* base, long long rows, int cols,
                          int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cvt
