// Device code of the any-head-dim attention kernels (attention_any.cu, K2;
// attention_any_bwd.cu, K3): the plan's constants, the copies into shared
// memory, the products and the softmax arithmetic that both share. What the
// kernels compute, their design and their numbers are in attention_any.cu's
// header.
//
// Products. A warp computes 16 rows by 8 NB columns in the C layout of
// mma.sync m16n8k16: lane (g = lane / 4, t = lane % 4) holds acc[j][e], row
// g + 8 (e / 2), column 8 j + 2 t + e % 2. In bf16 they run on the tensor
// cores (mma.sync, operands by ldmatrix / ldmatrix.trans from rows padded by
// 16 bytes); in f32 they are FFMA in full f32 over the same layout, each sum
// taken in the order of its depth, operands read as 16-byte (A) and 8- or
// 16-byte (B) vectors. Three forms:
//   dot       acc += A B^T, A and B both row-major over the depth (S = Q K^T,
//             dP = g V^T, S^T = K Q^T, dP^T = V g^T);
//   outer_rm  acc += A B, A row-major over the depth, B (depth, columns)
//             row-major (P V in f32, dV = pn^T g, dK = dS^T Q);
//   outer_tm  the same with A stored transposed, (depth, rows) (dQ = dS K
//             from the key-major dS^T).
// Columns (or keys) of a product that lie wholly past what the call needs are
// skipped in steps of 16 (bf16) or 8 (f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_f32.cuh"  // cluster_ptr, cluster_sync, cluster_config, cluster_fits, cta_keys, RowShare

namespace cvt_any {

using bf16 = __nv_bfloat16;

constexpr int kMaxCols = 256;      // output columns a CTA: a chunk of the head dim
constexpr int kFwdWarps = 4;       // the forward's warps a CTA, at most: 64 query rows
constexpr int kBwdWarps = 8;       // the backward's, at most
constexpr int kMaxCtas = 16;       // a backward cluster's CTAs, at most (above 8 non-portable)
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a Hopper block may have

// The output columns a CTA keeps at head dim dh (the accumulators' width, a
// template argument): 16, 32, 64, 128 or 256, the smallest that holds it,
// else 256 in any_chunks(dh) chunks. The columns past dh are zero in shared
// memory and never stored.
__host__ __device__ constexpr int any_cols(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : kMaxCols;
}
__host__ __device__ constexpr int any_chunks(int dh) { return (dh + kMaxCols - 1) / kMaxCols; }
// The score products' depth: the head dim padded with zeros to a multiple of 16.
__host__ __device__ constexpr int any_depth(int dh) { return (dh + 15) / 16 * 16; }
// The depth columns a tile holds: all of them up to 256; above, a window of
// 256 at a time (the kernels' kDeep form), S and dP summed over the windows
// in order.
__host__ __device__ constexpr int any_window(int depth) { return depth < kMaxCols ? depth : kMaxCols; }
// Padding of a shared-memory row: 16 bytes, so that the eight rows of an
// ldmatrix (or a quarter warp's 16-byte reads) fall in distinct banks.
__host__ __device__ constexpr int row_pad(int es) { return 16 / es; }

// The forward's keys a ring stage, the online max's step, by element size
// and output columns: the stage's scores stay in registers beside the
// output's, and two stages fit beside the Q rows.
__host__ __device__ constexpr int fwd_keys(int es, int dp) {
  return es == 2 ? (dp <= 128 ? 64 : 32) : (dp <= 64 ? 64 : dp == 128 ? 32 : 16);
}

// Dynamic shared memory of a forward CTA (kFwdWarps warps): its query rows,
// the ring's stages of K and V (two over the whole depth; one stage of a
// window of K above a depth of 256, where Q and K come a window at a time),
// and in f32 each warp's P tile (16 rows of fwd_keys + 4 floats).
__host__ __device__ constexpr int fwd_smem_bytes(int es, int dp, int depth) {
  return es * (16 * kFwdWarps * (any_window(depth) + row_pad(es)) +
               (depth > kMaxCols ? 1 : 2) * fwd_keys(es, dp) *
                   (any_window(depth) + (dp < depth ? dp : depth) + 2 * row_pad(es))) +
         (es == 4 ? 4 * kFwdWarps * 16 * (fwd_keys(es, dp) + 4) : 0);
}

// The backward's query rows a tile (more at narrow heads, where a tile's
// barriers and exchanges would cost more than its products), and the keys a
// CTA holds at most: the dK / dV sums of its keys by the chunk's columns
// stay in registers (64 KB of f32 each at most).
__host__ __device__ constexpr int bwd_rows(int es, int dp) {
  return es == 4 ? (dp <= 64 ? 64 : 16) : dp <= 16 ? 128 : dp <= 64 ? 64 : 32;
}
__host__ __device__ constexpr int bwd_max_keys(int dp) { return dp >= 256 ? 64 : 128; }
// dK / dV columns a warp, and dQ columns a unit of the dQ product
__host__ __device__ constexpr int bwd_warp_cols(int dp) { return dp < 128 ? dp : 128; }
__host__ __device__ constexpr int bwd_dq_cols(int dp) { return dp < 64 ? dp : 64; }

// Dynamic shared memory of a backward CTA holding `keys` keys: K and V of its
// keys, the tile's Q and g rows (any_window columns), pn^T and dS^T
// (key-major), `bufs` sets of the dQ slices it receives (f32, at most
// bwd_rows + kMaxCtas rows of dp + 4) and of the CTA's row statistics (a
// float4 a row), its key blocks' statistics (3 x keys / 16 x rows) and the
// head's (3 x rows); above a depth of 256, each 16 x 16 unit's S^T and dP^T
// summed over the windows (16 floats a lane). 163,968 bytes in bf16 at 256
// columns and 64 keys with one set, 214,400 with two (one CTA an SM);
// 211,136 in f32 (16-row tiles, one set).
__host__ __device__ constexpr int bwd_smem_bytes(int es, int dp, int depth, int keys, int bufs) {
  return es * (2 * keys * (any_window(depth) + row_pad(es)) +
               2 * bwd_rows(es, dp) * (any_window(depth) + row_pad(es)) +
               2 * keys * (bwd_rows(es, dp) + row_pad(es))) +
         4 * (bufs * (bwd_rows(es, dp) + kMaxCtas) * (dp + 4) + 4 * bufs * bwd_rows(es, dp) +
              3 * (keys / 16) * bwd_rows(es, dp) + 3 * bwd_rows(es, dp) +
              (depth > kMaxCols ? 16 * 32 * (keys / 16) * (bwd_rows(es, dp) / 16) : 0));
}
// CTAs an SM's shared memory holds (228 KB, 1 KB of it reserved a CTA)
__host__ __device__ constexpr int smem_ctas(int bytes) { return 233472 / (bytes + 1024); }
// The backward kernel's CTAs an SM to hold registers for (128 a thread for
// two): two where two CTAs of up to 96 keys fit in shared memory and 128
// registers hold the sums without spilling (bf16 up to 32 columns, f32 at
// 16: 64 heads of 12 at 257 tokens), else one with up to 255 registers.
__host__ __device__ constexpr int bwd_min_ctas(int es, int dp) {
  return dp <= (es == 2 ? 32 : 16) ? 2 : 1;
}
// The sets of dQ slices and row statistics a backward CTA keeps: two where
// they fit without a CTA fewer an SM, else one (a second cluster barrier a
// tile).
__host__ __device__ constexpr int bwd_bufs(int es, int dp, int depth, int keys) {
  return bwd_smem_bytes(es, dp, depth, keys, 2) <= kSmemLimit &&
                 smem_ctas(bwd_smem_bytes(es, dp, depth, keys, 2)) >=
                     smem_ctas(bwd_smem_bytes(es, dp, depth, keys, 1))
             ? 2
             : 1;
}

static_assert(bwd_smem_bytes(2, 256, 256, 64, 1) == 163968 &&
                  bwd_smem_bytes(2, 256, 256, 64, 2) == 214400 &&
                  bwd_smem_bytes(4, 256, 256, 64, 1) == 211136,
              "the figures of bwd_smem_bytes' comment");
static_assert(bwd_bufs(2, 256, 256, 64) == 2 && bwd_bufs(4, 256, 256, 64) == 1 &&
                  bwd_bufs(4, 16, 16, 128) == 1,
              "two sets in bf16 at 256 columns; one in f32, and at 16 columns, where two "
              "would leave one CTA an SM");
// Every head dim's CTA fits a block's shared memory: a forward CTA of
// kFwdWarps warps and a backward CTA of bwd_max_keys keys at each width, the
// windowed form (any depth above 256) included.
__host__ __device__ constexpr bool every_plan_fits(int es) {
  for (int dp = 16; dp <= kMaxCols; dp *= 2) {
    if (fwd_smem_bytes(es, dp, dp) > kSmemLimit ||
        bwd_smem_bytes(es, dp, dp, bwd_max_keys(dp), 1) > kSmemLimit) {
      return false;
    }
  }
  return fwd_smem_bytes(es, kMaxCols, kMaxCols + 16) <= kSmemLimit &&
         bwd_smem_bytes(es, kMaxCols, kMaxCols + 16, bwd_max_keys(kMaxCols), 1) <= kSmemLimit;
}
static_assert(every_plan_fits(2) && every_plan_fits(4), "a CTA's shared memory exceeds the block limit");

// Timing-only builds (experiments/kernel_ab.py --sections anyprobes) define
// CVT_ANY_PROBE to take one part out of the kernels; their outputs are
// wrong. kNoScores: the forward's S product, the backward's first pass
// (products and statistics); kNoValues: P V, the backward's second pass;
// kNoCopies: every ring stage or tile copy after the first; kNoOuter: dV and
// dK; kNoDq: the dQ partial's product and its stores; kNoExchange: the
// cluster barriers (a CTA barrier instead) and remote accesses (the CTA's
// own shared memory instead); kNoReduce: the dQ slices' sum and its stores.
#ifndef CVT_ANY_PROBE
#define CVT_ANY_PROBE 0
#endif
enum AnyProbe { kNoProbe, kNoScores, kNoValues, kNoCopies, kNoOuter, kNoDq, kNoExchange, kNoReduce };
__host__ __device__ constexpr bool probe(AnyProbe p) { return CVT_ANY_PROBE == p; }

// What every kernel of a call shares.
struct Call {
  const void* qkv;
  const void* grad;
  void* out;      // the forward's output or the backward's dqkv
  float* stats;   // a split backward's row statistics (B, H chunks, clusters, 3, N)
  float* parts;   // and its dQ partials (B, H, clusters, N, Dh)
  int n, heads, dh, depth, chunks;
  int wbytes;     // bytes a copy moves: 16, 8, 4 (cp.async) or 2 (bf16 elements)
  int keys;       // the backward: keys a CTA holds at most (a multiple of 16)
  int bufs;       // the backward: sets of dQ slices and row statistics (bwd_bufs)
  int ctas, clusters;
  float scale, scale_log2;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) { return __float2bfloat16_rn(x); }

// a product's operand as the JAX kernel rounds it: to bf16 for bf16 inputs
template <typename T>
__device__ __forceinline__ float operand(float x) {
  return widen(narrow<T>(x));
}

// two neighbouring elements of a row, rounded to T, in one store
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = cvt::flash_pack(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The softmax's scores, shifts and exponentials: in f32 the scaled score
// fl(s scale), its row max m as the shift and expf(v - m); in bf16 the raw
// score, the shift m scale log2 e and exp2f(fmaf(s, scale log2 e, -shift)),
// the instantiated kernels' form. p of a -inf score is 0.
template <typename T>
struct Softmax {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  float scale, scale_log2;
  __device__ __forceinline__ float score(float s) const { return kF32 ? __fmul_rn(s, scale) : s; }
  __device__ __forceinline__ float shift(float m) const { return kF32 ? m : m * scale_log2; }
  __device__ __forceinline__ float p(float v, float sh) const {
    return kF32 ? expf(__fsub_rn(v, sh)) : exp2f(fmaf(v, scale_log2, -sh));
  }
  // exp(m_part - m) in score units: what brings a sum against m_part to m
  __device__ __forceinline__ float factor(float m_part, float m) const {
    return kF32 ? expf(__fsub_rn(m_part, m)) : exp2f((m_part - m) * scale_log2);
  }
  // dS = pn * (dP - r) * scale, in that order, rounded as the JAX kernel
  __device__ __forceinline__ float ds(float pn, float dp, float r) const {
    return operand<T>(__fmul_rn(__fmul_rn(pn, __fsub_rn(dp, r)), scale));
  }
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = cvt::flash_smem_u32(dst);
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(src_bytes));
  }
}

// Rows [row0, row0 + rows) of src (rows `stride` elements apart), columns
// [0, width), into dst (rows `ld` elements apart): rows at or past `limit`
// and columns at or past `cols_ok` become zeros. Each thread of the block
// moves `wbytes` at a time: 16, 8 or 4 by cp.async (the caller commits and
// waits), or a bf16 element by a plain copy (a view off its 4-byte
// alignment). width is a multiple of 16 elements.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, long long stride, int row0,
                                          int rows, int limit, int width, int cols_ok, int wbytes) {
  const int per = wbytes / (int)sizeof(T);
  const int units = width / per;
  for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
    const int r = idx / units;
    const int c = idx % units * per;
    const int real = row0 + r < limit ? max(0, min(per, cols_ok - c)) : 0;
    T* d = dst + r * ld + c;
    const T* s = real > 0 ? src + (long long)(row0 + r) * stride + c : src;
    const int bytes = real * (int)sizeof(T);
    if (wbytes == 16) {
      cp_async<16>(d, s, bytes);
    } else if (wbytes == 8) {
      cp_async<8>(d, s, bytes);
    } else if (wbytes == 4) {
      cp_async<4>(d, s, bytes);
    } else {
      *d = real > 0 ? *s : narrow<T>(0.f);
    }
  }
}

// copy_rows where every copy is 16 bytes of the head's columns (wbytes 16,
// a head dim that is a multiple of 16 bytes' elements and of 16): running
// pointers, only the row test a copy
template <typename T>
__device__ __forceinline__ void copy_rows16(T* dst, int ld, const T* src, long long stride,
                                            int row0, int rows, int limit, int width) {
  constexpr int per = 16 / (int)sizeof(T);
  const int units = width / per;
  const int step_r = blockDim.x / units;
  const int step_c = blockDim.x % units;
  int r = threadIdx.x / units;
  int c = threadIdx.x % units;
  T* d = dst + r * ld + c * per;
  const T* s = src + (long long)(row0 + r) * stride + c * per;
  const int d_step = step_r * ld + step_c * per;
  const long long s_step = step_r * stride + step_c * per;
  const int d_wrap = ld - units * per;
  const long long s_wrap = stride - units * per;
  while (r < rows) {
    const bool ok = row0 + r < limit;
    cp_async<16>(d, ok ? s : src, ok ? 16 : 0);
    r += step_r;
    c += step_c;
    d += d_step;
    s += s_step;
    if (c >= units) {
      c -= units;
      ++r;
      d += d_wrap;
      s += s_wrap;
    }
  }
}

// copy_rows16 where kWhole says every copy is whole 16 bytes of the head's
// columns (a compile-time choice: one loop in the kernel), else copy_rows
template <bool kWhole, typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src, long long stride, int row0,
                                          int rows, int limit, int width, int cols_ok, int wbytes) {
  if constexpr (kWhole) {
    copy_rows16(dst, ld, src, stride, row0, rows, limit, width);
  } else {
    copy_rows(dst, ld, src, stride, row0, rows, limit, width, cols_ok, wbytes);
  }
}

// Whether a call's tiles go in whole 16-byte copies (copy_rows16): copies
// of 16 bytes and a head dim that fills its padded depth.
__host__ __device__ constexpr bool whole_copies(int wbytes, int dh) {
  return wbytes == 16 && dh % 16 == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float dot4(const float4& x, const float4& y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// acc[j][e] += sum over d < depth of a[(g + 8 (e / 2)) lda + d] b[(8 j + 2 t + e % 2) ldb + d]
// for the n-blocks j with 8 j < live (bf16: 16-row pairs of them). In bf16 the
// fragments of the next 16 columns of depth are read while this step's
// products run (two register sets, the depth in pairs of steps).
template <int NB>
__device__ __forceinline__ void dot_frags(uint32_t (&fa)[4], uint32_t (&fb)[NB / 2][4],
                                          const bf16* ar, const bf16* br, int ldb, int kk,
                                          int live) {
  cvt::flash_ldsm_x4(fa, ar + kk);
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    if (16 * j < live) cvt::flash_ldsm_x4(fb[j], br + 16 * j * ldb + kk);
  }
}

template <int NB>
__device__ __forceinline__ void dot_step(float (&acc)[NB][4], const uint32_t (&fa)[4],
                                         const uint32_t (&fb)[NB / 2][4], int live) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    if (16 * j >= live) continue;
    cvt::mma_bf16_16816(acc[2 * j], fa, fb[j][0], fb[j][1]);
    cvt::mma_bf16_16816(acc[2 * j + 1], fa, fb[j][2], fb[j][3]);
  }
}

template <int NB>
__device__ __forceinline__ void dot(float (&acc)[NB][4], const bf16* a, int lda, const bf16* b,
                                    int ldb, int depth, int live, int lane) {
  static_assert(NB % 2 == 0, "n-blocks go in pairs");
  const bf16* ar = a + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* br = b + (lane % 8 + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
  uint32_t fa0[4], fa1[4], fb0[NB / 2][4], fb1[NB / 2][4];
  dot_frags<NB>(fa0, fb0, ar, br, ldb, 0, live);
  for (int kk = 0; kk < depth; kk += 32) {
    if (kk + 16 < depth) dot_frags<NB>(fa1, fb1, ar, br, ldb, kk + 16, live);
    dot_step<NB>(acc, fa0, fb0, live);
    if (kk + 16 >= depth) break;
    if (kk + 32 < depth) dot_frags<NB>(fa0, fb0, ar, br, ldb, kk + 32, live);
    dot_step<NB>(acc, fa1, fb1, live);
  }
}

// Two 16 x 16 products over the same depth in one walk (the backward's S^T
// and dP^T of a unit): four independent chains of products a step.
__device__ __forceinline__ void dot2(float (&s)[2][4], const bf16* a, const bf16* b,
                                     float (&p)[2][4], const bf16* c, const bf16* d, int ld,
                                     int depth, int lane) {
  const int ao = (lane % 16) * ld + (lane / 16) * 8;
  const int bo = (lane % 8 + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
  uint32_t fa0[4], fb0[1][4], fc0[4], fd0[1][4], fa1[4], fb1[1][4], fc1[4], fd1[1][4];
  dot_frags<2>(fa0, fb0, a + ao, b + bo, ld, 0, 16);
  dot_frags<2>(fc0, fd0, c + ao, d + bo, ld, 0, 16);
  for (int kk = 0; kk < depth; kk += 32) {
    if (kk + 16 < depth) {
      dot_frags<2>(fa1, fb1, a + ao, b + bo, ld, kk + 16, 16);
      dot_frags<2>(fc1, fd1, c + ao, d + bo, ld, kk + 16, 16);
    }
    dot_step<2>(s, fa0, fb0, 16);
    dot_step<2>(p, fc0, fd0, 16);
    if (kk + 16 >= depth) break;
    if (kk + 32 < depth) {
      dot_frags<2>(fa0, fb0, a + ao, b + bo, ld, kk + 32, 16);
      dot_frags<2>(fc0, fd0, c + ao, d + bo, ld, kk + 32, 16);
    }
    dot_step<2>(s, fa1, fb1, 16);
    dot_step<2>(p, fc1, fd1, 16);
  }
}

template <int NB>
__device__ __forceinline__ void dot(float (&acc)[NB][4], const float* a, int lda, const float* b,
                                    int ldb, int depth, int live, int lane) {
  const float* a0 = a + (lane / 4) * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = b + 2 * (lane % 4) * ldb;
#pragma unroll 2
  for (int d = 0; d < depth; d += 4) {
    const float4 x0 = ld4(a0 + d);
    const float4 x1 = ld4(a1 + d);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (8 * j >= live) continue;
      const float4 y0 = ld4(b0 + 8 * j * ldb + d);
      const float4 y1 = ld4(b0 + (8 * j + 1) * ldb + d);
      acc[j][0] = dot4(x0, y0, acc[j][0]);
      acc[j][1] = dot4(x0, y1, acc[j][1]);
      acc[j][2] = dot4(x1, y0, acc[j][2]);
      acc[j][3] = dot4(x1, y1, acc[j][3]);
    }
  }
}

__device__ __forceinline__ void dot2(float (&s)[2][4], const float* a, const float* b,
                                     float (&p)[2][4], const float* c, const float* d, int ld,
                                     int depth, int lane) {
  dot<2>(s, a, ld, b, ld, depth, 16, lane);
  dot<2>(p, c, ld, d, ld, depth, 16, lane);
}

// acc[j][e] += sum over k < depth of A[g + 8 (e / 2)][k] b[k ldb + 8 j + 2 t + e % 2] for the
// n-blocks j with 8 j < cols (bf16: pairs); A row-major (a: its first row, lda apart)
template <int NB>
__device__ __forceinline__ void outer_rm(float (&acc)[NB][4], const bf16* a, int lda, const bf16* b,
                                         int ldb, int depth, int cols, int lane) {
  static_assert(NB % 2 == 0, "n-blocks go in pairs");
  const bf16* ar = a + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* br = b + (lane % 8 + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
  for (int kk = 0; kk < depth; kk += 16) {
    uint32_t af[4];
    cvt::flash_ldsm_x4(af, ar + kk);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      if (16 * j >= cols) continue;
      uint32_t bf[4];
      cvt::flash_ldsm_x4_trans(bf, br + kk * ldb + 16 * j);
      cvt::mma_bf16_16816(acc[2 * j], af, bf[0], bf[1]);
      cvt::mma_bf16_16816(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void outer_rm(float (&acc)[NB][4], const float* a, int lda, const float* b,
                                         int ldb, int depth, int cols, int lane) {
  const float* a0 = a + (lane / 4) * lda;
  const float* a1 = a0 + 8 * lda;
  const float* bt = b + 2 * (lane % 4);
  for (int k = 0; k < depth; k += 4) {
    const float4 x0 = ld4(a0 + k);
    const float4 x1 = ld4(a1 + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xa = part(x0, i);
      const float xb = part(x1, i);
      const float* brow = bt + (k + i) * ldb;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (8 * j >= cols) continue;
        const float2 y = ld2(brow + 8 * j);
        acc[j][0] = fmaf(xa, y.x, acc[j][0]);
        acc[j][1] = fmaf(xa, y.y, acc[j][1]);
        acc[j][2] = fmaf(xb, y.x, acc[j][2]);
        acc[j][3] = fmaf(xb, y.y, acc[j][3]);
      }
    }
  }
}

// The same with A stored transposed: at[k lda + r] = A[r][k] (at: A's row 0)
template <int NB>
__device__ __forceinline__ void outer_tm(float (&acc)[NB][4], const bf16* at, int lda, const bf16* b,
                                         int ldb, int depth, int cols, int lane) {
  static_assert(NB % 2 == 0, "n-blocks go in pairs");
  const bf16* ar = at + (lane % 8 + (lane / 16) * 8) * lda + ((lane / 8) % 2) * 8;
  const bf16* br = b + (lane % 8 + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
  for (int kk = 0; kk < depth; kk += 16) {
    uint32_t af[4];
    cvt::flash_ldsm_x4_trans(af, ar + kk * lda);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      if (16 * j >= cols) continue;
      uint32_t bf[4];
      cvt::flash_ldsm_x4_trans(bf, br + kk * ldb + 16 * j);
      cvt::mma_bf16_16816(acc[2 * j], af, bf[0], bf[1]);
      cvt::mma_bf16_16816(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void outer_tm(float (&acc)[NB][4], const float* at, int lda, const float* b,
                                         int ldb, int depth, int cols, int lane) {
  const int g = lane / 4;
  const float* bt = b + 2 * (lane % 4);
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float xa = at[k * lda + g];
    const float xb = at[k * lda + g + 8];
    const float* brow = bt + k * ldb;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (8 * j >= cols) continue;
      const float2 y = ld2(brow + 8 * j);
      acc[j][0] = fmaf(xa, y.x, acc[j][0]);
      acc[j][1] = fmaf(xa, y.y, acc[j][1]);
      acc[j][2] = fmaf(xb, y.x, acc[j][2]);
      acc[j][3] = fmaf(xb, y.y, acc[j][3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The widest copy that every row of a call's tiles allows: 16 bytes, less
// where the qkv or g address or the head's columns (dh elements apart) are
// not 16-byte aligned: 8 bytes at 64 heads of 12 in bf16, 2 (bf16 elements)
// for an odd head dim.
inline int copy_bytes(const void* qkv, const void* grad, int dh, int es) {
  int w = 16;
  const auto off = [](const void* p) { return (unsigned long long)(uintptr_t)p; };
  while (w > es && (off(qkv) % w || (grad && off(grad) % w) || (dh * es) % w)) w /= 2;
  return w;
}

}  // namespace cvt_any
