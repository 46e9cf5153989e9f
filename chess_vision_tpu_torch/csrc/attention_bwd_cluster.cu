// Multi-head attention backward into the packed dqkv layout above 288
// tokens, in bf16: the long route of K3 (ops/attention.bwd_route "long").
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention_bwd (_attn_bwd_kernel) where attention_bwd.cu, which
// holds a whole head in one block's shared memory, cannot (N > 288: a ViT
// at input_size 384 has 577 tokens). From the saved packed projection qkv
// (B, N, 3*D), D = H*Dh, and the cotangent g (B, N, D) of the attention
// output, for every (image, head):
//   S = Q K^T * scale (f32), pn = softmax(S) (max-shifted, normalized in f32),
//   dV = bf16(pn)^T g,  dP = g V^T,  r = rowsum(dP * pn),
//   dS = bf16(pn * (dP - r) * scale),  dQ = dS K,  dK = dS^T Q,
// f32 accumulation, one bf16 rounding of each output, written at columns
// h*Dh, D + h*Dh and 2*D + h*Dh of dqkv: no permute copy. pn and dS round
// to bf16 at the same two points as attention_bwd.cu, with the same
// exp2(fma(s, scale*log2(e), -m*scale*log2(e))) * (1/l), so the two routes
// part only in f32 summation order at N = 288 / 289.
//
// Bound on this card at the 384 px training shape (64, 577, 2304): the five
// products are 163.7 GFLOP, 0.166 ms at 989 TFLOP/s; the call reads qkv
// (142 MB) and g (47 MB) and writes dqkv (142 MB), 0.099 ms at 3.35 TB/s.
// Operations bound it.
//
// Design: the f32 route's skeleton (attention_f32.cuh) on bf16 tensor-core
// fragments (mma.sync m16n8k16, operands by ldmatrix / ldmatrix.trans).
//  - One thread-block cluster of C <= 8 CTAs (the portable size) of W <= 8
//    warps per (image, head); the head's 16-key steps are shared out evenly
//    over the CTAs (ops/attention.long_plan, f32_key_ranges), each warp
//    owning 16 keys; 577 tokens: 5 CTAs of 8 warps (2 of 128 keys, 3 of
//    112), two CTAs an SM (128 registers, 99,584 bytes of shared memory).
//    Each CTA copies its keys' K and V rows into shared memory once and
//    keeps them, with its dK / dV sums in registers, for the whole launch.
//  - The cluster walks the query rows in tiles of 64 (then 16-row tails);
//    the next tile's Q and g rows come in by cp.async under this tile's dQ
//    product and exchange.
//  - Pass 1: a warp computes S^T = K Q^T and dP^T = V g^T for its 16 keys
//    (their K and V rows held as A fragments), 16 rows at a time; the rows'
//    statistics (max m, l = sum exp, sum dP exp) go from warps to the CTA
//    in shared memory; after a cluster barrier every CTA reads every CTA's
//    through distributed shared memory (8 lanes a row, one remote load
//    each, combined by a fixed xor tree, each part rescaled by
//    exp(m_part - m)).
//  - Pass 2: S^T and dP^T again, 16 rows at a time (the A fragments read
//    as they are used: held, they spilled), then pn^T and dS^T in
//    registers as the A operands of dV += pn^T g and dK += dS^T q (the C
//    fragment of S^T is the A fragment of the next product); dS^T also goes
//    to shared memory for the CTA's partial dQ = dS K, whose rows are
//    stored straight into the shared memory of the CTA that owns them
//    (remote stores); after a second cluster barrier each CTA adds its
//    rows' slices in rank order and writes them once.
//  - 7 products where the function needs 5: a tile's S^T and dP^T held
//    across the exchange (64 registers beside dK and dV's 64) spilled and
//    left one or two CTAs an SM; recomputed, two CTAs of 8 warps fit in 128
//    registers. No scratch in device memory, no atomics: the same bits
//    twice.
//  - Above a cluster's reach (8 x 128 keys: N > 1024) the head's keys are
//    split over G clusters: a statistics pass (the same kernel, pass 1
//    only) writes each cluster's (m, l, sum dP exp) to an f32 scratch
//    (B, H, G, 3, N); the main pass combines them in cluster order and
//    writes each cluster's dQ to an f32 scratch (B, H, G, N, Dh), which a
//    summing pass (attention_f32.cuh, dq_sum_kernel) adds in cluster order.
//    Three launches, still deterministic.
//  - The ragged edge: keys past a CTA's range are zero-filled and masked
//    (pn = 0, dS = 0); query rows past N load zeros, so they add nothing to
//    dK and dV, and are not stored.
// A cluster that the card cannot hold, or a shared-memory request it
// refuses, returns the CUDA error and nothing runs (the wrapper raises).
// Timings, bounds and the probes' readings are in PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_f32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpKeys = 16;                   // keys a warp owns
constexpr int kMaxWarps = 8;                    // 128 keys a CTA
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCtas = 8;                     // the portable cluster size
constexpr int kTileRows = 64;
constexpr int kUnitRows = 16;
constexpr int kPad = 8;                         // bf16 padding of a shared-memory row
constexpr int kLdT = kTileRows + kPad;          // a key-major dS^T row

enum Mode { kOne = 0, kStats = 1, kSplit = 2 };

// Timing-only builds (experiments/kernel_ab.py --sections longprobes) define
// CVT_LONG_PROBE to take one part out of the kernel; their outputs are
// wrong. kProbePass1: the first pass (S, dP and the warps' statistics);
// kProbePass2: the second (S and dP again, pn, dS, dV and dK); kProbeDq:
// the dQ partial's product; kProbeExchange: the cluster barriers (a CTA
// barrier instead) and the remote reads (the CTA's own shared memory
// instead); kProbeReduce: the dQ partials' sum and its stores;
// kProbeStats: the cluster's statistics (the CTA's own instead).
#ifndef CVT_LONG_PROBE
#define CVT_LONG_PROBE 0
#endif
enum LongProbe { kProbeNone, kProbePass1, kProbePass2, kProbeDq, kProbeExchange, kProbeReduce,
                 kProbeStats };
__host__ __device__ constexpr bool probe(LongProbe p) { return CVT_LONG_PROBE == p; }

// the cluster's CTA k, or this CTA itself in a probe build without the exchange
__device__ __forceinline__ int peer(int k, int rank) { return probe(kProbeExchange) ? rank : k; }

__device__ __forceinline__ void tile_sync() {  // every CTA of the cluster
  if (probe(kProbeExchange)) {
    __syncthreads();
  } else {
    cvt_f32::cluster_sync();
  }
}

template <int Dh>
__host__ __device__ constexpr int row_ld() {  // bf16 row of K, V, Q and g
  return Dh + kPad;
}

// Rows of a CTA's dQ receive buffer: every CTA's slice of the rows this CTA
// owns, ceil(64 / C) rows each (C x ceil(64 / C) <= 70 for C <= 8).
constexpr int kRecvRows = 70;

// A dQ slice's column `col` of slot `slot` lies at col ^ swizzle: the
// float2 stores of a warp's 8 row groups then fall in distinct banks. The
// xor stays below Dh's lowest set bit, so col ^ swizzle < Dh (Dh = 80: 8)
template <int Dh>
__host__ __device__ constexpr int recv_swizzle(int slot) {
  constexpr int kLow = (Dh & -Dh) / 8 - 1;
  return (slot & (kLow < 3 ? kLow : 3)) << 3;
}

// Shared memory of a CTA of `warps` warps: K and V (16 rows a warp), the
// Q and g tiles (64 rows each), dS^T (key-major), the dQ slices received
// ([70][Dh] f32), the CTA's row statistics ([64] float4), the warps' [3]
// [warps][64] and the head's [3][64]. 76,544 bytes at Dh = 64 and 5 warps
// (three CTAs an SM), 99,584 at 8 warps (two); 116,352 at Dh = 80 and
// 166,656 at Dh = 128 with 8 warps (one). ops/attention.long_smem_bytes
// mirrors it.
template <int Dh>
__host__ __device__ constexpr int smem_bytes(int warps) {
  return 2 * (2 * warps * kWarpKeys * row_ld<Dh>() + 2 * kTileRows * row_ld<Dh>() +
              warps * kWarpKeys * kLdT) +
         4 * (kRecvRows * Dh + 4 * kTileRows + 3 * warps * kTileRows + 3 * kTileRows);
}
static_assert(smem_bytes<128>(kMaxWarps) <= cvt_f32::kMaxSmemBytes,
              "a CTA's shared memory exceeds the block limit");  // the largest head dim

// CTAs an SM: two up to Dh = 64 (128 registers a thread: dK and dV hold 64),
// one above (255: dK and dV hold 80 at Dh = 80, 128 at 128)
template <int Dh>
constexpr int min_blocks() {
  return Dh <= 64 ? 2 : 1;
}

template <int Dh>
struct Ctx {
  const bf16* base;    // the head's q columns of the image
  const bf16* g_base;  // the head's columns of g
  bf16* o_base;        // the head's dq columns of dqkv
  float* stats;        // split: the (image, head)'s [G][3][n]
  float* parts;        // split: the (image, head)'s dQ partials [G][n][Dh]
  long long stride;    // 3 D
  int d_model;
  int dh;              // the head's columns (up to Dh; the rest are zero)
  int n;
  int kc;              // this CTA's keys
  int rank;            // in the cluster
  int ctas;            // of the cluster
  int cluster;         // of the head's clusters
  int clusters;
  int warps;
  float scale;
  float scale_log2;    // scale * log2(e)
  bf16* ks;
  bf16* vs;
  bf16* qs;            // the tile's Q rows [64][row_ld], then its g rows
  bf16* dst;           // dS^T (key, row)
  float* recv;         // dQ slices of the rows this CTA owns [70][Dh]
  float4* cst;         // the CTA's row statistics [64]: l, sum dP exp, m
  float* wst;          // per warp [3][warps][64]: max, exp-sum, sum dP exp
  float* fin;          // the head's [3][64]: m * scale_log2, 1 / l, r
  cvt_f32::Tiles tiles;
};

// rows [row0, row0 + rows) x Dh of src (row stride `stride`) into dst by
// cp.async, 16 bytes a thread; rows at or past `limit` and columns at or
// past dh become zeros
template <int Dh>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride, int row0,
                                           int rows, int limit, int dh) {
  constexpr int kChunks = Dh / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = row0 + r < limit && c < dh;
    cvt::flash_cp16(dst + r * row_ld<Dh>() + c,
                    ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// tile t's Q and g rows into shared memory; one commit group (empty past
// the last tile)
template <int Dh>
__device__ __forceinline__ void stage_tile(const Ctx<Dh>& c, int t) {
  if (t < c.tiles.count) {
    bf16* st = c.qs;
    const int rows = c.tiles.is_full(t) ? kTileRows : kUnitRows;
    const int row0 = c.tiles.row0(t);
    stage_rows<Dh>(st, c.base, c.stride, row0, rows, c.n, c.dh);
    stage_rows<Dh>(st + kTileRows * row_ld<Dh>(), c.g_base, c.d_model, row0, rows, c.n, c.dh);
  }
  cvt::flash_commit();
}

// acc[h] (the warp's keys g and g + 8 by query rows 16 kk + 8 h + 2 tq +
// {0, 1}) = A B^T over the head dim: a, the warp's 16 key rows; b, the
// tile's rows (both row-major). The A fragments are read as they are used:
// held for the tile they would take 32 registers.
template <int Dh>
__device__ __forceinline__ void block_scores(float (&acc)[2][4], const bf16* a, const bf16* b,
                                             int kk, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  const bf16* at = b + (kk * 16 + lane % 8 + (lane / 16) * 8) * row_ld<Dh>() + ((lane / 8) % 2) * 8;
  const bf16* af = a + (lane % 16) * row_ld<Dh>() + (lane / 16) * 8;
#pragma unroll
  for (int j = 0; j < Dh / 16; ++j) {
    uint32_t fa[4], fb[4];
    cvt::flash_ldsm_x4(fa, af + j * 16);
    cvt::flash_ldsm_x4(fb, at + j * 16);
    cvt::mma_bf16_16816(acc[0], fa, fb[0], fb[1]);
    cvt::mma_bf16_16816(acc[1], fa, fb[2], fb[3]);
  }
}

// The same with the A fragments already in registers (af[j]: head-dim
// columns 16 j .. 16 j + 15 of the warp's 16 key rows)
template <int Dh>
__device__ __forceinline__ void block_scores(float (&acc)[2][4], const uint32_t (&af)[Dh / 16][4],
                                             const bf16* b, int kk, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  const bf16* at = b + (kk * 16 + lane % 8 + (lane / 16) * 8) * row_ld<Dh>() + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int j = 0; j < Dh / 16; ++j) {
    uint32_t fb[4];
    cvt::flash_ldsm_x4(fb, at + j * 16);
    cvt::mma_bf16_16816(acc[0], af[j], fb[0], fb[1]);
    cvt::mma_bf16_16816(acc[1], af[j], fb[2], fb[3]);
  }
}

__device__ __forceinline__ float max_over_keys(float x) {  // over the 8 lanes of a tq group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float sum_over_keys(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// Rows 16 kk .. 16 kk + 15's statistics over this warp's keys into wst:
// the max of the raw scores, l = sum exp2((s - m) scale log2 e), and
// sum dP exp2(...)
template <int Dh>
__device__ __forceinline__ void warp_stats(const Ctx<Dh>& c, const float (&s)[2][4],
                                           const float (&dp)[2][4], bool lo_ok, bool hi_ok,
                                           int kk, int warp, int lane) {
  float* wm = c.wst + warp * kTileRows;
  float* wl = wm + c.warps * kTileRows;
  float* wr = wl + c.warps * kTileRows;
  const float c2 = c.scale_log2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // row 16 kk + 8 h + 2 tq + e: element e (key g), e + 2 (key g + 8)
      // finite: key 16 warp is the CTA's
      const float m = max_over_keys(
          fmaxf(lo_ok ? s[h][e] : -INFINITY, hi_ok ? s[h][e + 2] : -INFINITY));
      const float sh = m * c2;
      const float p0 = lo_ok ? exp2f(fmaf(s[h][e], c2, -sh)) : 0.f;
      const float p1 = hi_ok ? exp2f(fmaf(s[h][e + 2], c2, -sh)) : 0.f;
      const float l = sum_over_keys(p0 + p1);
      const float ra = sum_over_keys(fmaf(dp[h][e], p0, dp[h][e + 2] * p1));
      if (lane < 4) {
        const int r = kk * 16 + h * 8 + 2 * lane + e;
        wm[r] = m;
        wl[r] = l;
        wr[r] = ra;
      }
    }
  }
}

// Row r's statistics over the CTA's warps into cst: (m, l, sum dP exp)
template <int Dh>
__device__ __forceinline__ void cta_stats(const Ctx<Dh>& c, float4* cst, int r) {
  const float* wm = c.wst;
  const float* wl = wm + c.warps * kTileRows;
  const float* wr = wl + c.warps * kTileRows;
  float m = -INFINITY;
  for (int w = 0; w < c.warps; ++w) m = fmaxf(m, wm[w * kTileRows + r]);
  float l = 0.f, ra = 0.f;
  for (int w = 0; w < c.warps; ++w) {
    const float f = exp2f((wm[w * kTileRows + r] - m) * c.scale_log2);  // 0 for a warp without keys
    l = fmaf(wl[w * kTileRows + r], f, l);
    ra = fmaf(wr[w * kTileRows + r], f, ra);
  }
  cst[r] = make_float4(l, ra, m, 0.f);
}

// The cluster's statistics of the tile's rows, each row's from every
// CTA's cst: 8 lanes a row, lane k reading CTA k's (one remote load each,
// issued together for up to 4 rows a lane), combined over the 8 lanes by a
// fixed xor tree (max, then the sums rescaled by exp2((m_k - m) scale
// log2 e)); `put` takes (row, m, l, sum dP exp) on the row's lane 0.
template <int Dh, typename Put>
__device__ __forceinline__ void cluster_stats(const Ctx<Dh>& c, const float4* cst, int rows,
                                              Put&& put) {
  const int lane = threadIdx.x % 32;
  const int k = lane % 8;
  const bool has = k < c.ctas;
  const float4* at = cvt_f32::cluster_ptr(cst, peer(has ? k : 0, c.rank));
  const int stride = 4 * c.warps;  // rows a pass
  // (a warp's lanes run the loop together: the shuffles need all 32)
  for (int base = threadIdx.x / 32 * 4; base < rows; base += 4 * stride) {
    const int r0 = base + lane / 8;
    float4 v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = r0 + p * stride;
      v[p] = has && r < rows ? at[r] : make_float4(0.f, 0.f, -INFINITY, 0.f);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float m = v[p].z;  // every row has a CTA with keys: m is finite
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      const float f = exp2f((v[p].z - m) * c.scale_log2);  // 0 for no CTA
      float l = v[p].x * f, ra = v[p].y * f;
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, x);
        ra += __shfl_xor_sync(0xffffffffu, ra, x);
      }
      const int r = r0 + p * stride;
      if (k == 0 && r < rows) put(r, m, l, ra);
    }
  }
}

// Row r of the tile at row0 from the split's scratch: the G clusters'
// statistics, in cluster order; a row past n gets (0, 1, 0)
template <int Dh>
__device__ __forceinline__ void split_stats(const Ctx<Dh>& c, int r, int row0, float& m, float& l,
                                            float& ra) {
  m = 0.f;
  l = 1.f;
  ra = 0.f;
  const int row = row0 + r;
  if (row >= c.n) return;
  m = -INFINITY;
  for (int k = 0; k < c.clusters; ++k) m = fmaxf(m, c.stats[(3 * k) * c.n + row]);
  l = 0.f;
  for (int k = 0; k < c.clusters; ++k) {
    const float f = exp2f((c.stats[(3 * k) * c.n + row] - m) * c.scale_log2);
    l = fmaf(c.stats[(3 * k + 1) * c.n + row], f, l);
    ra = fmaf(c.stats[(3 * k + 2) * c.n + row], f, ra);
  }
}

// dQ rows of tile u that this CTA owns: every CTA's slice (received into
// this CTA's shared memory before the barrier), added in rank order,
// rounded to bf16 into dqkv or, in a split's main pass, f32 into the
// cluster's partials
template <int Dh, int Mode>
__device__ __forceinline__ void reduce_dq(const Ctx<Dh>& c, int u) {
  const int row0 = c.tiles.row0(u);
  const int rows = c.tiles.is_full(u) ? kTileRows : kUnitRows;
  const float* recv = c.recv;
  const cvt_f32::RowShare share(rows, c.ctas, c.rank, row0, c.n);
  const int per = (rows + c.ctas - 1) / c.ctas;
  for (int e = threadIdx.x; e < share.rows * (Dh / 4); e += blockDim.x) {
    const int slot = e / (Dh / 4);
    const int d = e % (Dh / 4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < c.ctas; ++k) {
      const int at = k * per + slot;
      const float4 v =
          *reinterpret_cast<const float4*>(recv + at * Dh + (d ^ recv_swizzle<Dh>(at)));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int r = share.r0 + slot;
    if (d >= c.dh) continue;
    if constexpr (Mode == kOne) {
      cvt_f32::store4(c.o_base + (long long)(row0 + r) * c.stride + d, sum);
    } else {
      cvt_f32::store4(c.parts + ((long long)c.cluster * c.n + row0 + r) * c.dh + d, sum);
    }
  }
}

// Tile t: two cluster barriers, one after the CTAs' row statistics (then
// each CTA reads every CTA's), one after the dQ slices (then each CTA adds
// the slices of the rows it owns). Between the second barrier of one tile
// and the first of the next, no CTA writes what another reads.
template <int Dh, int Rows, int Mode>
__device__ __forceinline__ void bwd_tile(const Ctx<Dh>& c, int t, float (&dk)[Dh / 8][4],
                                         float (&dv)[Dh / 8][4]) {
  constexpr int kLd = row_ld<Dh>();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int key = warp * kWarpKeys + g;  // this lane's keys: key, key + 8
  const bool active = warp * kWarpKeys < c.kc;
  const bool lo_ok = key < c.kc;
  const bool hi_ok = key + 8 < c.kc;
  const int row0 = c.tiles.row0(t);
  const bf16* qs = c.qs;
  const bf16* gs = qs + kTileRows * kLd;
  const bf16* kw = c.ks + warp * kWarpKeys * kLd;  // the warp's K rows
  const bf16* vw = c.vs + warp * kWarpKeys * kLd;

  cvt::flash_wait<0>();  // this tile's copies
  if constexpr (Mode == kSplit) {
    if (threadIdx.x < Rows) {
      float m, l, ra;
      split_stats(c, threadIdx.x, row0, m, l, ra);
      c.fin[threadIdx.x] = m * c.scale_log2;
      c.fin[kTileRows + threadIdx.x] = 1.f / l;
      c.fin[2 * kTileRows + threadIdx.x] = ra * (1.f / l);
    }
  }
  __syncthreads();

  if constexpr (Mode != kSplit) {
    if (active && !probe(kProbePass1) && Dh > 64) {
      // pass 1 above Dh = 64: the A fragments read as they are used (held,
      // they would take Dh / 2 registers beside dK and dV's Dh)
#pragma unroll
      for (int kk = 0; kk < Rows / 16; ++kk) {
        float s[2][4], dp[2][4];
        block_scores<Dh>(s, kw, qs, kk, lane);
        block_scores<Dh>(dp, vw, gs, kk, lane);
        warp_stats<Dh>(c, s, dp, lo_ok, hi_ok, kk, warp, lane);
      }
    } else if (active && !probe(kProbePass1)) {  // pass 1: S^T and dP^T, 16 rows at a time, for the statistics
      uint32_t kf[Dh / 16][4], vf[Dh / 16][4];  // the warp's K and V rows, held for the pass
#pragma unroll
      for (int j = 0; j < Dh / 16; ++j) {
        cvt::flash_ldsm_x4(kf[j], kw + (lane % 16) * kLd + j * 16 + (lane / 16) * 8);
        cvt::flash_ldsm_x4(vf[j], vw + (lane % 16) * kLd + j * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < Rows / 16; ++kk) {
        float s[2][4], dp[2][4];
        block_scores<Dh>(s, kf, qs, kk, lane);
        block_scores<Dh>(dp, vf, gs, kk, lane);
        warp_stats<Dh>(c, s, dp, lo_ok, hi_ok, kk, warp, lane);
      }
    } else {
      for (int r = lane; r < Rows; r += 32) {
        c.wst[warp * kTileRows + r] = active ? 0.f : -INFINITY;  // (0, 1, 0): a probe's stand-in
        c.wst[(c.warps + warp) * kTileRows + r] = active ? 1.f : 0.f;
        c.wst[(2 * c.warps + warp) * kTileRows + r] = 0.f;
      }
    }
    __syncthreads();
    if constexpr (Mode == kStats) stage_tile(c, t + 1);  // Q and g are read no more
    if (threadIdx.x < Rows) cta_stats(c, c.cst, threadIdx.x);
    tile_sync();

    const cvt_f32::RowShare share(Rows, c.ctas, c.rank, row0, c.n);
    const auto put = [&](int r, float m, float l, float ra) {
      if constexpr (Mode == kStats) {
        if (r >= share.r0 && r < share.r0 + share.rows) {
          float* at = c.stats + (3 * c.cluster) * c.n + row0 + r;
          at[0] = m;
          at[c.n] = l;
          at[2 * c.n] = ra;
        }
      } else {
        c.fin[r] = m * c.scale_log2;
        c.fin[kTileRows + r] = 1.f / l;
        c.fin[2 * kTileRows + r] = ra * (1.f / l);
      }
    };
    if (probe(kProbeStats)) {
      if (threadIdx.x < Rows) {
        const float4 own = c.cst[threadIdx.x];
        put(threadIdx.x, own.z, own.x, own.y);
      }
    } else {
      cluster_stats(c, c.cst, Rows, put);
    }
  }
  if constexpr (Mode == kStats) {
    tile_sync();  // every CTA done with the others' statistics
    return;
  } else {
    __syncthreads();

    if (active && !probe(kProbePass2)) {
      // pass 2: S^T and dP^T again, 16 rows at a time; pn and dS of this
      // warp's keys; dV += bf16(pn)^T g, dK += dS^T q
#pragma unroll
      for (int kk = 0; kk < Rows / 16; ++kk) {
        float s[2][4], dp[2][4];
        block_scores<Dh>(s, kw, qs, kk, lane);
        block_scores<Dh>(dp, vw, gs, kk, lane);
        uint32_t pa[4], da[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nb = 2 * kk + h;
          float pn[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = nb * 8 + 2 * tq + (e & 1);
            const bool ok = e < 2 ? lo_ok : hi_ok;
            const float p =
                ok ? exp2f(fmaf(s[h][e], c.scale_log2, -c.fin[r])) * c.fin[kTileRows + r] : 0.f;
            pn[e] = p;
            ds[e] = p * (dp[h][e] - c.fin[2 * kTileRows + r]) * c.scale;
          }
          pa[2 * h] = cvt::flash_pack(pn[0], pn[1]);
          pa[2 * h + 1] = cvt::flash_pack(pn[2], pn[3]);
          da[2 * h] = cvt::flash_pack(ds[0], ds[1]);
          da[2 * h + 1] = cvt::flash_pack(ds[2], ds[3]);
          *reinterpret_cast<uint32_t*>(c.dst + key * kLdT + nb * 8 + 2 * tq) = da[2 * h];
          *reinterpret_cast<uint32_t*>(c.dst + (key + 8) * kLdT + nb * 8 + 2 * tq) = da[2 * h + 1];
        }
#pragma unroll
        for (int cb = 0; cb < Dh / 16; ++cb) {
          const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + cb * 16 + (lane / 16) * 8;
          uint32_t b[4];
          cvt::flash_ldsm_x4_trans(b, gs + off);
          cvt::mma_bf16_16816(dv[2 * cb], pa, b[0], b[1]);
          cvt::mma_bf16_16816(dv[2 * cb + 1], pa, b[2], b[3]);
          cvt::flash_ldsm_x4_trans(b, qs + off);
          cvt::mma_bf16_16816(dk[2 * cb], da, b[0], b[1]);
          cvt::mma_bf16_16816(dk[2 * cb + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();      // dS^T whole; Q and g read no more
    stage_tile(c, t + 1);  // the next tile's copies run under the dQ product

    // the CTA's partial dQ = dS K, a warp per 16 rows x 16 columns, each
    // row's slice stored into the shared memory of the CTA that owns the
    // row (remote stores: nobody waits for them before the barrier)
    constexpr int kUnits = Rows / 16 * (Dh / 16);
    const int steps = (c.kc + kWarpKeys - 1) / kWarpKeys;
    const int per = (Rows + c.ctas - 1) / c.ctas;
    for (int u = warp; u < (probe(kProbeDq) ? 0 : kUnits); u += c.warps) {
      const int rb = u / (Dh / 16);
      const int d0 = u % (Dh / 16) * 16;
      float acc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
      for (int st = 0; st < steps; ++st) {
        uint32_t a[4], b[4];
        cvt::flash_ldsm_x4_trans(a, c.dst + (st * 16 + lane % 8 + (lane / 16) * 8) * kLdT +
                                        rb * 16 + ((lane / 8) % 2) * 8);
        cvt::flash_ldsm_x4_trans(b, c.ks + (st * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                                        d0 + (lane / 16) * 8);
        cvt::mma_bf16_16816(acc[0], a, b[0], b[1]);
        cvt::mma_bf16_16816(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rb * 16 + g + 8 * i;
        const int owner = r / per;
        const int at = c.rank * per + r - owner * per;
        float* row = cvt_f32::cluster_ptr(c.recv, peer(owner, c.rank)) + at * Dh;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int col = d0 + nb * 8 + 2 * tq;
          *reinterpret_cast<float2*>(row + (col ^ recv_swizzle<Dh>(at))) =
              make_float2(acc[nb][2 * i], acc[nb][2 * i + 1]);
        }
      }
    }
    tile_sync();  // every CTA's slices in place
    if (!probe(kProbeReduce)) reduce_dq<Dh, Mode>(c, t);
  }
}

template <int Dh, int Mode>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<Dh>())
attention_bwd_cluster_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                             bf16* __restrict__ dqkv, float* __restrict__ stats,
                             float* __restrict__ parts, int n, int heads, int dh, int clusters,
                             float scale, float scale_log2) {
  static_assert(cvt::flash_head_dim(Dh) == Dh, "Dh must be an instantiated head dim");
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kLd = row_ld<Dh>();
  Ctx<Dh> c{};
  c.dh = dh;
  c.d_model = heads * dh;
  c.stride = 3LL * c.d_model;
  const long long head = (long long)blockIdx.z * heads + blockIdx.y;
  c.base = qkv + (long long)blockIdx.z * n * c.stride + blockIdx.y * dh;
  c.g_base = grad + (long long)blockIdx.z * n * c.d_model + blockIdx.y * dh;
  c.o_base = dqkv + (long long)blockIdx.z * n * c.stride + blockIdx.y * dh;
  c.clusters = clusters;
  c.stats = Mode == kOne ? nullptr : stats + head * clusters * 3 * n;
  c.parts = Mode == kSplit ? parts + head * clusters * n * dh : nullptr;
  c.n = n;
  c.ctas = gridDim.x / clusters;
  c.rank = blockIdx.x % c.ctas;
  c.cluster = blockIdx.x / c.ctas;
  c.warps = blockDim.x / 32;
  int key0;
  cvt_f32::cta_keys(n, gridDim.x, blockIdx.x, key0, c.kc);
  c.scale = scale;
  c.scale_log2 = scale_log2;
  const int keys = c.warps * kWarpKeys;
  c.ks = reinterpret_cast<bf16*>(smem);
  c.vs = c.ks + keys * kLd;
  c.qs = c.vs + keys * kLd;
  c.dst = c.qs + 2 * kTileRows * kLd;
  c.recv = reinterpret_cast<float*>(c.dst + keys * kLdT);
  c.cst = reinterpret_cast<float4*>(c.recv + kRecvRows * Dh);
  c.wst = reinterpret_cast<float*>(c.cst + kTileRows);
  c.fin = c.wst + 3 * c.warps * kTileRows;
  c.tiles = cvt_f32::Tiles(n);

  // K and V once, with tile 0 in the first group
  const int kc_pad = (c.kc + kWarpKeys - 1) / kWarpKeys * kWarpKeys;
  stage_rows<Dh>(c.ks, c.base + c.d_model, c.stride, key0, kc_pad, key0 + c.kc, dh);
  stage_rows<Dh>(c.vs, c.base + 2 * c.d_model, c.stride, key0, kc_pad, key0 + c.kc, dh);
  stage_tile(c, 0);

  float dk[Dh / 8][4], dv[Dh / 8][4];
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;
  }
  for (int t = 0; t < c.tiles.count; ++t) {
    if (c.tiles.is_full(t)) {
      bwd_tile<Dh, kTileRows, Mode>(c, t, dk, dv);
    } else {
      bwd_tile<Dh, kUnitRows, Mode>(c, t, dk, dv);
    }
  }
  cvt::flash_wait<0>();
  if constexpr (Mode != kStats) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = warp * kWarpKeys + lane / 4 + 8 * i;
      if (key >= c.kc) continue;
      bf16* row = c.o_base + (long long)(key0 + key) * c.stride + 2 * (lane % 4);
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        if (nb * 8 >= dh) continue;
        *reinterpret_cast<uint32_t*>(row + c.d_model + nb * 8) =
            cvt::flash_pack(dk[nb][2 * i], dk[nb][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(row + 2 * c.d_model + nb * 8) =
            cvt::flash_pack(dv[nb][2 * i], dv[nb][2 * i + 1]);
      }
    }
  }
  cvt_f32::cluster_sync();  // no CTA leaves while another reads its shared memory
}

struct Args {
  const void* qkv;
  const void* grad;
  void* dqkv;
  void* stats;
  void* parts;
  int batch, n, heads, dh, clusters, ctas, warps;
  float scale;
  cudaStream_t stream;
};

template <int Dh, int Mode>
cudaError_t launch_mode(const Args& a) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const auto kernel = attention_bwd_cluster_kernel<Dh, Mode>;
  cudaError_t err = cvt_f32::cluster_config(
      kernel, dim3(a.ctas * a.clusters, a.heads, a.batch), 32 * a.warps, a.ctas,
      smem_bytes<Dh>(a.warps), a.stream, config, attr);
  if (err == cudaSuccess) err = cvt_f32::cluster_fits(kernel, config);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const bf16*>(a.qkv),
                           static_cast<const bf16*>(a.grad), static_cast<bf16*>(a.dqkv),
                           static_cast<float*>(a.stats), static_cast<float*>(a.parts), a.n,
                           a.heads, a.dh, a.clusters, a.scale, a.scale * 1.4426950408889634f);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int Dh>
cudaError_t launch(const Args& a) {
  if (a.clusters == 1) return launch_mode<Dh, kOne>(a);
  cudaError_t err = launch_mode<Dh, kStats>(a);
  if (err != cudaSuccess) return err;
  err = launch_mode<Dh, kSplit>(a);
  if (err != cudaSuccess) return err;
  return cvt_f32::launch_dq_sum(static_cast<const float*>(a.parts), static_cast<bf16*>(a.dqkv),
                                a.batch, a.n, a.heads, a.dh, a.clusters, a.stream);
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim); grad: bf16 (batch, n, heads *
// head_dim); dqkv: bf16, the shape of qkv; all contiguous and 16-byte
// aligned; head_dim a multiple of 8 up to 128, run by the instantiation
// cvt::flash_head_dim names. The plan (ops/attention.long_plan): `clusters` clusters of `ctas`
// CTAs (at most 8) of `warps` warps (at most 9) per (image, head), the
// head's 16-key steps shared out evenly over the clusters * ctas CTAs, none
// holding more than 16 * warps keys or none; a plan that does not fit
// returns cudaErrorInvalidValue. clusters > 1 needs the f32 scratches
// stats (batch, heads, clusters, 3, n) and dq_parts (batch, heads,
// clusters, n, head_dim); clusters == 1 takes null for both. scale: the
// softmax temperature. Returns the first launch error (a cluster that the
// card cannot hold: cudaErrorInvalidConfiguration).
extern "C" int cvt_attention_bwd_long(const void* qkv, const void* grad, void* dqkv, void* stats,
                                      void* dq_parts, int batch, int n, int heads, int head_dim,
                                      int clusters, int ctas, int warps, float scale,
                                      void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535 || clusters < 1 ||
      ctas < 1 || ctas > kMaxCtas || warps < 1 || warps > kMaxWarps ||
      (clusters > 1) != (stats != nullptr && dq_parts != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int steps = (n + kWarpKeys - 1) / kWarpKeys;
  const long long total = (long long)clusters * ctas;
  if (total > steps || (steps + total - 1) / total > warps) return (int)cudaErrorInvalidValue;
  const Args a{qkv,     grad,  dqkv,  stats, dq_parts, batch, n, heads, head_dim, clusters, ctas,
               warps,   scale, static_cast<cudaStream_t>(stream)};
  switch (cvt::flash_head_dim(head_dim)) {
    case 16: return (int)launch<16>(a);
    case 32: return (int)launch<32>(a);
    case 64: return (int)launch<64>(a);
    case 80: return (int)launch<80>(a);
    case 128: return (int)launch<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
