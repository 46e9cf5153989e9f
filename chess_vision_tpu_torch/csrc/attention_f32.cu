// Multi-head attention forward and backward in f32, read straight from the
// packed qkv projection: the f32 forms of K2 and K3.
//
// Replaces the TPU kernels chess_vision_tpu/ops/attention.py
// _kernel_attention (_attn_kernel) and _kernel_attention_bwd
// (_attn_bwd_kernel) for f32 inputs, which the JAX package takes as it takes
// bf16 (its output dtype is qkv.dtype): an f32 model, trained with
// training.mixed_precision=false or served from an f32 checkpoint, runs
// here. For every (image, head), Q, K and V are the column ranges
// [h*Dh, (h+1)*Dh) + {0, D, 2D} of qkv (B, N, 3*D), D = H*Dh; the output
// lands in out (B, N, D) and the gradient in dqkv (B, N, 3*D) at the same
// columns. No permute copy is made.
//
// Arithmetic: IEEE f32 on the CUDA cores (FFMA, accurate expf), no TF32 and
// no bf16 anywhere, as PyTorch leaves cuBLAS's f32 products:
//  forward  (the JAX kernel's) the softmax scale folded into q where it is a
//           power of two (exact: 2^-3 at Dh = 64, applied to the score,
//           which is the same number; 1/sqrt(32) scales the scores), f32
//           scores, p = exp(s - m) unrounded with m the CTA's row max over
//           its keys, the row sum beside P V, the CTAs' sums rescaled by
//           exp(m_cta - m) to the head's row max, floored at 1e-30, one
//           division at the end.
//  backward (reference_attention_bwd's rounding points in f32)
//           s = (q k) * scale, pn = exp(s - m) / l, dV = pn^T g,
//           dP = g v^T, r = rowsum(dP * pn), dS = pn * (dP - r) * scale,
//           dQ = dS K, dK = dS^T Q, each output written once; m, l and
//           r = rowsum(dP * p) / l from the warps' and CTAs' partial
//           statistics, rescaled to the head's row max.
//
// Bound on this card at the training shape (64, 257, 2304): the forward
// reads qkv (152 MB) and writes out (51 MB), 0.061 ms at 3.35 TB/s; its two
// products are 13.0 GFLOP, 0.19 ms at the 67 TFLOP/s of f32 FFMA, so
// operations bound it. The backward's five products (32.5 GFLOP) take 0.49
// ms at that rate against 0.15 ms for its bytes.
//
// Design (attention_f32.cuh): one thread-block cluster of C <= 8 CTAs of 128
// threads per (image, head), the head's 16-key steps shared out evenly
// (ops/attention.f32_plan, f32_key_ranges: C = ceil(steps / 4), at most 64
// keys a CTA; 257 tokens: 5 CTAs of 64, 64, 48, 48 and 33 keys); each CTA
// copies its keys' K and V rows into shared memory once and keeps them while
// the cluster walks the query tiles (64 rows, then 16-row tail tiles), the
// next Q (and g) tile copied by cp.async while this one's last products run.
//  attention_bwd_f32_kernel  (111 KB, two CTAs an SM) per tile: S and dP
//           over the CTA's keys; the warps' (max, exp-sum, rowsum(dP p))
//           combined in the CTA, then across the cluster through distributed
//           shared memory; pn and dS into key-major tiles; dV += pn^T g and
//           dK += dS^T q into registers that live for the launch; the CTA's
//           partial dQ = dS K over pn^T's place, added over the cluster in
//           rank order by the CTA that owns the rows and written once. The
//           function's 5 products, one launch, no scratch in device memory,
//           no atomics.
//  attention_fwd_f32_kernel  (75.5 KB, three CTAs an SM) per tile: S over
//           the CTA's keys; its row max and p = exp(s - m) into a key-major
//           tile, the row sums; the CTA's partial P V over P^T's place; the
//           cluster's partials rescaled to the head's row max and added in
//           rank order, one division; the barrier that frees P^T again is
//           waited for after the next tile's S. A CTA range above 64 keys
//           (N > 512) is walked in 64-key windows with an online max, K and
//           V then copied again for each query tile; no configuration of the
//           repo has such N.
// Timings and bounds are in PERF.md section 6.

#include "attention_f32.cuh"

namespace {

using namespace cvt_f32;

// a probe build's stand-in for a product's scores: values read from the
// operand, so that what follows still runs on data
template <int Rpl>
__device__ __forceinline__ void probe_fill(float (&acc)[Rpl][4], const float* x) {
#pragma unroll
  for (int i = 0; i < Rpl; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = x[4 * i + j];
  }
}

// ----------------------------------------------------------------- backward

template <int Dh>
struct Bwd {
  const float* base;    // the head's q columns of the image
  const float* g_base;  // the head's columns of g
  float* o_base;        // the head's dq columns of dqkv
  float* stats;         // split: the (image, head)'s [G][3][n]
  float* parts;         // split: the (image, head)'s dQ partials [G][n][Dh]
  long long stride;     // 3 D
  int d_model;
  int dh;               // the head's columns (up to Dh; the rest are zero)
  int n;
  int kc;               // this CTA's keys
  int rank;             // in the cluster
  int ctas;             // of the cluster
  int cluster;          // of the head's clusters
  int clusters;
  float scale;
  float* ks;            // K rows of this CTA's keys
  float* vs;
  float* stages;        // the Q tile, then the g tile
  float* pt;            // pn^T (key, row); the dQ partials (split, row, Dh)
  float* dst;           // dS^T (key, row)
  float* wst;           // per-warp (max, exp-sum, rowsum(dP p)) [3][kWarps][64]
  float* cst;           // the CTA's [3][64]
  float* fin;           // the head's (m, l, r) [3][64]
  Tiles tiles;
};

template <int Dh>
__device__ __forceinline__ void bwd_stage(const Bwd<Dh>& c, int t) {
  if (t < c.tiles.count) {
    float* qs = c.stages;
    const int rows = c.tiles.is_full(t) ? kTileRows : kUnitRows;
    stage_rows<Dh>(qs, c.base, c.stride, c.tiles.row0(t), rows, c.n, c.dh);
    stage_rows<Dh>(qs + kTileRows * row_ld<Dh>(), c.g_base, c.d_model, c.tiles.row0(t), rows, c.n,
                   c.dh);
  }
  cvt::flash_commit();
}

// The head's statistics of row r of the tile at row0 from the CTAs' in
// cst: in rank order, each rescaled by exp(m_cta - m). The long modes read
// the cluster's CTAs twice (max, then sums) rather than hold 16 of each.
template <int Dh, int Mode>
__device__ __forceinline__ void head_stats(const Bwd<Dh>& c, int r, float& m, float& l,
                                           float& ra) {
  if constexpr (Mode == kBwdShort) {
    float mk[kMaxCtas], lk[kMaxCtas], rk[kMaxCtas];
    m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCtas; ++k) {
      if (k < c.ctas) {
        const float* cst = cluster_ptr(c.cst, k);
        mk[k] = cst[r];
        lk[k] = cst[kTileRows + r];
        rk[k] = cst[2 * kTileRows + r];
        m = fmaxf(m, mk[k]);
      }
    }
    l = 0.f;
    ra = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCtas; ++k) {
      if (k < c.ctas) {
        const float f = expf(mk[k] - m);
        l = fmaf(lk[k], f, l);
        ra = fmaf(rk[k], f, ra);
      }
    }
  } else {
    m = -INFINITY;
#pragma unroll 4
    for (int k = 0; k < c.ctas; ++k) m = fmaxf(m, cluster_ptr(c.cst, k)[r]);
    l = 0.f;
    ra = 0.f;
#pragma unroll 4
    for (int k = 0; k < c.ctas; ++k) {
      const float* cst = cluster_ptr(c.cst, k);
      const float f = expf(cst[r] - m);
      l = fmaf(cst[kTileRows + r], f, l);
      ra = fmaf(cst[2 * kTileRows + r], f, ra);
    }
  }
}

// Row r of the tile at row0 from the split's scratch: the clusters'
// statistics in cluster order; a row past n gets (0, 1, 0)
template <int Dh>
__device__ __forceinline__ void split_stats(const Bwd<Dh>& c, int r, int row0) {
  float m = 0.f, l = 1.f, ra = 0.f;
  const int row = row0 + r;
  if (row < c.n) {
    m = -INFINITY;
    for (int k = 0; k < c.clusters; ++k) m = fmaxf(m, c.stats[(3 * k) * c.n + row]);
    l = 0.f;
    for (int k = 0; k < c.clusters; ++k) {
      const float f = expf(c.stats[(3 * k) * c.n + row] - m);
      l = fmaf(c.stats[(3 * k + 1) * c.n + row], f, l);
      ra = fmaf(c.stats[(3 * k + 2) * c.n + row], f, ra);
    }
  }
  c.fin[r] = m;
  c.fin[kTileRows + r] = l;
  c.fin[2 * kTileRows + r] = ra / l;
}

template <int Dh, int Rpl, int Mode>
__device__ __forceinline__ void bwd_tile(const Bwd<Dh>& c, int t,
                                         float (&dk)[KeyMap<Dh>::kKeys][KeyMap<Dh>::kCh][4],
                                         float (&dv)[KeyMap<Dh>::kKeys][KeyMap<Dh>::kCh][4]) {
  constexpr int kRows = 8 * Rpl;
  constexpr int kLd = row_ld<Dh>();
  constexpr int kCtasMax = Mode == kBwdShort ? kMaxCtas : kMaxLongCtas;
  using M = KeyMap<Dh>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qg = lane / 4;
  const int kg = lane % 4;
  const bool active = warp * kWarpKeys < c.kc;
  const float* qs = c.stages;
  const float* gs = qs + kTileRows * kLd;

  cvt::flash_wait<0>();  // this tile's copies
  if constexpr (Mode == kBwdSplit) {
    if (threadIdx.x < kRows) split_stats(c, threadIdx.x, c.tiles.row0(t));
  }
  __syncthreads();

  // S and dP over this warp's 16 keys; p = exp(s - the warp's row max)
  // (the split's main pass: the head's row max, from the statistics pass)
  float s[Rpl][4], dp[Rpl][4], mw[Rpl];
  if (active) {
    if (probe(kNoProducts1)) {
      probe_fill(s, qs);
      probe_fill(dp, gs);
    } else {
      rows_by_keys<Dh, Rpl>(s, qs, c.ks + warp * kWarpKeys * kLd, qg, kg);
      rows_by_keys<Dh, Rpl>(dp, gs, c.vs + warp * kWarpKeys * kLd, qg, kg);
    }
#pragma unroll
    for (int i = 0; i < Rpl; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = warp * kWarpKeys + kg + 4 * j < c.kc;
        s[i][j] = ok ? __fmul_rn(s[i][j], c.scale) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      if constexpr (Mode == kBwdSplit) {
        mx = c.fin[qg + 8 * i];
        mw[i] = mx;
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = expf(s[i][j] - mx);
        continue;
      }
      mx = warp_max4(mx);  // finite: the warp holds a key of this CTA
      mw[i] = mx;
      float l = 0.f, ra = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        l += s[i][j];
        ra = fmaf(dp[i][j], s[i][j], ra);
      }
      l = warp_sum4(l);
      ra = warp_sum4(ra);
      if (kg == 0) {
        const int r = qg + 8 * i;
        c.wst[warp * kTileRows + r] = mx;
        c.wst[(kWarps + warp) * kTileRows + r] = l;
        c.wst[(2 * kWarps + warp) * kTileRows + r] = ra;
      }
    }
  } else if (kg == 0 && Mode != kBwdSplit) {
#pragma unroll
    for (int i = 0; i < Rpl; ++i) {
      const int r = qg + 8 * i;
      c.wst[warp * kTileRows + r] = -INFINITY;
      c.wst[(kWarps + warp) * kTileRows + r] = 0.f;
      c.wst[(2 * kWarps + warp) * kTileRows + r] = 0.f;
    }
  }
  if constexpr (Mode != kBwdSplit) {
    __syncthreads();
    if constexpr (Mode == kBwdStats) bwd_stage(c, t + 1);  // the Q and g tiles are read no more
    if (threadIdx.x < kRows) {  // the CTA's statistics of row threadIdx.x
      const int r = threadIdx.x;
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, c.wst[w * kTileRows + r]);
      float l = 0.f, ra = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(c.wst[w * kTileRows + r] - m);  // 0 for a warp without keys
        l = fmaf(c.wst[(kWarps + w) * kTileRows + r], f, l);
        ra = fmaf(c.wst[(2 * kWarps + w) * kTileRows + r], f, ra);
      }
      c.cst[r] = m;
      c.cst[kTileRows + r] = l;
      c.cst[2 * kTileRows + r] = ra;
    }
    if (probe(kNoStats)) {
      __syncthreads();
    } else {
      cluster_sync();
    }
    if (threadIdx.x < kRows) {  // the head's (the cluster's), from every CTA in rank order
      const int r = threadIdx.x;
      float m, l, ra;
      head_stats<Dh, Mode>(c, r, m, l, ra);
      if constexpr (Mode == kBwdStats) {
        const RowShare share(kRows, c.ctas, c.rank, c.tiles.row0(t), c.n);
        if (r >= share.r0 && r < share.r0 + share.rows) {
          float* at = c.stats + (3 * c.cluster) * c.n + share.row0 + r;
          at[0] = m;
          at[c.n] = l;
          at[2 * c.n] = ra;
        }
      } else {
        c.fin[r] = m;
        c.fin[kTileRows + r] = l;
        c.fin[2 * kTileRows + r] = ra / l;
      }
    }
    if constexpr (Mode == kBwdStats) {
      cluster_sync();  // every CTA done with the others' statistics
      return;
    }
    __syncthreads();
  }

  if (active) {
    // pn and dS into this warp's rows of the key-major tiles
#pragma unroll
    for (int i = 0; i < Rpl; ++i) {
      const int r = qg + 8 * i;
      const float f = expf(mw[i] - c.fin[r]) / c.fin[kTileRows + r];
      const float rr = c.fin[2 * kTileRows + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = warp * kWarpKeys + kg + 4 * j;
        const float pn = s[i][j] * f;
        c.pt[key * kLdT + r] = pn;
        c.dst[key * kLdT + r] = pn * (dp[i][j] - rr) * c.scale;
      }
    }
    __syncwarp();
    const int kg2 = lane / M::kDG;
    const int dg = lane % M::kDG;
    if (!probe(kNoProducts2)) {
      keys_by_d<Dh, kRows>(dv, c.pt + warp * kWarpKeys * kLdT, gs, kg2, dg);
      keys_by_d<Dh, kRows>(dk, c.dst + warp * kWarpKeys * kLdT, qs, kg2, dg);
    }
  }
  __syncthreads();
  bwd_stage(c, t + 1);  // the Q and g tiles are read no more

  // this CTA's partial dQ = dS K, in splits of its keys, over pn^T's place
  using SM = SplitMap<Dh, kRows>;
  const SM sm;
#pragma unroll
  for (int it = 0; it < SM::kItems; ++it) {
    if (!sm.has(it)) continue;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
    if (!probe(kNoProducts3)) {
      rows_by_d<Dh>(acc, c.dst, c.ks, sm.begin(c.kc), sm.end(c.kc), sm.qg(it), sm.dc(it));
    }
    float* part = c.pt + sm.offset(it);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(part + i * Dh) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (probe(kNoExchange)) {
    __syncthreads();
  } else {
    cluster_sync();
  }

  // dQ rows of this CTA's share: the partials of every CTA and split, in
  // order (every CTA is done with them before the next tile's statistics
  // barrier, after which pn^T is written again; in the split's main pass,
  // before the barrier that ends the tile)
  const RowShare share(kRows, c.ctas, c.rank, c.tiles.row0(t), c.n);
  for (int e = threadIdx.x; e < share.rows * (Dh / 4); e += kThreads) {
    const int r = share.r0 + e / (Dh / 4);
    const int d = e % (Dh / 4) * 4;
    if (d >= c.dh) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kCtasMax; ++k) {
      if (k < c.ctas && !probe(kNoExchange)) {
        add_partials<Dh, kRows>(sum, cluster_ptr(c.pt, k), r, d);
      }
    }
    if constexpr (Mode == kBwdSplit) {
      *reinterpret_cast<float4*>(
          c.parts + ((long long)c.cluster * c.n + share.row0 + r) * c.dh + d) = sum;
    } else {
      *reinterpret_cast<float4*>(c.o_base + (long long)(share.row0 + r) * c.stride + d) = sum;
    }
  }
  if constexpr (Mode == kBwdSplit) {
    cluster_sync();  // every CTA done with the others' partials
  }
}

// CTAs an SM the kernels ask registers for: up to Dh = 64 the backward two
// (111 KB each) and the forward three (75.5 KB); above, their shared memory
// leaves one or two, and either gets 255 registers a thread
template <int Dh>
constexpr int bwd_min_blocks() {
  return Dh <= 64 ? 2 : 1;
}

template <int Dh>
constexpr int fwd_min_blocks() {
  return Dh <= 64 ? 3 : 2;
}

template <int Dh, int Mode>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<Dh>())
attention_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ grad,
                         float* __restrict__ dqkv, float* __restrict__ stats,
                         float* __restrict__ parts, int n, int heads, int dh, int clusters,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = row_ld<Dh>();
  using M = KeyMap<Dh>;
  Bwd<Dh> c{};
  c.dh = dh;
  c.d_model = heads * dh;
  c.stride = 3LL * c.d_model;
  const long long head = (long long)blockIdx.z * heads + blockIdx.y;
  c.base = qkv + (long long)blockIdx.z * n * c.stride + blockIdx.y * dh;
  c.g_base = grad + (long long)blockIdx.z * n * c.d_model + blockIdx.y * dh;
  c.o_base = dqkv + (long long)blockIdx.z * n * c.stride + blockIdx.y * dh;
  c.clusters = clusters;
  c.stats = Mode >= kBwdStats ? stats + head * clusters * 3 * n : nullptr;
  c.parts = Mode == kBwdSplit ? parts + head * clusters * n * dh : nullptr;
  c.n = n;
  c.ctas = gridDim.x / clusters;
  c.rank = blockIdx.x % c.ctas;
  c.cluster = blockIdx.x / c.ctas;
  int key0;
  cta_keys(n, gridDim.x, blockIdx.x, key0, c.kc);
  c.scale = scale;
  c.ks = smem;
  c.vs = c.ks + kCtaKeys * kLd;
  c.stages = c.vs + kCtaKeys * kLd;
  c.pt = c.stages + 2 * kTileRows * kLd;
  c.dst = c.pt + pt_floats<Dh>();
  c.wst = c.dst + kCtaKeys * kLdT;
  c.cst = c.wst + 3 * kWarps * kTileRows;
  c.fin = c.cst + 3 * kTileRows;
  c.tiles = Tiles(n);

  // K and V once, in the first tile's group
  const int kc_pad = (c.kc + kWarpKeys - 1) / kWarpKeys * kWarpKeys;
  stage_rows<Dh>(c.ks, c.base + c.d_model, c.stride, key0, kc_pad, key0 + c.kc, dh);
  stage_rows<Dh>(c.vs, c.base + 2 * c.d_model, c.stride, key0, kc_pad, key0 + c.kc, dh);
  bwd_stage(c, 0);

  float dk[M::kKeys][M::kCh][4], dv[M::kKeys][M::kCh][4];
#pragma unroll
  for (int j = 0; j < M::kKeys; ++j) {
#pragma unroll
    for (int ch = 0; ch < M::kCh; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][ch][e] = dv[j][ch][e] = 0.f;
    }
  }
  for (int t = 0; t < c.tiles.count; ++t) {
    if (c.tiles.is_full(t)) {
      bwd_tile<Dh, kTileRows / 8, Mode>(c, t, dk, dv);
    } else {
      bwd_tile<Dh, kUnitRows / 8, Mode>(c, t, dk, dv);
    }
  }
  cvt::flash_wait<0>();
  cluster_sync();  // no CTA leaves while another reads its partials
  if constexpr (Mode == kBwdStats) return;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kg = lane / M::kDG;
  const int dg = lane % M::kDG;
#pragma unroll
  for (int j = 0; j < M::kKeys; ++j) {
    const int key = warp * kWarpKeys + kg + M::kKG * j;
    if (key >= c.kc) continue;
    float* row = c.o_base + (long long)(key0 + key) * c.stride;
#pragma unroll
    for (int ch = 0; ch < M::kCh; ++ch) {
      const int d = (dg + M::kDG * ch) * 4;
      if (d >= dh) continue;
      *reinterpret_cast<float4*>(row + c.d_model + d) =
          make_float4(dk[j][ch][0], dk[j][ch][1], dk[j][ch][2], dk[j][ch][3]);
      *reinterpret_cast<float4*>(row + 2 * c.d_model + d) =
          make_float4(dv[j][ch][0], dv[j][ch][1], dv[j][ch][2], dv[j][ch][3]);
    }
  }
}

// ------------------------------------------------------------------ forward

template <int Dh>
struct Fwd {
  const float* base;  // the head's q columns of the image
  float* o_base;      // the head's columns of out
  long long stride;
  int d_model;
  int dh;             // the head's columns (up to Dh; the rest are zero)
  int n;
  int key0;           // this CTA's first key
  int kc;             // its keys (above kCtaKeys: walked in windows)
  int rank;
  int ctas;
  float q_scale;
  float s_scale;
  float* ks;
  float* vs;
  float* stages;      // the Q tile
  float* pt;          // P^T (key, row); then the O partials (split, row, Dh)
  float* wmx;         // per-warp row max [kWarps][64]
  float* wsm;         // per-warp row sum [kWarps][64]
  float* cst;         // the CTA's (max [64], sum [64])
  float* fac;         // per row of the reduction's share: kMaxCtas factors, the sum
  Tiles tiles;
};

template <int Dh>
__device__ __forceinline__ void fwd_stage(const Fwd<Dh>& c, int t) {
  if (t < c.tiles.count) {
    stage_rows<Dh>(c.stages, c.base, c.stride,
                   c.tiles.row0(t), c.tiles.is_full(t) ? kTileRows : kUnitRows, c.n, c.dh);
  }
  cvt::flash_commit();
}

template <int Dh>
__device__ __forceinline__ void fwd_stage_kv(const Fwd<Dh>& c, int w0) {
  const int kw = min(kCtaKeys, c.kc - w0);
  const int rows = (kw + kWarpKeys - 1) / kWarpKeys * kWarpKeys;
  const int first = c.key0 + w0;
  stage_rows<Dh>(c.ks, c.base + c.d_model, c.stride, first, rows, first + kw, c.dh);
  stage_rows<Dh>(c.vs, c.base + 2 * c.d_model, c.stride, first, rows, first + kw, c.dh);
}

// the new running max of a row: the old one and every warp's of this window
__device__ __forceinline__ float window_max(const float* wmx, int r, float m_old) {
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_old = fmaxf(m_old, wmx[w * kTileRows + r]);
  return m_old;
}

template <int Dh, int Rpl>
__device__ void fwd_reduce(const Fwd<Dh>& c, int t);

template <int Dh, int Rpl>
__device__ __forceinline__ void fwd_tile(const Fwd<Dh>& c, int t) {
  constexpr int kRows = 8 * Rpl;
  constexpr int kLd = row_ld<Dh>();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qg = lane / 4;
  const int kg = lane % 4;
  const float* qs = c.stages;
  using SM = SplitMap<Dh, kRows>;
  const SM sm;
  const bool windowed = c.kc > kCtaKeys;

  cvt::flash_wait<0>();
  __syncthreads();
  // running row maxima, as three roles see them (the same values): this
  // lane's rows of S, the 8 rows of each of this thread's cells of O, and
  // row threadIdx.x's sum
  float m_s[Rpl], m_o[SM::kItems][8], m_row = -INFINITY, l_row = 0.f;
  float acc[SM::kItems][8][4];
#pragma unroll
  for (int i = 0; i < Rpl; ++i) m_s[i] = -INFINITY;
#pragma unroll
  for (int it = 0; it < SM::kItems; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m_o[it][i] = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[it][i][e] = 0.f;
    }
  }
  for (int w0 = 0; w0 < c.kc; w0 += kCtaKeys) {
    const int kw = min(kCtaKeys, c.kc - w0);
    if (windowed) {  // this window's K and V, copied for every tile
      __syncthreads();
      fwd_stage_kv(c, w0);
      cvt::flash_commit();
      cvt::flash_wait<0>();
      __syncthreads();
    }
    const bool active = warp * kWarpKeys < kw;
    float s[Rpl][4];
    if (active) {
      if (probe(kNoProducts1)) {
        probe_fill(s, qs);
      } else {
        rows_by_keys<Dh, Rpl>(s, qs, c.ks + warp * kWarpKeys * kLd, qg, kg);
      }
#pragma unroll
      for (int i = 0; i < Rpl; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = warp * kWarpKeys + kg + 4 * j < kw;
          s[i][j] = ok ? __fmul_rn(__fmul_rn(s[i][j], c.q_scale), c.s_scale) : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = warp_max4(mx);
        if (kg == 0) c.wmx[warp * kTileRows + qg + 8 * i] = mx;
      }
    } else if (kg == 0) {
#pragma unroll
      for (int i = 0; i < Rpl; ++i) c.wmx[warp * kTileRows + qg + 8 * i] = -INFINITY;
    }
    __syncthreads();
    if (t > 0 && w0 == 0) cvt::flash_cluster_wait();  // the previous tile's arrive
    if (active) {
#pragma unroll
      for (int i = 0; i < Rpl; ++i) {
        const int r = qg + 8 * i;
        m_s[i] = window_max(c.wmx, r, m_s[i]);
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_s[i]);
          c.pt[(warp * kWarpKeys + kg + 4 * j) * kLdT + r] = p;
          l += p;
        }
        l = warp_sum4(l);
        if (kg == 0) c.wsm[warp * kTileRows + r] = l;
      }
    } else if (kg == 0) {
#pragma unroll
      for (int i = 0; i < Rpl; ++i) c.wsm[warp * kTileRows + qg + 8 * i] = 0.f;
    }
    __syncthreads();
    // O += P V over this thread's split of the window's keys, rescaled to
    // the new row max (by 0 on the first window)
#pragma unroll
    for (int it = 0; it < SM::kItems; ++it) {
      if (!sm.has(it)) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m_new = window_max(c.wmx, 8 * sm.qg(it) + i, m_o[it][i]);
        const float alpha = expf(m_o[it][i] - m_new);
        m_o[it][i] = m_new;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[it][i][e] *= alpha;
      }
      if (!probe(kNoProducts2)) {
        rows_by_d<Dh>(acc[it], c.pt, c.vs, sm.begin(kw), sm.end(kw), sm.qg(it), sm.dc(it));
      }
    }
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      const float m_new = window_max(c.wmx, r, m_row);
      l_row *= expf(m_row - m_new);
      m_row = m_new;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l_row += c.wsm[w * kTileRows + r];
    }
  }
  fwd_stage(c, t + 1);  // the Q tile is read no more
  __syncthreads();      // nor P^T: the partials go in its place
#pragma unroll
  for (int it = 0; it < SM::kItems; ++it) {
    if (!sm.has(it)) continue;
    float* part = c.pt + sm.offset(it);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(part + i * Dh) =
          make_float4(acc[it][i][0], acc[it][i][1], acc[it][i][2], acc[it][i][3]);
    }
  }
  if (threadIdx.x < kRows) {
    c.cst[threadIdx.x] = m_row;
    c.cst[kTileRows + threadIdx.x] = l_row;
  }
  if (probe(kNoExchange)) {  // no reduction, no output
    __syncthreads();
  } else {
    cluster_sync();
    fwd_reduce<Dh, Rpl>(c, t);
  }
  // every CTA done with this CTA's partials: waited for after the next
  // tile's first S product, before P^T is written again
  cvt::flash_cluster_arrive();
}

// output rows of tile t of this CTA's share
template <int Dh, int Rpl>
__device__ void fwd_reduce(const Fwd<Dh>& c, int t) {
  constexpr int kRows = 8 * Rpl;
  const float* parts = c.pt;
  const float* cst = c.cst;
  // output rows of this CTA's share: per row, each CTA's factor
  // exp(m_cta - m) to the head's row max and the floored row sum; then the
  // CTAs' partials rescaled and added in rank order, and one division
  const RowShare share(kRows, c.ctas, c.rank, c.tiles.row0(t), c.n);
  float* fac = c.fac;  // [row of the share][kMaxCtas + 1]
  if (threadIdx.x < share.rows) {
    const int r = share.r0 + threadIdx.x;
    float mk[kMaxCtas], lk[kMaxCtas];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCtas; ++k) {
      if (k < c.ctas) {
        const float* rc = cluster_ptr(cst, k);
        mk[k] = rc[r];
        lk[k] = rc[kTileRows + r];
        m = fmaxf(m, mk[k]);
      }
    }
    float l = 0.f;
    float* f = fac + threadIdx.x * (kMaxCtas + 1);
#pragma unroll
    for (int k = 0; k < kMaxCtas; ++k) {
      if (k < c.ctas) {
        f[k] = expf(mk[k] - m);
        l = fmaf(lk[k], f[k], l);
      }
    }
    f[kMaxCtas] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < share.rows * (Dh / 4); e += kThreads) {
    const int r = share.r0 + e / (Dh / 4);
    const int d = e % (Dh / 4) * 4;
    if (d >= c.dh) continue;
    const float* f = fac + (e / (Dh / 4)) * (kMaxCtas + 1);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxCtas; ++k) {
      if (k < c.ctas) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        add_partials<Dh, kRows>(sum, cluster_ptr(parts, k), r, d);
        o.x = fmaf(sum.x, f[k], o.x);
        o.y = fmaf(sum.y, f[k], o.y);
        o.z = fmaf(sum.z, f[k], o.z);
        o.w = fmaf(sum.w, f[k], o.w);
      }
    }
    const float denom = f[kMaxCtas];
    *reinterpret_cast<float4*>(c.o_base + (long long)(share.row0 + r) * c.d_model + d) =
        make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<Dh>())
attention_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                         int heads, int dh, float q_scale, float s_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = row_ld<Dh>();
  Fwd<Dh> c{};
  c.dh = dh;
  c.d_model = heads * dh;
  c.stride = 3LL * c.d_model;
  c.base = qkv + (long long)blockIdx.z * n * c.stride + blockIdx.y * dh;
  c.o_base = out + (long long)blockIdx.z * n * c.d_model + blockIdx.y * dh;
  c.n = n;
  c.rank = blockIdx.x;
  c.ctas = gridDim.x;
  cta_keys(n, c.ctas, c.rank, c.key0, c.kc);
  c.q_scale = q_scale;
  c.s_scale = s_scale;
  c.ks = smem;
  c.vs = c.ks + kCtaKeys * kLd;
  c.stages = c.vs + kCtaKeys * kLd;
  c.pt = c.stages + kTileRows * kLd;
  c.wmx = c.pt + pt_floats<Dh>();
  c.wsm = c.wmx + kWarps * kTileRows;
  c.cst = c.wsm + kWarps * kTileRows;
  c.fac = c.cst + 2 * kTileRows;
  c.tiles = Tiles(n);

  if (c.kc <= kCtaKeys) fwd_stage_kv(c, 0);  // once, in the first tile's group
  fwd_stage(c, 0);
  for (int t = 0; t < c.tiles.count; ++t) {
    if (c.tiles.is_full(t)) {
      fwd_tile<Dh, kTileRows / 8>(c, t);
    } else {
      fwd_tile<Dh, kUnitRows / 8>(c, t);
    }
  }
  cvt::flash_cluster_wait();  // no CTA leaves while another reads its partials
}

// ------------------------------------------------------------------ launches

template <int Dh>
cudaError_t launch_fwd(const void* qkv, void* out, int batch, int n, int heads, int dh, int ctas,
                       float q_scale, float s_scale, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(attention_fwd_f32_kernel<Dh>, dim3(ctas, heads, batch),
                                   kThreads, ctas, fwd_smem_bytes<Dh>(), stream, config, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, attention_fwd_f32_kernel<Dh>, static_cast<const float*>(qkv),
                            static_cast<float*>(out), n, heads, dh, q_scale, s_scale);
}

template <int Dh>
cudaError_t launch_bwd(const void* qkv, const void* grad, void* dqkv, int batch, int n, int heads,
                       int dh, int ctas, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const auto kernel = attention_bwd_f32_kernel<Dh, kBwdShort>;
  cudaError_t err = cluster_config(kernel, dim3(ctas, heads, batch), kThreads, ctas,
                                   bwd_smem_bytes<Dh>(), stream, config, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(qkv),
                            static_cast<const float*>(grad), static_cast<float*>(dqkv),
                            static_cast<float*>(nullptr), static_cast<float*>(nullptr), n, heads,
                            dh, 1, scale);
}

// One pass of the long route: `clusters` clusters of `ctas` CTAs per
// (image, head) on grid (clusters * ctas, heads, batch).
template <int Dh, int Mode>
cudaError_t launch_bwd_pass(const void* qkv, const void* grad, void* dqkv, void* stats,
                            void* parts, int batch, int n, int heads, int dh, int clusters,
                            int ctas, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const auto kernel = attention_bwd_f32_kernel<Dh, Mode>;
  cudaError_t err = cluster_config(kernel, dim3(clusters * ctas, heads, batch), kThreads, ctas,
                                   bwd_smem_bytes<Dh>(), stream, config, attr);
  if (err == cudaSuccess) err = cluster_fits(kernel, config);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(qkv),
                           static_cast<const float*>(grad), static_cast<float*>(dqkv),
                           static_cast<float*>(stats), static_cast<float*>(parts), n, heads,
                           dh, clusters, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int Dh>
cudaError_t launch_bwd_long(const void* qkv, const void* grad, void* dqkv, void* stats,
                            void* parts, int batch, int n, int heads, int dh, int clusters,
                            int ctas, float scale, cudaStream_t stream) {
  if (clusters == 1) {
    return launch_bwd_pass<Dh, kBwdLong>(qkv, grad, dqkv, nullptr, nullptr, batch, n, heads, dh,
                                         1, ctas, scale, stream);
  }
  cudaError_t err = launch_bwd_pass<Dh, kBwdStats>(qkv, grad, dqkv, stats, parts, batch, n, heads,
                                                   dh, clusters, ctas, scale, stream);
  if (err != cudaSuccess) return err;
  err = launch_bwd_pass<Dh, kBwdSplit>(qkv, grad, dqkv, stats, parts, batch, n, heads, dh,
                                       clusters, ctas, scale, stream);
  if (err != cudaSuccess) return err;
  return launch_dq_sum(static_cast<const float*>(parts), static_cast<float*>(dqkv), batch, n,
                       heads, dh, clusters, stream);
}

bool bad_shape(int batch, int n, int heads) {
  return batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535;
}

}  // namespace

// qkv: f32 (batch, n, 3 * heads * head_dim), contiguous, 16-byte aligned;
// head_dim a multiple of 8 up to 128, run by the instantiation
// cvt::flash_head_dim names (its extra columns zero, never stored).
// out: f32 (batch, n, heads * head_dim). ctas: the CTAs of an (image,
// head)'s cluster (ops/attention.f32_plan; at most 8, each holding at least
// one 16-key step; another count returns cudaErrorInvalidValue). q_scale
// multiplies the scores first, then s_scale (the softmax temperature goes
// in one of them: q_scale where it is a power of two, as the JAX kernel
// folds it). Returns the launch's cudaError_t.
extern "C" int cvt_attention_fwd_f32(const void* qkv, void* out, int batch, int n, int heads,
                                     int head_dim, int ctas, float q_scale, float s_scale,
                                     void* stream) {
  if (bad_shape(batch, n, heads) || !plan_ok(n, ctas, 1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = head_dim;
  switch (cvt::flash_head_dim(dh)) {
    case 16: return (int)launch_fwd<16>(qkv, out, batch, n, heads, dh, ctas, q_scale, s_scale, s);
    case 32: return (int)launch_fwd<32>(qkv, out, batch, n, heads, dh, ctas, q_scale, s_scale, s);
    case 64: return (int)launch_fwd<64>(qkv, out, batch, n, heads, dh, ctas, q_scale, s_scale, s);
    case 80: return (int)launch_fwd<80>(qkv, out, batch, n, heads, dh, ctas, q_scale, s_scale, s);
    case 128:
      return (int)launch_fwd<128>(qkv, out, batch, n, heads, dh, ctas, q_scale, s_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// qkv: f32 (batch, n, 3 * heads * head_dim); grad: f32 (batch, n, heads *
// head_dim); dqkv: f32, the shape of qkv; all contiguous and 16-byte
// aligned. ctas as for the forward, with at most 64 keys a CTA (n <= 512).
// scale: the softmax temperature. One launch. Returns its cudaError_t.
extern "C" int cvt_attention_bwd_f32(const void* qkv, const void* grad, void* dqkv, int batch,
                                     int n, int heads, int head_dim, int ctas, float scale,
                                     void* stream) {
  if (bad_shape(batch, n, heads) || !plan_ok(n, ctas, kCtaKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = head_dim;
  switch (cvt::flash_head_dim(dh)) {
    case 16: return (int)launch_bwd<16>(qkv, grad, dqkv, batch, n, heads, dh, ctas, scale, s);
    case 32: return (int)launch_bwd<32>(qkv, grad, dqkv, batch, n, heads, dh, ctas, scale, s);
    case 64: return (int)launch_bwd<64>(qkv, grad, dqkv, batch, n, heads, dh, ctas, scale, s);
    case 80: return (int)launch_bwd<80>(qkv, grad, dqkv, batch, n, heads, dh, ctas, scale, s);
    case 128: return (int)launch_bwd<128>(qkv, grad, dqkv, batch, n, heads, dh, ctas, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The long route (ops/attention.bwd_route "f32_long", n > 512): the same
// kernel on `clusters` clusters of `ctas` CTAs (at most 16: non-portable
// clusters) per (image, head), the head's 16-key steps shared out evenly
// over the clusters * ctas CTAs, at most 64 keys each
// (ops/attention.long_plan); a plan that does not fit returns
// cudaErrorInvalidValue. One launch for one cluster; for clusters > 1 a
// statistics pass, the main pass and the dQ sum through the f32 scratches
// stats (batch, heads, clusters, 3, n) and dq_parts (batch, heads,
// clusters, n, head_dim), null for one cluster. Returns the first launch
// error (a cluster the card cannot hold: cudaErrorInvalidConfiguration).
extern "C" int cvt_attention_bwd_f32_long(const void* qkv, const void* grad, void* dqkv,
                                          void* stats, void* dq_parts, int batch, int n,
                                          int heads, int head_dim, int clusters, int ctas,
                                          float scale, void* stream) {
  const int steps = (n + kWarpKeys - 1) / kWarpKeys;
  const long long total = (long long)clusters * ctas;
  if (bad_shape(batch, n, heads) || clusters < 1 || ctas < 1 || ctas > kMaxLongCtas ||
      total > steps || (steps + total - 1) / total * kWarpKeys > kCtaKeys ||
      (clusters > 1) != (stats != nullptr && dq_parts != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = head_dim;
  switch (cvt::flash_head_dim(dh)) {
    case 16:
      return (int)launch_bwd_long<16>(qkv, grad, dqkv, stats, dq_parts, batch, n, heads, dh,
                                      clusters, ctas, scale, s);
    case 32:
      return (int)launch_bwd_long<32>(qkv, grad, dqkv, stats, dq_parts, batch, n, heads, dh,
                                      clusters, ctas, scale, s);
    case 64:
      return (int)launch_bwd_long<64>(qkv, grad, dqkv, stats, dq_parts, batch, n, heads, dh,
                                      clusters, ctas, scale, s);
    case 80:
      return (int)launch_bwd_long<80>(qkv, grad, dqkv, stats, dq_parts, batch, n, heads, dh,
                                      clusters, ctas, scale, s);
    case 128:
      return (int)launch_bwd_long<128>(qkv, grad, dqkv, stats, dq_parts, batch, n, heads, dh,
                                       clusters, ctas, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
