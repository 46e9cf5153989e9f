// Multi-head attention backward (K3) at any head dim, bf16 and f32: the
// any-head-dim route's backward kernel (ops/attention.bwd_route "any"). What
// it computes, its arithmetic and its design are in attention_any.cu's
// header; the products and copies it shares with the forward are in
// attention_any.cuh.
//
// Bound on this card at ViT-B/16's width on 3 heads of 256 (64, 257, 2304):
// the five products are 65 GFLOP, 0.066 ms at 989 TFLOP/s in bf16 (0.97 ms
// at 67 TFLOP/s in f32); the call reads qkv and g and writes dqkv, 0.030 ms
// (bf16) at 3.35 TB/s. Operations bound it, and this design does 7 products
// on 16-row and 16-key units (S and dP twice).
//
// A CTA's layout: warp w keeps the dK and dV sums of key block w % kb (16
// keys; kb = keys / 16) by the column part w / kb (bwd_warp_cols columns,
// two parts at 256); the units of the score products (16 keys x 16 rows)
// go to the warps in turn, unit u = key block u % kb, row block u / kb,
// the same in both passes. Shared memory (bwd_smem_bytes): K, V, the Q and
// g tile, pn^T and dS^T (key-major), the received dQ slices, the row
// statistics.

#include "attention_any.cuh"

namespace cvt_any {
namespace {

// What a launch of the backward does: the whole backward in one cluster
// (kOne); or, for a head split over several clusters, each cluster's row
// statistics into the scratch (kStats), then the backward against the
// clusters' statistics combined, with each cluster's dQ into the partials
// scratch (kSplit), which any_dq_sum_kernel adds.
enum Mode { kOne = 0, kStats = 1, kSplit = 2 };

__device__ __forceinline__ float max_over_keys(float x) {  // over the 8 lanes of a t group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float sum_over_keys(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

__device__ __forceinline__ void tile_sync() {  // every CTA of the cluster
  if (probe(kNoExchange)) {
    __syncthreads();
  } else {
    cvt_f32::cluster_sync();
  }
}

// the cluster's CTA k, or this CTA itself in a probe build without the exchange
__device__ __forceinline__ int peer(int k, int rank) { return probe(kNoExchange) ? rank : k; }

// kDeep: a depth above 256 (DP is 256 then), which the tiles hold a window
// at a time. Each query tile walks the windows in order, copying the tile's
// Q and g columns and the CTA's K and V columns of each, and sums every
// unit's S^T and dP^T over them into shared memory, which both passes then
// read (the same bits); then it copies the chunk's window of Q, g and K
// again for dV, dK and dQ where that was not the last. Nothing stays
// resident from tile to tile and no copy runs under the products.
template <typename T, int DP, bool kDeep>
__global__ void __launch_bounds__(32 * kBwdWarps, bwd_min_ctas(sizeof(T), DP))
any_bwd_kernel(const Call a, int mode) {
  constexpr int RT = bwd_rows(sizeof(T), DP);  // query rows a tile
  constexpr int CW = bwd_warp_cols(DP);
  constexpr int CQ = bwd_dq_cols(DP);
  constexpr int P = row_pad(sizeof(T));
  constexpr int LT = RT + P;  // a key-major (key, row) tile's row
  constexpr int LR = DP + 4;  // a received dQ row (f32)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nkb = a.keys / 16;  // key blocks a CTA holds
  const int depth = a.depth;
  const int ld = any_window(depth) + P;
  const int b = blockIdx.z;
  const int h = blockIdx.y / a.chunks;
  const int c0 = blockIdx.y % a.chunks * DP;
  const int cols = min(DP, a.dh - c0);  // the chunk's columns
  const int cb = kDeep ? 0 : c0;         // and where they start in a tile
  const int n = a.n;
  const int d_model = a.heads * a.dh;
  const long long rs = 3LL * d_model;
  const int rank = blockIdx.x % a.ctas;
  const int cluster = blockIdx.x / a.ctas;
  int key0, kc;
  cvt_f32::cta_keys(n, gridDim.x, blockIdx.x, key0, kc);
  kc = max(kc, 0);  // a plan of more CTAs than 16-key steps leaves the last ones none
  const int live_kb = (kc + 15) / 16;  // key blocks with keys

  const T* base = static_cast<const T*>(a.qkv) + (long long)b * n * rs + (long long)h * a.dh;
  const T* gbase = static_cast<const T*>(a.grad) + (long long)b * n * d_model + (long long)h * a.dh;
  T* obase = static_cast<T*>(a.out) + (long long)b * n * rs + (long long)h * a.dh;
  float* stats = mode == kOne ? nullptr
                              : a.stats + ((long long)b * a.heads * a.chunks + blockIdx.y) *
                                              a.clusters * 3 * n;
  float* parts = mode == kSplit ? a.parts + ((long long)b * a.heads + h) * a.clusters * n * a.dh
                                : nullptr;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + a.keys * ld;
  T* qs = vs + a.keys * ld;
  T* gs = qs + RT * ld;
  T* pt = gs + RT * ld;      // pn^T rounded to T: [key][row]
  T* dt = pt + a.keys * LT;  // dS^T
  // the sets of received dQ slices [bufs][RT + kMaxCtas][LR] and of the
  // CTA's row statistics [bufs][RT] (l, ra, m): tile tt uses set tt % bufs
  float* recvs = reinterpret_cast<float*>(dt + a.keys * LT);
  float4* csts = reinterpret_cast<float4*>(recvs + a.bufs * (RT + kMaxCtas) * LR);
  float* wst = reinterpret_cast<float*>(csts + a.bufs * RT);  // key blocks' [3][nkb][RT]: m, l, ra
  float* fin = wst + 3 * nkb * RT;                            // the head's [3][RT]: shift, 1 / l, r
  float* sums = fin + 3 * RT;  // kDeep: each unit's S^T and dP^T, [unit][16][32 lanes]

  const int ntiles = (n + RT - 1) / RT;
  const bool whole = whole_copies(a.wbytes, a.dh);
  const auto stage = [&](int tt) {  // tile tt's Q and g rows; one commit group
    if (!kDeep && tt < ntiles && (tt == 0 || !probe(kNoCopies))) {
      if (whole) {
        copy_rows16(qs, ld, base, rs, tt * RT, RT, n, depth);
        copy_rows16(gs, ld, gbase, (long long)d_model, tt * RT, RT, n, depth);
      } else {
        copy_rows(qs, ld, base, rs, tt * RT, RT, n, depth, a.dh, a.wbytes);
        copy_rows(gs, ld, gbase, (long long)d_model, tt * RT, RT, n, depth, a.dh, a.wbytes);
      }
    }
    cvt::flash_commit();
  };
  // K and V of the CTA's keys once, with tile 0 in the first group
  if constexpr (!kDeep) {
    copy_rows(ks, ld, base + d_model, rs, key0, 16 * live_kb, key0 + kc, depth, a.dh, a.wbytes);
    copy_rows(vs, ld, base + 2 * d_model, rs, key0, 16 * live_kb, key0 + kc, depth, a.dh,
              a.wbytes);
  }
  stage(0);

  const Softmax<T> sm{a.scale, a.scale_log2};
  const int units = nkb * (RT / 16);
  // kDeep: tile tt's windows, each unit's S^T and dP^T summed over them
  const auto deep_scores = [&](int tt, int urows) {
    const int windows = (depth + kMaxCols - 1) / kMaxCols;
    const int own = c0 / kMaxCols;  // the chunk's window
    const bool again = own != windows - 1 && mode != kStats;
    for (int wi = 0; wi < windows + again; ++wi) {
      const int w0 = (wi < windows ? wi : own) * kMaxCols;
      const int ww = min(kMaxCols, depth - w0);
      __syncthreads();  // every warp is done with the last window
      if (tt == 0 || wi == 0 || !probe(kNoCopies)) {
        copy_rows(qs, ld, base + w0, rs, tt * RT, RT, n, ww, a.dh - w0, a.wbytes);
        copy_rows(gs, ld, gbase + w0, (long long)d_model, tt * RT, RT, n, ww, a.dh - w0, a.wbytes);
        copy_rows(ks, ld, base + d_model + w0, rs, key0, 16 * live_kb, key0 + kc, ww, a.dh - w0,
                  a.wbytes);
        if (wi < windows) {
          copy_rows(vs, ld, base + 2 * d_model + w0, rs, key0, 16 * live_kb, key0 + kc, ww,
                    a.dh - w0, a.wbytes);
        }
      }
      cvt::flash_commit();
      cvt::flash_wait<0>();
      __syncthreads();
      if (wi == windows || probe(kNoScores)) continue;
      for (int u = warp; u < units; u += warps) {
        if (u % nkb >= live_kb || 16 * (u / nkb) >= urows) continue;
        float* at = sums + u * 16 * 32 + lane;
        float s[2][4], dp[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i / 4][i % 4] = wi ? at[32 * i] : 0.f;
          dp[i / 4][i % 4] = wi ? at[32 * (8 + i)] : 0.f;
        }
        dot2(s, ks + 16 * (u % nkb) * ld, qs + 16 * (u / nkb) * ld, dp, vs + 16 * (u % nkb) * ld,
             gs + 16 * (u / nkb) * ld, ld, ww, lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          at[32 * i] = s[i / 4][i % 4];
          at[32 * (8 + i)] = dp[i / 4][i % 4];
        }
      }
    }
    __syncthreads();
  };
  // a unit's S^T and dP^T: from the windows' sums (kDeep), else one walk
  // over the depth
  const auto unit_scores = [&](int u, float(&s)[2][4], float(&dp)[2][4], bool skip) {
    if constexpr (kDeep) {
      const float* at = sums + u * 16 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i / 4][i % 4] = at[32 * i];
        dp[i / 4][i % 4] = at[32 * (8 + i)];
      }
    } else {
      zero(s);
      zero(dp);
      if (!skip) {
        dot2(s, ks + 16 * (u % nkb) * ld, qs + 16 * (u / nkb) * ld, dp, vs + 16 * (u % nkb) * ld,
             gs + 16 * (u / nkb) * ld, ld, depth, lane);
      }
    }
  };
  const int wkb = warp % nkb;  // this warp's dK / dV: key block and column part
  const int wcp = warp / nkb;
  const bool owns = wkb < live_kb && wcp * CW < cols;
  // whether the dQ rows go out 4 columns at a time (16-byte f32 partials or
  // 8-byte bf16 stores on their boundaries)
  const bool vec = cols % 4 == 0 && a.dh % 4 == 0 &&
                   (mode == kSplit || reinterpret_cast<uintptr_t>(obase + c0) % (4 * sizeof(T)) == 0);
  float dk[CW / 8][4], dv[CW / 8][4];
  zero(dk);
  zero(dv);
  // the dQ rows of tile tt that this CTA owns: every CTA's slice, in rank
  // order (4 columns a thread where the columns and the addresses allow it)
  const int per = (RT + a.ctas - 1) / a.ctas;  // rows of a CTA's share
  const auto reduce = [&](int tt) {
    const int row0 = tt * RT;
    const float* recv = recvs + tt % a.bufs * (RT + kMaxCtas) * LR;
    const cvt_f32::RowShare share(RT, a.ctas, rank, row0, n);
    const int rows = probe(kNoReduce) ? 0 : share.rows;
    if (vec) {
      for (int e = threadIdx.x; e < rows * (cols / 4); e += blockDim.x) {
        const int slot = e / (cols / 4);
        const int d = e % (cols / 4) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < a.ctas; ++k) {
          const float4 v = ld4(recv + (k * per + slot) * LR + d);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        const int row = row0 + share.r0 + slot;
        if (mode == kOne) {
          cvt_f32::store4(obase + (long long)row * rs + c0 + d, sum);
        } else {
          cvt_f32::store4(parts + ((long long)cluster * n + row) * a.dh + c0 + d, sum);
        }
      }
    } else {
      for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
        const int slot = e / cols;
        const int d = e % cols;
        float sum = 0.f;
        for (int k = 0; k < a.ctas; ++k) sum += recv[(k * per + slot) * LR + d];
        const int row = row0 + share.r0 + slot;
        if (mode == kOne) {
          obase[(long long)row * rs + c0 + d] = narrow<T>(sum);
        } else {
          parts[((long long)cluster * n + row) * a.dh + c0 + d] = sum;
        }
      }
    }
  };

  for (int tt = 0; tt < ntiles; ++tt) {
    const int row0 = tt * RT;
    const int urows = min(RT, (n - row0 + 15) / 16 * 16);  // the tile's rows in 16-row blocks
    float* recv = recvs + tt % a.bufs * (RT + kMaxCtas) * LR;
    float4* cst = csts + tt % a.bufs * RT;
    cvt::flash_wait<0>();
    __syncthreads();  // the tile's Q and g rows
    if constexpr (kDeep) deep_scores(tt, urows);
    if (mode != kSplit) {
      // pass 1: S^T and dP^T of each unit, the rows' statistics over its keys
      for (int u = warp; u < units; u += warps) {
        const int kb = u % nkb;
        const int rb = u / nkb;
        if (kb >= live_kb || 16 * rb >= urows) continue;
        float s[2][4], dp[2][4];
        unit_scores(u, s, dp, probe(kNoScores));
        const bool lo_ok = 16 * kb + g < kc;
        const bool hi_ok = 16 * kb + g + 8 < kc;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // row 16 rb + 8 nb + 2 t + e: keys g (e), g + 8 (e + 2)
            const float v0 = lo_ok ? sm.score(s[nb][e]) : -INFINITY;
            const float v1 = hi_ok ? sm.score(s[nb][e + 2]) : -INFINITY;
            const float mm = max_over_keys(fmaxf(v0, v1));  // finite: key 16 kb is the CTA's
            const float sh = sm.shift(mm);
            const float p0 = sm.p(v0, sh);
            const float p1 = sm.p(v1, sh);
            const float ll = sum_over_keys(p0 + p1);
            const float ra = sum_over_keys(fmaf(dp[nb][e], p0, dp[nb][e + 2] * p1));
            if (g == 0) {
              const int r = 16 * rb + 8 * nb + 2 * t + e;
              wst[kb * RT + r] = mm;
              wst[(nkb + kb) * RT + r] = ll;
              wst[(2 * nkb + kb) * RT + r] = ra;
            }
          }
        }
      }
      __syncthreads();
      if (mode == kStats) stage(tt + 1);  // Q and g are read no more
      for (int r = threadIdx.x; r < urows; r += blockDim.x) {  // over the CTA's key blocks
        float mm = -INFINITY;
        for (int kb = 0; kb < live_kb; ++kb) mm = fmaxf(mm, wst[kb * RT + r]);
        float ll = 0.f, ra = 0.f;
        for (int kb = 0; kb < live_kb; ++kb) {
          const float f = sm.factor(wst[kb * RT + r], mm);
          ll = fmaf(wst[(nkb + kb) * RT + r], f, ll);
          ra = fmaf(wst[(2 * nkb + kb) * RT + r], f, ra);
        }
        cst[r] = make_float4(ll, ra, mm, 0.f);
      }
      tile_sync();
      // over the cluster's CTAs: w lanes a row (the CTAs rounded up to a power
      // of two), lane k reading CTA k's (one remote load each, kU rows' in
      // flight together), combined by a fixed xor tree (the max, then the
      // sums brought to it)
      constexpr int kU = sizeof(T) == 2 ? 4 : 2;
      const cvt_f32::RowShare share(RT, a.ctas, rank, row0, n);
      int w = 1;
      while (w < a.ctas) w <<= 1;
      const int k = lane % w;
      const float4* from = cvt_f32::cluster_ptr(cst, peer(k < a.ctas ? k : 0, rank));
      const int stride = 32 / w * warps;  // rows a pass
      for (int base = warp * (32 / w); base < urows; base += kU * stride) {
        float4 v[kU];
#pragma unroll
        for (int x = 0; x < kU; ++x) {
          const int r = base + x * stride + lane / w;
          v[x] = k < a.ctas && r < urows ? from[r] : make_float4(0.f, 0.f, -INFINITY, 0.f);
        }
#pragma unroll
        for (int x = 0; x < kU; ++x) {
          const int r = base + x * stride + lane / w;
          float mm = v[x].z;
          for (int y = 1; y < w; y <<= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, y));
          const float f = v[x].z == -INFINITY ? 0.f : sm.factor(v[x].z, mm);  // 0: no keys
          float ll = v[x].x * f, ra = v[x].y * f;
          for (int y = 1; y < w; y <<= 1) {
            ll += __shfl_xor_sync(0xffffffffu, ll, y);
            ra += __shfl_xor_sync(0xffffffffu, ra, y);
          }
          if (k != 0 || r >= urows) continue;
          if (mode == kStats) {
            if (r >= share.r0 && r < share.r0 + share.rows) {
              float* at = stats + 3LL * cluster * n + row0 + r;
              at[0] = mm;
              at[n] = ll;
              at[2 * n] = ra;
            }
          } else {
            fin[r] = sm.shift(mm);
            fin[RT + r] = 1.f / ll;
            fin[2 * RT + r] = ra * (1.f / ll);
          }
        }
      }
      if (mode == kStats) {
        if (a.bufs == 1) tile_sync();  // every CTA done with the others' statistics
        continue;
      }
    } else {
      // the clusters' statistics from the scratch, in cluster order; a row
      // past n gets (0, 1, 0)
      for (int r = threadIdx.x; r < urows; r += blockDim.x) {
        const int row = row0 + r;
        float mm = 0.f, ll = 1.f, ra = 0.f;
        if (row < n) {
          mm = -INFINITY;
          for (int k = 0; k < a.clusters; ++k) mm = fmaxf(mm, stats[3LL * k * n + row]);
          ll = 0.f;
          for (int k = 0; k < a.clusters; ++k) {
            if (stats[3LL * k * n + row] == -INFINITY) continue;  // a cluster without keys
            const float f = sm.factor(stats[3LL * k * n + row], mm);
            ll = fmaf(stats[(3LL * k + 1) * n + row], f, ll);
            ra = fmaf(stats[(3LL * k + 2) * n + row], f, ra);
          }
        }
        fin[r] = sm.shift(mm);
        fin[RT + r] = 1.f / ll;
        fin[2 * RT + r] = ra * (1.f / ll);
      }
      tile_sync();  // every CTA done with the last tile's dQ slices
    }
    // two sets: the last tile's slices, in place since this tile's barrier
    if (a.bufs == 2 && tt > 0) reduce(tt - 1);
    __syncthreads();

    // pass 2: the same units with the same operands: pn^T and dS^T
    for (int u = warp; u < units; u += warps) {
      const int kb = u % nkb;
      const int rb = u / nkb;
      if (kb >= live_kb || 16 * rb >= urows) continue;
      float s[2][4], dp[2][4];
      unit_scores(u, s, dp, probe(kNoValues));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int key = 16 * kb + g + 8 * hi;
          const bool ok = key < kc;
          const int r = 16 * rb + 8 * nb + 2 * t;
          float pn[2], ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float p = sm.p(sm.score(s[nb][2 * hi + x]), fin[r + x]) * fin[RT + r + x];
            pn[x] = ok ? p : 0.f;
            ds[x] = ok ? sm.ds(p, dp[nb][2 * hi + x], fin[2 * RT + r + x]) : 0.f;
          }
          store_pair(pt + key * LT + r, pn[0], pn[1]);
          store_pair(dt + key * LT + r, ds[0], ds[1]);
        }
      }
    }
    __syncthreads();  // pn^T and dS^T whole

    // dV += pn^T g and dK += dS^T Q over the tile's rows
    if (owns && !probe(kNoOuter)) {
      outer_rm<CW / 8>(dv, pt + 16 * wkb * LT, LT, gs + cb + wcp * CW, ld, urows, cols - wcp * CW,
                       lane);
      outer_rm<CW / 8>(dk, dt + 16 * wkb * LT, LT, qs + cb + wcp * CW, ld, urows, cols - wcp * CW,
                       lane);
    }
    __syncthreads();  // Q and g read no more
    stage(tt + 1);    // the next tile's copies run under the dQ product

    // the CTA's partial dQ = dS K, 16 rows by CQ columns a unit, each row's
    // slice stored into the shared memory of the CTA that owns the row
    for (int u = warp; u < RT / 16 * (DP / CQ); u += warps) {
      const int rb = u / (DP / CQ);
      const int cq = u % (DP / CQ);
      if (16 * rb >= urows || cq * CQ >= cols || probe(kNoDq)) continue;
      float acc[CQ / 8][4];
      zero(acc);
      outer_tm<CQ / 8>(acc, dt + 16 * rb, LT, ks + cb + cq * CQ, ld, 16 * live_kb, cols - cq * CQ,
                       lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * rb + g + 8 * i;
        const int owner = r / per;
        float* row = cvt_f32::cluster_ptr(recv, peer(owner, rank)) +
                     (rank * per + r - owner * per) * LR + cq * CQ + 2 * t;
#pragma unroll
        for (int nb = 0; nb < CQ / 8; ++nb) {
          if (cq * CQ + 8 * nb < cols) {
            *reinterpret_cast<float2*>(row + 8 * nb) = make_float2(acc[nb][2 * i], acc[nb][2 * i + 1]);
          }
        }
      }
    }
    if (a.bufs == 1) {
      tile_sync();  // every CTA's slices in place
      reduce(tt);
    }
  }
  cvt::flash_wait<0>();
  if (mode != kStats && a.bufs == 2) {
    tile_sync();  // the last tile's slices in place
    reduce(ntiles - 1);
  }
  if (mode != kStats && owns) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = 16 * wkb + g + 8 * i;
      if (key >= kc) continue;
      T* row = obase + (long long)(key0 + key) * rs + c0 + wcp * CW + 2 * t;
#pragma unroll
      for (int nb = 0; nb < CW / 8; ++nb) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (wcp * CW + 8 * nb + 2 * t + x < cols) {
            row[d_model + 8 * nb + x] = narrow<T>(dk[nb][2 * i + x]);
            row[2 * d_model + 8 * nb + x] = narrow<T>(dv[nb][2 * i + x]);
          }
        }
      }
    }
  }
  tile_sync();  // no CTA leaves while another may read its shared memory
}

// A split backward's dQ: parts (batch, heads, clusters, n, head_dim) added in
// cluster order into the head's dq columns of dqkv. Grid (row groups, heads,
// batch), an element a thread.
template <typename T>
__global__ void __launch_bounds__(256)
any_dq_sum_kernel(const float* __restrict__ parts, T* __restrict__ dqkv, int n, int heads, int dh,
                  int clusters) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * dh) return;
  const int row = idx / dh;
  const int d = idx % dh;
  const long long head = (long long)blockIdx.z * heads + blockIdx.y;
  const float* at = parts + (head * clusters * n + row) * dh + d;
  float sum = 0.f;
  for (int k = 0; k < clusters; ++k) sum += at[(long long)k * n * dh];
  dqkv[((long long)blockIdx.z * n + row) * 3 * heads * dh + (long long)blockIdx.y * dh + d] =
      narrow<T>(sum);
}

template <typename T, int DP, bool kDeep>
cudaError_t launch_mode(const Call& a, int batch, int mode, cudaStream_t stream) {
  const auto kernel = any_bwd_kernel<T, DP, kDeep>;
  const int threads = 32 * (a.keys / 16) * (DP / bwd_warp_cols(DP));
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cvt_f32::cluster_config(
      kernel, dim3(a.ctas * a.clusters, a.heads * a.chunks, batch), threads, a.ctas,
      bwd_smem_bytes(sizeof(T), DP, a.depth, a.keys, a.bufs), stream, config, attr);
  if (err == cudaSuccess) err = cvt_f32::cluster_fits(kernel, config);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, kernel, a, mode);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int DP, bool kDeep = false>
cudaError_t launch_bwd(const Call& a, int batch, cudaStream_t stream) {
  if (a.clusters == 1) return launch_mode<T, DP, kDeep>(a, batch, kOne, stream);
  cudaError_t err = launch_mode<T, DP, kDeep>(a, batch, kStats, stream);
  if (err == cudaSuccess) err = launch_mode<T, DP, kDeep>(a, batch, kSplit, stream);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const dim3 grid((a.n * a.dh + threads - 1) / threads, a.heads, batch);
  any_dq_sum_kernel<T><<<grid, threads, 0, stream>>>(a.parts, static_cast<T*>(a.out), a.n, a.heads,
                                                     a.dh, a.clusters);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const Call& a, int batch, cudaStream_t s) {
  switch (any_cols(a.dh)) {
    case 16: return launch_bwd<T, 16>(a, batch, s);
    case 32: return launch_bwd<T, 32>(a, batch, s);
    case 64: return launch_bwd<T, 64>(a, batch, s);
    case 128: return launch_bwd<T, 128>(a, batch, s);
    default:
      return a.depth > kMaxCols ? launch_bwd<T, 256, true>(a, batch, s)
                                : launch_bwd<T, 256>(a, batch, s);
  }
}

}  // namespace
}  // namespace cvt_any

// qkv as for cvt_attention_fwd_any; grad: the output's cotangent, (batch, n,
// heads * head_dim), the same dtype, contiguous; dqkv: the shape of qkv. The
// plan (ops/attention.any_bwd_plan): `clusters` clusters of `ctas` CTAs (at
// most 16) per (image, head, column chunk), the head's 16-key steps shared
// out evenly over the clusters * ctas CTAs, none holding more than `keys`
// keys (a multiple of 16 up to bwd_max_keys, within the shared memory); a
// CTA past the last step holds none. clusters > 1 needs the f32 scratches stats (batch, heads * chunks,
// clusters, 3, n) and dq_parts (batch, heads, clusters, n, head_dim);
// clusters == 1 takes null for both and runs one launch. A plan that does
// not fit returns cudaErrorInvalidValue; a cluster that the card cannot hold
// cudaErrorInvalidConfiguration.
extern "C" int cvt_attention_bwd_any(const void* qkv, const void* grad, void* dqkv, void* stats,
                                     void* dq_parts, int batch, int n, int heads, int head_dim,
                                     int f32, int clusters, int ctas, int keys, float scale,
                                     void* stream) {
  using namespace cvt_any;
  if (batch < 1 || n < 1 || heads < 1 || head_dim < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int es = f32 ? 4 : 2;
  const int depth = any_depth(head_dim);
  const int dp = any_cols(head_dim);
  const int chunks = any_chunks(head_dim);
  const int steps = (n + 15) / 16;
  const long long total = (long long)clusters * ctas;
  // keys within bwd_max_keys fit the shared memory at every head dim (every_plan_fits)
  if ((long long)heads * chunks > 65535 || keys < 16 || keys % 16 || keys > bwd_max_keys(dp) ||
      ctas < 1 || ctas > kMaxCtas || clusters < 1 || (steps + total - 1) / total * 16 > keys ||
      (clusters > 1) != (stats != nullptr && dq_parts != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Call a{};
  a.qkv = qkv;
  a.grad = grad;
  a.out = dqkv;
  a.stats = static_cast<float*>(stats);
  a.parts = static_cast<float*>(dq_parts);
  a.n = n;
  a.heads = heads;
  a.dh = head_dim;
  a.depth = depth;
  a.chunks = chunks;
  a.wbytes = copy_bytes(qkv, grad, head_dim, es);
  a.keys = keys;
  a.bufs = bwd_bufs(es, dp, depth, keys);
  a.ctas = ctas;
  a.clusters = clusters;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? dispatch_bwd<float>(a, batch, s) : dispatch_bwd<bf16>(a, batch, s));
}
