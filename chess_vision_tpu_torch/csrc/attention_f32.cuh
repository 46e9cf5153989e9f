// The skeleton of the f32 attention kernels (attention_f32.cu, K2 and K3 on
// f32 inputs): a thread-block cluster per (image, head) whose CTAs split the
// head's keys into contiguous ranges of at most kCtaKeys (cta_keys), each
// CTA holding its keys' K and V rows in shared memory for the whole launch
// while the cluster walks the query rows in tiles. Row statistics and
// partial sums cross the cluster through distributed shared memory, always
// added in rank order, so every output is the same twice, bit for bit.
//
// Work layout (128 threads, 4 warps, a CTA; two or three CTAs share an SM,
// each hiding the others' barriers and latencies):
//  - products over the head dim (S = q k^T, dP = g v^T): warp w owns the
//    CTA's keys [16 w, 16 w + 16); lane = 4 qg + kg holds rows qg + 8 i of
//    the tile (i < 8, or 2 in a 16-row tail tile) by keys kg + 4 j (j < 4):
//    an 8 x 4 register tile read as 16-byte vectors along the head dim.
//    A warp whose 16 keys all lie past the CTA's range skips the products,
//    so keys cost work in steps of 16, and query tiles are 64 rows with a
//    tail of 16-row tiles: 257 tokens compute 272 x 272, not 320 x 320.
//  - products over the query rows (dV += pn^T g, dK += dS^T q): the same
//    warp's 16 keys by the head dim, from its own rows of the key-major
//    pn^T / dS^T tiles (4 keys x 8 columns a lane at Dh = 64).
//  - products over the keys (dQ = dS K, O = P V): 8 rows x 4 columns a
//    thread, the CTA's keys cut into kThreads / (rows / 8 * Dh / 4) even
//    splits (one at Dh = 64 on a 64-row tile), one partial a split; the
//    reduction adds the cluster's partials.
// Shared-memory rows are padded so that the 16-byte reads of a quarter warp
// fall in distinct banks or are broadcasts: row-major (row, Dh) rows by 4
// floats (an odd number of 16-byte units apart), key-major (key, 64 rows)
// rows by 8 (so the scalar stores of pn^T and dS^T hit 32 distinct banks).
// Copies from device memory are cp.async, 16 bytes a thread.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_loop.cuh"

namespace cvt_f32 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = 16;                  // keys a warp owns; the key granularity
constexpr int kCtaKeys = kWarps * kWarpKeys;   // 64 keys a CTA holds
// the portable cluster size; the backward's cluster route takes
// kMaxCtas * kCtaKeys = 512 tokens (ops/attention.F32_MAX_TOKENS); the
// forward walks a longer range in 64-key windows
constexpr int kMaxCtas = 8;
// the backward's long route (attention_f32.cu, cvt_attention_bwd_f32_long):
// clusters of up to 16 CTAs (non-portable, as H100 launches them), 1,024
// tokens; above that the head's keys split over several clusters
constexpr int kMaxLongCtas = 16;
// What a launch of the backward kernel does: kBwdShort the one-cluster route
// of up to kMaxCtas CTAs; kBwdLong one cluster of up to kMaxLongCtas;
// kBwdStats / kBwdSplit the statistics and main passes of a head split over
// several clusters (their statistics and dQ partials through f32 scratches).
enum BwdMode { kBwdShort = 0, kBwdLong = 1, kBwdStats = 2, kBwdSplit = 3 };
constexpr int kTileRows = 64;                  // query rows of a tile
constexpr int kUnitRows = 16;                  // query rows of a tail tile
constexpr int kLdT = kTileRows + 8;            // a key-major (key, rows) tile's row

template <int Dh>
__host__ __device__ constexpr int row_ld() {
  return Dh + 4;
}

// Floats of the key-major P^T / pn^T tile, whose place the products over the
// keys reuse for their partials: kCtaKeys x kLdT, or a 64-row tile's
// partials (one split, 64 x Dh) where that is more (Dh > 72).
template <int Dh>
__host__ __device__ constexpr int pt_floats() {
  return kCtaKeys * kLdT > kTileRows * Dh ? kCtaKeys * kLdT : kTileRows * Dh;
}

// Shared memory of the backward: K, V (kCtaKeys rows each), the Q and g
// tiles (one stage: the next tile's copies start when this one's last
// product over the rows is done), pn^T (the dQ partials reuse its place)
// and dS^T, per-warp row statistics (3 x kWarps x 64), the CTA's (3 x 64)
// and the head's (3 x 64). 111 KB at Dh = 64: two CTAs an SM; 129,536
// bytes at Dh = 80 and 190,976 at 128: one.
template <int Dh>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 4 * (2 * kCtaKeys * row_ld<Dh>() + 2 * kTileRows * row_ld<Dh>() + pt_floats<Dh>() +
              kCtaKeys * kLdT + 3 * kWarps * kTileRows + 6 * kTileRows);
}

// Shared memory of the forward: K, V, the Q tile, P^T (the O partials
// reuse its place), per-warp row maxima and sums, the CTA's (max, sum) per
// row, and the reduction's per-row factors. 75.5 KB at Dh = 64: three CTAs
// an SM; 89,856 bytes at Dh = 80 (two) and 139,008 at 128 (one).
template <int Dh>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 4 * (2 * kCtaKeys * row_ld<Dh>() + kTileRows * row_ld<Dh>() + pt_floats<Dh>() +
              2 * kWarps * kTileRows + 2 * kTileRows + kTileRows * (kMaxCtas + 1));
}

constexpr int kMaxSmemBytes = 232448;  // the dynamic shared memory a block may have
static_assert(bwd_smem_bytes<128>() <= kMaxSmemBytes && fwd_smem_bytes<128>() <= kMaxSmemBytes,
              "a CTA's shared memory exceeds the block limit");  // the largest head dim

// Timing-only builds (experiments/kernel_ab.py --sections f32probes) define
// CVT_F32_PROBE to take one part out of the kernels; their outputs are wrong.
#ifndef CVT_F32_PROBE
#define CVT_F32_PROBE 0
#endif
enum Probe { kNoProbe, kNoProducts1, kNoProducts2, kNoProducts3, kNoExchange, kNoStats };
__host__ __device__ constexpr bool probe(Probe p) { return CVT_F32_PROBE == p; }

// The query tiles of n rows: 64-row tiles, then 16-row tiles for the rest.
struct Tiles {
  int full = 0;
  int count = 0;
  __device__ Tiles() {}
  __device__ explicit Tiles(int n)
      : full(n / kTileRows),
        count(n / kTileRows + (n % kTileRows + kUnitRows - 1) / kUnitRows) {}
  __device__ int row0(int t) const {
    return t < full ? t * kTileRows : full * kTileRows + (t - full) * kUnitRows;
  }
  __device__ bool is_full(int t) const { return t < full; }
};

// rows [row0, row0 + rows) x Dh of src (row stride `stride` floats) into dst
// (rows of row_ld<Dh>), by cp.async; rows at or past `limit` and columns at
// or past dh (a head dim run on the next larger instantiation) become zeros
template <int Dh>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride,
                                           int row0, int rows, int limit, int dh) {
  constexpr int kChunks = Dh / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const bool ok = row0 + r < limit && c < dh;
    cvt::flash_cp16(dst + r * row_ld<Dh>() + c,
                    ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// acc[i][j] = sum_d a[(qg + 8 i) * ld + d] * b[(kg + 4 j) * ld + d]: the
// rows of a tile by a warp's 16 keys (b points at the warp's first key row)
template <int Dh, int Rpl>
__device__ __forceinline__ void rows_by_keys(float (&acc)[Rpl][4], const float* a, const float* b,
                                             int qg, int kg) {
  constexpr int kLd = row_ld<Dh>();
#pragma unroll
  for (int i = 0; i < Rpl; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < Dh; d += 4) {
    float4 x[Rpl];
    float4 y[4];
#pragma unroll
    for (int i = 0; i < Rpl; ++i) x[i] = *reinterpret_cast<const float4*>(a + (qg + 8 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (kg + 4 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < Rpl; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
}

// Lanes over a warp's 16 keys by the head dim: lane = kKG-group kg times
// kDG + dg; keys kg + kKG j (j < kKeys), 16-byte columns dg + kDG c (c < kCh).
// kDG: the 16-byte columns' largest power of two up to 8 that divides
// them (Dh = 80: 4 groups of 5 columns, 8 groups of 2 keys).
template <int Dh>
struct KeyMap {
  static constexpr int kLow = (Dh / 4) & -(Dh / 4);
  static constexpr int kDG = kLow < 8 ? kLow : 8;
  static constexpr int kKG = 32 / kDG;
  static constexpr int kKeys = kWarpKeys / kKG;
  static constexpr int kCh = Dh / 4 / kDG;
};

// acc[j][c][e] += sum_{q < Rows} at[(kg + kKG j) * kLdT + q] * b[q * ld + (dg + kDG c) * 4 + e]:
// a warp's keys (at: its first key-major row) by the head dim, over the rows
template <int Dh, int Rows>
__device__ __forceinline__ void keys_by_d(float (&acc)[KeyMap<Dh>::kKeys][KeyMap<Dh>::kCh][4],
                                          const float* at, const float* b, int kg, int dg) {
  using M = KeyMap<Dh>;
  constexpr int kLd = row_ld<Dh>();
#pragma unroll 2
  for (int q = 0; q < Rows; q += 4) {
    float4 x[M::kKeys];
#pragma unroll
    for (int j = 0; j < M::kKeys; ++j) {
      x[j] = *reinterpret_cast<const float4*>(at + (kg + M::kKG * j) * kLdT + q);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 y[M::kCh];
#pragma unroll
      for (int c = 0; c < M::kCh; ++c) {
        y[c] = *reinterpret_cast<const float4*>(b + (q + e) * kLd + (dg + M::kDG * c) * 4);
      }
#pragma unroll
      for (int j = 0; j < M::kKeys; ++j) {
        const float xe = e == 0 ? x[j].x : e == 1 ? x[j].y : e == 2 ? x[j].z : x[j].w;
#pragma unroll
        for (int c = 0; c < M::kCh; ++c) {
          acc[j][c][0] = fmaf(xe, y[c].x, acc[j][c][0]);
          acc[j][c][1] = fmaf(xe, y[c].y, acc[j][c][1]);
          acc[j][c][2] = fmaf(xe, y[c].z, acc[j][c][2]);
          acc[j][c][3] = fmaf(xe, y[c].w, acc[j][c][3]);
        }
      }
    }
  }
}

// acc[i][e] += sum_{k0 <= k < k1} at[k * kLdT + 8 qg + i] * b[k * ld + 4 dc + e]:
// 8 rows by 4 columns over a range of keys
template <int Dh>
__device__ __forceinline__ void rows_by_d(float (&acc)[8][4], const float* at, const float* b,
                                          int k0, int k1, int qg, int dc) {
  constexpr int kLd = row_ld<Dh>();
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(at + k * kLdT + 8 * qg);
    const float4 x1 = *reinterpret_cast<const float4*>(at + k * kLdT + 8 * qg + 4);
    const float4 y = *reinterpret_cast<const float4*>(b + k * kLd + 4 * dc);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(xs[i], y.x, acc[i][0]);
      acc[i][1] = fmaf(xs[i], y.y, acc[i][1]);
      acc[i][2] = fmaf(xs[i], y.z, acc[i][2]);
      acc[i][3] = fmaf(xs[i], y.w, acc[i][3]);
    }
  }
}

// The thread's places in a product over the keys for a tile of Rows rows:
// cells of 8 rows by a 16-byte column, kGroups of them. Fewer cells than
// threads: kSplits splits of the CTA's keys, a thread one cell of one split
// (threads past kSplits * kGroups idle: Dh = 80 on a 16-row tile). More
// (Dh > 64 on a 64-row tile): one split, a thread kItems cells, item i the
// cell threadIdx.x + i kThreads where it exists.
template <int Dh, int Rows>
struct SplitMap {
  static constexpr int kGroups = Rows / 8 * Dh / 4;
  static constexpr int kSplits = kGroups < kThreads ? kThreads / kGroups : 1;
  static constexpr int kItems = (kGroups + kThreads - 1) / kThreads;
  int split, cell;
  __device__ SplitMap()
      : split(kSplits > 1 ? threadIdx.x / kGroups : 0),
        cell(kSplits > 1 ? threadIdx.x % kGroups : threadIdx.x) {}
  // whether item i is a cell of this thread's (always, where the cells
  // divide the threads)
  __device__ bool has(int i) const {
    if (kThreads % kGroups == 0 || kGroups % kThreads == 0) return true;
    return split < kSplits && cell + i * kThreads < kGroups;
  }
  __device__ int qg(int i) const { return (cell + i * kThreads) / (Dh / 4); }
  __device__ int dc(int i) const { return (cell + i * kThreads) % (Dh / 4); }
  // this split's keys of `keys`, cut evenly
  __device__ int begin(int keys) const { return min(keys, split * ((keys + kSplits - 1) / kSplits)); }
  __device__ int end(int keys) const {
    return min(keys, (split + 1) * ((keys + kSplits - 1) / kSplits));
  }
  // where item i's 8 rows go in a set of partials laid out (split, row, Dh)
  __device__ int offset(int i) const { return (split * Rows + 8 * qg(i)) * Dh + 4 * dc(i); }
};

__device__ __forceinline__ float warp_max4(float x) {  // over the 4 lanes of a kg group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float warp_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a generic pointer to `local`'s place in the shared memory of the
// cluster's CTA `rank`: plain loads through it, which the compiler may issue
// together (they follow a cluster_sync, whose barrier orders them), or
// plain stores (which the next cluster_sync makes visible to that CTA)
template <typename T>
__device__ __forceinline__ T* cluster_ptr(T* local, int rank) {
  uint64_t remote;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(remote) : "l"(reinterpret_cast<uint64_t>(local)), "r"(rank));
  return reinterpret_cast<T*>(remote);
}

// The rows of a tile whose outputs this CTA adds up and writes: an even
// share of the tile's rows by rank, less those at or past n.
struct RowShare {
  int r0;    // first row of the share, in the tile
  int rows;  // rows of the share that are tokens
  int row0;  // the tile's first token
  __device__ RowShare(int tile_rows, int ctas, int rank, int tile_row0, int n) : row0(tile_row0) {
    const int per = (tile_rows + ctas - 1) / ctas;
    r0 = min(tile_rows, rank * per);
    rows = max(0, min(min(tile_rows, r0 + per), n - tile_row0) - r0);
  }
};

// sum += row r's 16-byte column d of every split's partial, in split order
// (parts: a CTA's partials, laid out (split, row, Dh))
template <int Dh, int Rows>
__device__ __forceinline__ void add_partials(float4& sum, const float* parts, int r, int d) {
  constexpr int kSplits = SplitMap<Dh, Rows>::kSplits;
  float4 v[kSplits];
#pragma unroll
  for (int sp = 0; sp < kSplits; ++sp) {
    v[sp] = *reinterpret_cast<const float4*>(parts + (sp * Rows + r) * Dh + d);
  }
#pragma unroll
  for (int sp = 0; sp < kSplits; ++sp) {
    sum.x += v[sp].x;
    sum.y += v[sp].y;
    sum.z += v[sp].z;
    sum.w += v[sp].w;
  }
}

// every thread of the cluster: what each wrote to shared memory before is
// visible to all after (a CTA barrier too)
__device__ __forceinline__ void cluster_sync() {
  cvt::flash_cluster_arrive();
  cvt::flash_cluster_wait();
}

// The launch of `kernel` on `grid`, `threads` a block, whose CTAs form
// clusters of `cluster_x` along x (beyond the portable 8, up to 16); sets
// its shared memory. Returns the error.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, dim3 grid, int threads, int cluster_x, int smem_bytes,
                           cudaStream_t stream, cudaLaunchConfig_t& config,
                           cudaLaunchAttribute& attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  if (cluster_x > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_x;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaSuccess;
}

// Whether the card can hold one cluster of `config`'s launch at all
// (cudaOccupancyMaxActiveClusters): the long routes refuse a cluster that
// fits nowhere (cudaErrorInvalidConfiguration) before anything runs.
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel, const cudaLaunchConfig_t& config) {
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  return clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// The long routes' split (a head's keys over several clusters): dQ of
// (image, head, row) = the clusters' partials parts (batch, heads, clusters,
// n, head_dim), added in cluster order, written at the head's dq columns of
// dqkv (batch, n, 3 * heads * head_dim) in T. Grid (row groups, heads,
// batch), 4 columns a thread.
template <typename T>
__global__ void __launch_bounds__(256)
dq_sum_kernel(const float* __restrict__ parts, T* __restrict__ dqkv, int n, int heads,
              int head_dim, int clusters) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * head_dim / 4) return;
  const int row = idx / (head_dim / 4);
  const int d = idx % (head_dim / 4) * 4;
  const long long head = (long long)blockIdx.z * heads + blockIdx.y;
  const float* at = parts + (head * clusters * n + row) * head_dim + d;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < clusters; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(at + (long long)k * n * head_dim);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  store4(dqkv + ((long long)blockIdx.z * n + row) * 3 * heads * head_dim + blockIdx.y * head_dim + d,
         sum);
}

template <typename T>
cudaError_t launch_dq_sum(const float* parts, T* dqkv, int batch, int n, int heads, int head_dim,
                          int clusters, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((n * head_dim / 4 + threads - 1) / threads, heads, batch);
  dq_sum_kernel<T><<<grid, threads, 0, stream>>>(parts, dqkv, n, heads, head_dim, clusters);
  return cudaGetLastError();
}

// The keys of the cluster's CTA `rank` of `ctas`: the n tokens' 16-key
// steps shared out evenly, the first n % ctas CTAs taking one step more; the
// last step may be short. [key0, key0 + kc).
__host__ __device__ inline void cta_keys(int n, int ctas, int rank, int& key0, int& kc) {
  const int steps = (n + kWarpKeys - 1) / kWarpKeys;
  const int base = steps / ctas;
  const int extra = steps % ctas;
  key0 = (rank * base + (rank < extra ? rank : extra)) * kWarpKeys;
  const int end = key0 + (base + (rank < extra ? 1 : 0)) * kWarpKeys;
  kc = (end < n ? end : n) - key0;
}

// Whether ctas CTAs make a cluster for n tokens: at most kMaxCtas, each
// holding at least one 16-key step and at most max_keys keys.
inline bool plan_ok(int n, int ctas, int max_keys) {
  const int steps = (n + kWarpKeys - 1) / kWarpKeys;
  return ctas >= 1 && ctas <= kMaxCtas && ctas <= steps &&
         (steps + ctas - 1) / ctas * kWarpKeys <= max_keys;
}

}  // namespace cvt_f32
