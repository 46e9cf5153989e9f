// int8 x int8 -> int32 GEMM with the int8 serving path's epilogues.
//
// Replaces the TPU kernels of chess_vision_tpu/ops/int8_matmul.py:
//   K8  int8_matmul_gelu_quant      yq, ys = rowquant(gelu(y))
//   K9  int8_matmul_res_ln_quant    x' = bf16(res + y); yq, ys = rowquant(LN(x'))
//   K10 int8_matmul_res             x' = bf16(res + y)
// and their flat twins K11-K13, which are the same math on (M, K) rows,
// where y = f32(xq @ wq) * xs * ws + bias. K8 also takes the JAX package's
// bf16 epilogue (CHESS_VISION_EPILOGUE=bf16, gelu 3-5: the GELU in bf16,
// rowquant.cuh gelu_bf16, the amax in bf16, the codes from f32); the JAX
// flat kernel K11 has no such epilogue, and the flat layout never asks it. It also serves the qkv product,
// which the JAX package leaves to XLA (quant.py quant_dense_q): bf16(y).
//
// Bound on this card: at the ViT-B serving shapes (M = 256 * 257 rows, K and
// O of 768 or 3072) the products are 78-310 GOP per call against 50-250 MB
// of operands, far above the ~600 operations per byte where int8 tensor
// cores rather than HBM become the limit: compute-bound (0.04-0.16 ms at
// 1,979 TOP/s), but for K9 at 768 -> 768, whose residual, x' and codes make
// it bound by its 304 MB (0.091 ms at 3.35 TB/s).
//
// Design. The split kernel (int8_wgmma_kernel) runs qkv, K8 and the
// two-launch route; its body is the device code of int8_gemm.cuh
// (wgmma_produce, wgmma_consume), through which the whole-block kernel
// (fused_block.cu) runs its four products too:
//  - the product runs on wgmma.mma_async m64n256k32 s8 x s8 -> s32, both
//    operands read from shared memory through descriptors. xq (M, K) and the
//    weight (O, K) are K-major as stored, which is what int8 wgmma takes: no
//    transpose anywhere;
//  - operands arrive by TMA (one tensor map each, encoded in the entry point;
//    cuTensorMapEncodeTiled is reached through the runtime's
//    cudaGetDriverEntryPoint, so the library links without -lcuda) in the
//    128-byte swizzled layout the descriptors name, 128 bytes of K per
//    stage, into a ring of 4 stages of 40 KB (A 64 x 128, B 256 x 128) with
//    an mbarrier full/empty pair per stage. TMA was taken over cp.async
//    because it zero-fills the ragged M, O and K edges by itself and costs
//    the consumers no instruction or register;
//  - a block is one producer warp (in a warpgroup that gives its registers
//    away with setmaxnreg) and two consumer warpgroups. The grid is
//    persistent, one block per SM, walking the 64 x 256 output tiles column
//    tiles fastest (blocks on the card at one time share their rows of xq in
//    L2). The two consumer warpgroups take the block's tiles in turns
//    ("ping-pong"): a named barrier pair lets only one of them run its main
//    loop at a time, so one warpgroup's epilogue runs under the other's
//    products, and the producer's loads for the next tile run under both;
//  - the epilogue is per element from the accumulator registers: y in f32
//    with every product and sum an explicit round-to-nearest intrinsic (no
//    FMA contraction), in the JAX order ((acc * xs) * ws) + bias, then
//    bias-only -> bf16, or residual -> bf16. int32 sums are exact in any
//    order, so the outputs equal those of an mma.sync loop bit for bit;
//  - K8 ends in an abs-max over the whole output row (3,072 columns), which
//    one tile does not see, and its codes must come from the f32 values. It
//    is one sweep, launched cooperatively (every block resident): the grid is
//    groups of as many blocks as the row has column tiles (12), a group
//    computes the tiles of one 64-row panel at the same time, each warp
//    keeps its part of gelu(y) as f32 in shared memory, folds its rows'
//    maxima into an f32 (M,) vector with atomicMax on the bit pattern (exact
//    and order-independent for non-negative floats: still deterministic),
//    counts itself in a per-panel counter, waits for the panel's other warps
//    and quantizes from shared memory with rowquant.cuh's formula: GELU and
//    product once, no f32 (M, 3072) round trip through device memory (1.8 GB,
//    0.54 ms at 3.35 TB/s before any arithmetic). The room for the f32 tiles
//    (144 KB) comes out of the ring: K8's stages hold 64 bytes of K (64-byte
//    swizzle), 80 KB in all. The exchange goes through L2 and not through a
//    thread block cluster's shared memory: 12 blocks of one cluster fit the
//    card 7 times (84 of 132 SMs by cudaOccupancyMaxActiveClusters, 16 blocks
//    112), groups of 12 blocks of a cooperative grid 11 times (all 132);
//  - K10 and K9 have a kernel of their own (int8_res_kernel) on the same
//    main loop (tile_products) and roles, with another epilogue and walk.
//    The tile's residual arrives by TMA into the consuming warpgroup's x'
//    tile (64 x 256 bf16 in shared memory: four slices of 64 columns in the
//    128-byte swizzle) while the products run; the epilogue adds y to it
//    straight from the accumulator registers and writes x' over it (in the
//    swizzle a group's 32 four-byte words fall in 32 banks), and x' leaves by
//    TMA store. Both copies, and their waits, belong to one thread of the
//    producer's warpgroup (res_io): cp.async.bulk.wait_group in the
//    consumers' code, like a cluster barrier there, makes ptxas hold the
//    consumers far below setmaxnreg's 232 registers, and they spilled.
//    Without the per-warp staging tiles the ring keeps 4 stages.
//    K10 is one block per SM walking the tiles as the split kernel does;
//  - K9 (residual + LayerNorm + requant) needs the whole row of x' as
//    stored. The ceil(O/256) blocks that compute one 64-row panel form a
//    thread-block cluster, rank c holding column tile c (3 blocks at
//    O = 768; 39 such clusters fit the card, 117 of its 132 SMs). After a
//    warpgroup's epilogue each of its warps counts itself in every block's
//    staged barrier (release and acquire at cluster scope); the cluster's
//    warps split the panel's rows and run rowquant.cuh's row arithmetic
//    (rowquant_rows_with, up to 6 rows of a warp interleaved), chunk c of a
//    row read from rank c's x' tile in distributed shared memory (mapa,
//    ld.shared::cluster), so every value lands in the lane and every sum
//    runs in the order of the parent's row pass: x', yq and ys equal it bit
//    for bit. Each warp then counts itself in every block's freed barrier,
//    which res_io waits for before the next residual overwrites the tile. The
//    block's column scales and biases wait in shared memory: read from device
//    memory, the epilogue's 64 loads a tile took most of its time.
//    Rows wider than 8 column tiles (O > 2048) take the two-launch route:
//    the split kernel, then rowquant.cuh's row pass.
// ptxas -v (CUDA 12.8, -O3): see chip_smoke.py's build phase; every kernel
// is compiled for 168 registers at launch (384 threads), consumers 232 after
// setmaxnreg; the split kernels spill 20 bytes in the residual epilogue, the
// residual kernels none. Shared memory: the split kernels 160 KB of ring and
// 38 KB of warp staging (K8: 80 KB and 145 KB); the residual kernels 160 KB
// of ring, 64 KB of x' tiles, 2 KB of column vectors, their barriers.
// Measured (NVIDIA H100 80GB HBM3, 700 W; M = 65,792; the parent's time and
// torch._int_mm's for the bare product in brackets; experiments/kernel_ab.py
// in turns): qkv 0.31 ms (0.31; 0.42), K9 proj 0.232 (0.225; 0.14), K9 fc2
// 0.382 (0.402; 0.42), K10 0.282 (0.340; 0.42), K8 0.89 (0.89; 0.54). K8 is
// bound by its epilogue, not by the products: 0.70 ms with the hard GELU (no
// exponential, no division), 0.88 with sigmoid, 1.00 with erf. Two other K8
// designs were measured on the same loop: the product twice (row maxima in a
// first sweep, codes in a second, nothing kept) 1.17 ms; one sweep with
// gelu(y) held in the accumulator registers across the exchange, its
// epilogue unrolled over all 128 of them, 1.12. K9's LayerNorm costs the
// fused kernel 0.09 ms at proj and 0.08 at fc2 (CVT_GEMM_PROBE 3), more than
// the separate row pass took (0.06): four warps an SM run it, under the
// other warpgroup's products, where that pass ran at full occupancy; its
// rows are latency-bound, hence the 6 rows a warp interleaved. Weight tiles
// shared by two row panels through TMA multicast (clusters of 2 x 3 blocks,
// 17 on the card) ran slower than clusters of 3 and were dropped (PERF.md).
// Not yet done (later work): 16-byte stores of K8's codes; a ring as deep as
// the other epilogues' for K8 (a slice of gelu(y) in registers).

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemm.cuh"
#include "rowquant.cuh"

using namespace cvt;

namespace {

template <int Epi, int Gelu>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const WgArgs p) {
  extern __shared__ uint8_t ring_raw[];
  __shared__ __align__(8) uint64_t full_bar[kRing];
  __shared__ __align__(8) uint64_t empty_bar[kRing];
  GemmRing ring = ring_init(ring_raw, full_bar, empty_bar);
  __syncthreads();
  wgmma_product<Epi, Gelu>(&map_a, &map_b, p, ring);
}

int persistent_blocks() {
  static int blocks = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 0;
    }
    return sms;  // 160 KB of shared memory: one block per SM
  }();
  return blocks;
}

template <int Epi, int Gelu = kGeluErf>
cudaError_t launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b, const WgArgs& a,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_wgmma_kernel<Epi, Gelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg_smem_bytes(Epi));
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((a.m + kTileM - 1) / kTileM) * (long long)((a.o + kTileN - 1) / kTileN);
  const int sms = persistent_blocks();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  int8_wgmma_kernel<Epi, Gelu><<<grid, kWgThreads, wg_smem_bytes(Epi), stream>>>(map_a, map_b,
                                                                                  a);
  return cudaGetLastError();
}

// K8: groups of tiles_n blocks, as many as the card holds at once, in one
// cooperative launch (the blocks of a group wait for each other's row maxima,
// so all must be resident). a.amax and a.arrived are zeroed by the caller.
template <int Gelu>
cudaError_t launch_gelu_quant(const CUtensorMap& map_a, const CUtensorMap& map_b,
                              const WgArgs& a, cudaStream_t stream) {
  auto kernel = int8_wgmma_kernel<kWgGeluQuant, Gelu>;
  constexpr int kSmemBytes = wg_smem_bytes(kWgGeluQuant);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads,
                                                           kSmemBytes)) != cudaSuccess) {
    return err;
  }
  const int tiles_n = (a.o + kTileN - 1) / kTileN;
  const long long panels = (a.m + kTileM - 1) / kTileM;
  long long groups = (long long)persistent_blocks() * per_sm / tiles_n;
  if (!coop || groups < 1) return cudaErrorInvalidValue;  // a row wider than the card
  if (groups > panels) groups = panels;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * tiles_n));
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, a);
}

// ---- K9 on thread-block clusters, K10 in one kernel (the design: this file's header) ----

constexpr int kClusterMax = 8;  // blocks in the largest portable cluster
constexpr int kResStages = kRing;
constexpr int kXSliceBytes = kTileM * 128;       // 64 rows x 64 columns of bf16: a TMA box
constexpr int kXTileBytes = 4 * kXSliceBytes;    // a warpgroup's 64 x 256 tile of bf16

constexpr int kColBytes = 2 * kTileN * 4;  // K9: the column tile's scales and biases (f32)
constexpr int kResBars = 2 * kResStages + 8;

// The ring, the two x' tiles, the column vectors and the barriers, all in
// dynamic shared memory (no static shared memory: the dynamic memory then
// starts 1024-aligned, as the ring and the swizzled tiles need, and no
// alignment slack is spent; the kernel traps where it does not).
__host__ __device__ constexpr int res_smem_bytes() {
  return kResStages * ring_stage_bytes(kWgRes) + 2 * kXTileBytes + kColBytes + 8 * kResBars;
}
static_assert(res_smem_bytes() <= 232448, "a block's shared memory");

// The routes of the residual epilogues. K10 takes kRouteTiles (one kernel,
// one block per SM, no cluster), K9 kRouteCluster while its row of column
// tiles fits one cluster; the two-launch route (the split kernel, then for
// K9 the row pass) takes K9 above that, and both in the timing-only builds
// kProbe 1 and 2, which time the split kernel.
enum ResRoute : int { kRouteTwoLaunch = 0, kRouteTiles = 1, kRouteCluster = 2 };

__host__ __device__ constexpr int res_route(int epilogue, int tiles_n) {
  return kProbe == 1 || kProbe == 2  ? kRouteTwoLaunch
         : epilogue == kEpiRes        ? kRouteTiles
         : tiles_n <= kClusterMax     ? kRouteCluster
                                      : kRouteTwoLaunch;
}

// K9's kernel for a row of tiles_n column tiles: the LayerNorm's chunks a
// lane (kCh >= tiles_n; one kernel each, so that only the one the row needs
// is compiled into it).
constexpr int res_chunks(int tiles_n) { return tiles_n <= 4 ? tiles_n : kClusterMax; }

struct LnArgs {
  const float* g;  // (o,)
  const float* b;  // (o,)
  float eps;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared address in the block of cluster rank `rank` of what lies at
// `addr` in this block.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// Arrive, with release at cluster scope, on the mbarrier at `bar` in the
// block of cluster rank `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_map(bar, rank))
               : "memory");
}

// mbar_wait with acquire at cluster scope: what the blocks that arrived wrote
// before their arrival is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The output tiles a block takes, in its order. K10 (no cluster): tile
// blockIdx.x + i * gridDim.x of the row-major tile grid, column tiles
// fastest, as tile_walk. K9 (kCluster): the grid is clusters of tiles_n
// blocks, the block of cluster rank r takes column tile r of panels q,
// q + clusters, ... of its cluster q: the blocks of a cluster take the tiles
// of one panel at the same time, and as many tiles each.
template <bool kCluster>
struct ResWalk {
  long long count;
  long long first;
  long long stride;
  int tiles_n;
  int rank;
  __device__ long long panel(long long i) const {
    return kCluster ? first + i * stride : (first + i * stride) / tiles_n;
  }
  __device__ int col_tile(long long i) const {
    return kCluster ? rank : (int)((first + i * stride) % tiles_n);
  }
};

template <bool kCluster>
__device__ __forceinline__ ResWalk<kCluster> res_walk(const WgArgs& p) {
  ResWalk<kCluster> w;
  w.tiles_n = (p.o + kTileN - 1) / kTileN;
  const long long panels = (p.m + kTileM - 1) / kTileM;
  long long items;
  if constexpr (kCluster) {
    w.rank = (int)cluster_rank();
    w.first = blockIdx.x / w.tiles_n;
    w.stride = gridDim.x / w.tiles_n;
    items = panels;
  } else {
    w.rank = 0;
    w.first = blockIdx.x;
    w.stride = gridDim.x;
    items = panels * w.tiles_n;
  }
  w.count = w.first < items ? (items - w.first + w.stride - 1) / w.stride : 0;
  return w;
}

// A block's shared memory (res_smem_bytes): the ring, the two warpgroups'
// x' tiles, each four 1024-aligned slices of 64 columns in the 128-byte
// swizzle (make_map_bf16), K9's column vectors, the barriers.
struct ResSmem {
  uint8_t* base;    // the ring, generic
  float* cols;      // K9: scales, then biases, of the block's column tile
  uint32_t ring;    // its shared address
  uint32_t full0;   // kResStages full barriers, 8 bytes apart
  uint32_t empty0;  // kResStages empty barriers
  uint32_t res0;    // per warpgroup: its residual tile has arrived
  uint32_t ready0;  // per warpgroup: its x' tile is written
  uint32_t staged0; // per warpgroup: the x' tiles of its panel are in the cluster's blocks
  uint32_t freed0;  // per warpgroup: the cluster's blocks have read its x' tile
  __device__ uint8_t* xtile(int wg) const {
    return base + kResStages * ring_stage_bytes(kWgRes) + wg * kXTileBytes;
  }
};

// The producer (thread 256): the ring of A (the tile's panel) and B (its
// column tile), as wgmma_produce.
template <bool kCluster>
__device__ __forceinline__ void res_produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                            const ResWalk<kCluster>& w, int ksteps,
                                            const ResSmem& sm) {
  if (threadIdx.x != 256) return;
  constexpr int kABytes = kTileM * kStageK;
  constexpr int kStageBytes = ring_stage_bytes(kWgRes);
  uint32_t step = 0;
  for (long long i = 0; i < w.count; ++i) {
    const int m0 = (int)w.panel(i) * kTileM;
    const int n0 = w.col_tile(i) * kTileN;
    for (int ks = 0; ks < ksteps; ++ks, ++step) {
      const uint32_t stage = step % kResStages;
      mbar_wait(sm.empty0 + 8 * stage, ((step / kResStages) & 1u) ^ 1u);
      mbar_expect_tx(sm.full0 + 8 * stage, kStageBytes);
      const uint32_t dst = sm.ring + stage * kStageBytes;
      tma_load_2d(dst, map_a, sm.full0 + 8 * stage, ks * kStageK, m0);
      tma_load_2d(dst + kABytes, map_b, sm.full0 + 8 * stage, ks * kStageK, n0);
    }
  }
}

// Byte offset in an x' tile of 16-byte chunk k (columns 8k .. 8k + 7) of
// row r: slice k / 8, chunk k % 8 of the row's 128 bytes, swizzled.
__device__ __forceinline__ int xtile_offset(int r, int k) {
  return (k / 8) * kXSliceBytes + r * 128 + (((k % 8) ^ (r % 8)) << 4);
}

// The residual epilogue of one warp's 16 rows straight from the accumulator
// registers: a lane holds rows g and g + 8 (g = lane / 4) and columns
// 8nb + 2t, + 1 (t = lane % 4) of each group nb of 8; it reads their
// residual from the warpgroup's x' tile xt, where res_io has loaded it, and
// writes x' = bf16(res + y) over it, y = ((acc * xs) * ws) + bias as
// tile_epilogue computes it. In the swizzle the 32 lanes' 4-byte words of
// one group fall in 32 different banks. xs0 and xs1: the rows' scales,
// loaded before the products.
template <bool kSharedCols>
__device__ __forceinline__ void tile_epilogue_regs(const WgArgs& p, const int (&acc)[128],
                                                   int n0, int warp, int lane, float xs0,
                                                   float xs1, uint8_t* xt, const float* cols) {
  const int g = lane / 4;
  const int t = lane % 4;
  const int r = warp * 16 + g;  // and r + 8, the same row of the swizzle
  // opaque to the compiler each tile: on a cluster a block's columns are the
  // same in every tile, and the addresses below would be hoisted out of the
  // tile loop, live through the products, and spill
  const float* ws = kSharedCols ? cols : p.ws + n0;
  const float* bias = kSharedCols ? cols + kTileN : p.bias + n0;
  uint8_t* words = xt + 4 * t;
  asm volatile("" : "+l"(ws), "+l"(bias), "+l"(words));
#pragma unroll
  for (int nb = 0; nb < kTileN / 8; ++nb) {
    if (n0 + nb * 8 >= p.o) break;  // o % 8 == 0: a group of 8 columns is in or out
    const int col = nb * 8 + 2 * t;  // in the tile
    // shared memory where the tile's columns stay (K9): from device memory
    // the 64 loads a tile took most of the epilogue's time
    const float2 w = kSharedCols ? *reinterpret_cast<const float2*>(ws + col)
                                 : __ldg(reinterpret_cast<const float2*>(ws + col));
    const float2 b = kSharedCols ? *reinterpret_cast<const float2*>(bias + col)
                                 : __ldg(reinterpret_cast<const float2*>(bias + col));
    uint32_t* c0 = reinterpret_cast<uint32_t*>(words + xtile_offset(r, nb));
    uint32_t* c1 = reinterpret_cast<uint32_t*>(words + xtile_offset(r + 8, nb));
    const float y00 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[nb * 4], xs0), w.x), b.x);
    const float y01 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[nb * 4 + 1], xs0), w.y), b.y);
    const float y10 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[nb * 4 + 2], xs1), w.x), b.x);
    const float y11 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[nb * 4 + 3], xs1), w.y), b.y);
    const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c0));
    const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c1));
    const __nv_bfloat162 x0 = __floats2bfloat162_rn(__fadd_rn(r0.x, y00), __fadd_rn(r0.y, y01));
    const __nv_bfloat162 x1 = __floats2bfloat162_rn(__fadd_rn(r1.x, y10), __fadd_rn(r1.y, y11));
    *c0 = *reinterpret_cast<const uint32_t*>(&x0);
    *c1 = *reinterpret_cast<const uint32_t*>(&x1);
  }
}

// K9's LayerNorm and requant of the panel's rows j, j + warps, ... (of 64),
// kRows of them at a time: rowquant_rows_with, whose chunk c of a row
// (columns 256c .. 256c + 255, the lane's 8 at 256c + 8 * lane) is column
// tile c, read from the x' tile of the block of cluster rank c.
template <int kCh>
__device__ __forceinline__ void ln_panel_rows(const WgArgs& p, const LnArgs& ln, long long m0,
                                              uint32_t xtile, int j, int warps, int lane) {
  // a warp's rows at once: at O = 768, 64 rows over 12 warps, 6 at most
  constexpr int kRows = kCh <= 3 ? 6 : kCh <= 4 ? 3 : 1;
  if (kProbe == 3) return;
  for (int r0 = j; r0 < kTileM && m0 + r0 < p.m; r0 += kRows * warps) {
    long long rows[kRows];
    int nrows = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = r0 + r * warps;
      rows[r] = m0 + rr;
      if (rr < kTileM && m0 + rr < p.m) nrows = r + 1;
    }
    rowquant_rows_with<kCh, kRows>(
        [&](int r, int c, int, float(&v)[8]) {
          const uint32_t at = xtile + xtile_offset(r0 + r * warps, lane);
          unpack8(ld_cluster_v4(cluster_map(at, c)), v);
        },
        rows, nrows, p.o, kRowLn, ln.g, ln.b, ln.eps, p.yq, p.ys, lane);
  }
}

// The epilogue's copies (thread 288, in the producer's warpgroup): per tile,
// the residual by TMA into the x' tile of the tile's warpgroup, once that
// tile's previous x' has left it (its TMA store has read it and, on a
// cluster, the cluster's blocks have read it for their LayerNorms); then the
// x' of the tile before by TMA store, once its warpgroup has written it. The
// bulk-copy waits live here and not in the consumers: in their code, as a
// cluster barrier there, they make ptxas hold the consumers far below
// setmaxnreg's 232 registers, and they spill. On a cluster this thread
// is also the last of its block to finish: it waits until the cluster has
// read the block's last x' tiles, after which no other block reaches its
// shared memory.
template <bool kCluster>
__device__ __forceinline__ void res_io(const CUtensorMap* map_res, const CUtensorMap* map_out,
                                       const WgArgs& p, const ResWalk<kCluster>& w,
                                       const ResSmem& sm) {
  if (threadIdx.x != 288) return;
  // the tile's slices of 64 columns inside the matrix: boxes wholly past o
  // are neither loaded nor stored
  auto slices = [&](long long i) {
    const int left = p.o - w.col_tile(i) * kTileN;
    return left >= kTileN ? 4 : (left + 63) / 64;
  };
  auto store = [&](long long i) {  // x' of tile i, once written
    const int g = (int)(i & 1);
    mbar_wait(sm.ready0 + 8 * g, (uint32_t)(i >> 1) & 1u);
    for (int sl = 0; sl < slices(i); ++sl) {
      tma_store_2d(map_out, smem_addr(sm.xtile(g) + sl * kXSliceBytes),
                   w.col_tile(i) * kTileN + 64 * sl, (int)(w.panel(i) * kTileM));
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };
  for (long long i = 0; i < w.count; ++i) {
    const int g = (int)(i & 1);
    if (i >= 2) {
      bulk_wait_read();  // the store of tile i - 2, the tile's last, has read it
      if (kCluster) mbar_wait_cluster(sm.freed0 + 8 * g, (uint32_t)((i - 2) >> 1) & 1u);
    }
    mbar_expect_tx(sm.res0 + 8 * g, slices(i) * kXSliceBytes);
    for (int sl = 0; sl < slices(i); ++sl) {
      tma_load_2d(smem_addr(sm.xtile(g) + sl * kXSliceBytes), map_res, sm.res0 + 8 * g,
                  w.col_tile(i) * kTileN + 64 * sl, (int)(w.panel(i) * kTileM));
    }
    if (i >= 1) store(i - 1);
  }
  if (w.count > 0) store(w.count - 1);
  bulk_wait_all();
  if (kCluster) {
    for (long long i = w.count > 2 ? w.count - 2 : 0; i < w.count; ++i) {
      mbar_wait_cluster(sm.freed0 + 8 * (int)(i & 1), (uint32_t)(i >> 1) & 1u);
    }
  }
}

// The consumers (warpgroups 0 and 1), taking the block's tiles in turns as
// wgmma_consume does: the products, then the epilogue turns the residual
// that res_io has loaded into the warpgroup's x' tile into x' in place, and
// every thread counts itself in the tile's ready barrier. kCh > 0 (K9): the
// warpgroups w of a cluster's blocks then hold the panel's x' between them;
// each warp counts itself in every block's staged barrier, the warps split
// the panel's rows for the LayerNorm, and count themselves in every block's
// freed barrier once they have read.
template <int kCh>
__device__ __forceinline__ void res_consume(const WgArgs& p, const LnArgs& ln,
                                            const ResWalk<(kCh > 0)>& w, int ksteps,
                                            const ResSmem& sm) {
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* xt = sm.xtile(wg);
  static_assert(kTileN == 256, "one consumer thread a column of the tile");
  if constexpr (kCh > 0) {  // the block's column tile, the same in every tile
    const int col = w.col_tile(0) * kTileN + (int)threadIdx.x;
    const bool in = col < p.o;
    sm.cols[threadIdx.x] = in ? __ldg(p.ws + col) : 0.f;
    sm.cols[kTileN + threadIdx.x] = in ? __ldg(p.bias + col) : 0.f;
    named_bar_sync(3, 256);
  }
  if (wg == 1) named_bar_arrive(1, 256);
  uint32_t use = 0;
  for (long long i = wg; i < w.count; i += 2, ++use) {
    const long long m0 = w.panel(i) * kTileM;
    const int n0 = w.col_tile(i) * kTileN;
    // the scales of the lane's rows (warp * 16 + lane / 4, + 8), whose
    // latency passes under the products
    const long long xr = m0 + warp * 16 + lane / 4;
    const float xs0 = xr < p.m ? __ldg(p.xs + xr) : 0.f;
    const float xs1 = xr + 8 < p.m ? __ldg(p.xs + xr + 8) : 0.f;
    named_bar_sync(1 + wg, 256);
    // zeroed here (128 moves a tile): the first product overwrites it all,
    // but reads it as its asm operand, so that without a value of its own
    // before that read ptxas keeps all 128 registers live through the
    // epilogue and the LayerNorm of the tile before, and they spill
    int acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0;
    tile_products<kStageK, kResStages>(acc, sm.ring, sm.full0, (uint32_t)(i * ksteps), ksteps,
                                       [&](uint32_t s) {
                                         if (lane == 0) mbar_arrive(sm.empty0 + 8 * s);
                                       });
    named_bar_arrive(1 + (wg ^ 1), 256);
    mbar_wait(sm.res0 + 8 * wg, use & 1u);
    tile_epilogue_regs<(kCh > 0)>(p, acc, n0, warp, lane, xs0, xs1, xt, sm.cols);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // x' to the TMA store
    mbar_arrive(sm.ready0 + 8 * wg);
    if constexpr (kCh > 0) {
      const uint32_t staged = sm.staged0 + 8 * wg;
      __syncwarp();  // the warp's rows of x' are written
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      if (lane < w.tiles_n) mbar_arrive_cluster(staged, lane);
      mbar_wait_cluster(staged, use & 1u);
      ln_panel_rows<kCh>(p, ln, m0, smem_addr(xt), w.rank * 4 + warp, 4 * w.tiles_n, lane);
      __syncwarp();
      if (lane < w.tiles_n) mbar_arrive_cluster(sm.freed0 + 8 * wg, lane);
    }
  }
}

// K10 (kCh 0: one block per SM, no cluster) and K9 (kCh > 0: a cluster of
// tiles_n blocks, the LayerNorm's rows kCh chunks a lane).
template <int kCh>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_res_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_res,
                const __grid_constant__ CUtensorMap map_out, const WgArgs p, const LnArgs ln) {
  constexpr bool kCluster = kCh > 0;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  constexpr int kColsAt = kResStages * ring_stage_bytes(kWgRes) + 2 * kXTileBytes;
  const uint32_t ring = smem_addr(smem_raw);
  const uint32_t bar0 = ring + kColsAt + kColBytes;
  const uint32_t wg_bars = bar0 + 16 * kResStages;  // four pairs, one barrier per warpgroup
  const ResSmem sm{smem_raw, reinterpret_cast<float*>(smem_raw + kColsAt), ring, bar0,
                   bar0 + 8 * kResStages, wg_bars, wg_bars + 16, wg_bars + 32, wg_bars + 48};
  // the walk before the split, as wgmma_product
  const ResWalk<kCluster> w = res_walk<kCluster>(p);
  const int ksteps = (p.k + kStageK - 1) / kStageK;
  if (threadIdx.x == 0) {
    if (ring & 1023u) __trap();  // the ring and the swizzled tiles need 1024-byte alignment
#pragma unroll
    for (int s = 0; s < kResStages; ++s) {
      mbar_init(sm.full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(sm.empty0 + 8 * s, 4);  // one lane of each warp of the consuming warpgroup
    }
    for (int g = 0; g < 2; ++g) {
      mbar_init(sm.res0 + 8 * g, 1);                // res_io's expect_tx arrival
      mbar_init(sm.ready0 + 8 * g, 128);            // every thread of the warpgroup
      mbar_init(sm.staged0 + 8 * g, 4 * w.tiles_n); // each warp of the cluster's warpgroups
      mbar_init(sm.freed0 + 8 * g, 4 * w.tiles_n);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (kCluster) {
    cluster_sync_all();  // every barrier of the cluster is initialized
  } else {
    __syncthreads();
  }
  if (threadIdx.x / 128 == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    res_produce<kCluster>(&map_a, &map_b, w, ksteps, sm);
    res_io<kCluster>(&map_res, &map_out, p, w, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));
    res_consume<kCh>(p, ln, w, ksteps, sm);
  }
}

template <int kCh>
cudaError_t res_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int tiles_n,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(int8_res_kernel<kCh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         res_smem_bytes());
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3((unsigned)tiles_n);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = res_smem_bytes();
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)tiles_n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = kCh > 0 ? 1 : 0;
  return cudaSuccess;
}

// How many clusters of tiles_n blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), read once per shape.
template <int kCh>
cudaError_t res_max_clusters(int tiles_n, int* clusters) {
  static int known[kClusterMax + 1] = {};
  if (known[tiles_n] > 0) {
    *clusters = known[tiles_n];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = res_config<kCh>(cfg, attr, tiles_n, nullptr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, int8_res_kernel<kCh>, &cfg);
  if (err == cudaSuccess && *clusters > 0) known[tiles_n] = *clusters;
  return err;
}

// The persistent grid. K10: one block per SM, or one per tile. K9: as many
// clusters as the card holds, or one per panel.
template <int kCh>
cudaError_t launch_res(const CUtensorMap& map_a, const CUtensorMap& map_b,
                       const CUtensorMap& map_res, const CUtensorMap& map_out, const WgArgs& a,
                       const LnArgs& ln, cudaStream_t stream) {
  const int tiles_n = (a.o + kTileN - 1) / kTileN;
  const long long panels = (a.m + kTileM - 1) / kTileM;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = res_config<kCh>(cfg, attr, tiles_n, stream);
  if (err != cudaSuccess) return err;
  if constexpr (kCh == 0) {
    const long long tiles = panels * tiles_n;
    const int sms = persistent_blocks();
    if (sms < 1) return cudaErrorInvalidDevice;
    cfg.gridDim = dim3((unsigned)(tiles < sms ? tiles : sms));
  } else {
    int clusters = 0;
    if ((err = res_max_clusters<kCh>(tiles_n, &clusters)) != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;  // the cluster fits nowhere
    if (clusters > panels) clusters = (int)panels;
    cfg.gridDim = dim3((unsigned)(clusters * tiles_n));
  }
  return cudaLaunchKernelEx(&cfg, int8_res_kernel<kCh>, map_a, map_b, map_res, map_out, a, ln);
}

// K9 at tiles_n column tiles: its kernel's max clusters, or its launch.
cudaError_t res_cluster_count(int tiles_n, int* clusters) {
  switch (res_chunks(tiles_n)) {
    case 1: return res_max_clusters<1>(tiles_n, clusters);
    case 2: return res_max_clusters<2>(tiles_n, clusters);
    case 3: return res_max_clusters<3>(tiles_n, clusters);
    case 4: return res_max_clusters<4>(tiles_n, clusters);
    default: return res_max_clusters<kClusterMax>(tiles_n, clusters);
  }
}

cudaError_t launch_res_ln(const CUtensorMap& map_a, const CUtensorMap& map_b,
                          const CUtensorMap& map_res, const CUtensorMap& map_out,
                          const WgArgs& a, const LnArgs& ln, cudaStream_t st) {
  switch (res_chunks((a.o + kTileN - 1) / kTileN)) {
    case 1: return launch_res<1>(map_a, map_b, map_res, map_out, a, ln, st);
    case 2: return launch_res<2>(map_a, map_b, map_res, map_out, a, ln, st);
    case 3: return launch_res<3>(map_a, map_b, map_res, map_out, a, ln, st);
    case 4: return launch_res<4>(map_a, map_b, map_res, map_out, a, ln, st);
    default: return launch_res<kClusterMax>(map_a, map_b, map_res, map_out, a, ln, st);
  }
}

// gelu4 (Gelu 3: the row quant's gelu_sigmoid_mul4) against the scalar GELU
// of the other kernels on n values spread over signs, 40 binades and all
// mantissas: counts the values whose bits differ.
template <int Gelu>
__global__ void gelu_selftest_kernel(long long n, unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float y[4], ref[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned long long h = (unsigned long long)(4 * i + e) * 0x9E3779B97F4A7C15ull;
      h ^= h >> 29;
      h *= 0xBF58476D1CE4E5B9ull;
      h ^= h >> 32;
      const uint32_t sign = (uint32_t)(h >> 63) << 31;
      const uint32_t expo = 127u - 30u + (uint32_t)((h >> 40) % 40u);  // 2^-30 .. 2^9
      y[e] = __uint_as_float(sign | (expo << 23) | ((uint32_t)h & 0x7FFFFFu));
      ref[e] = Gelu == 3 ? gelu_sigmoid_mul(y[e]) : gelu(y[e], Gelu);
    }
    if constexpr (Gelu == 3) {
      gelu_sigmoid_mul4(y);
    } else {
      gelu4<Gelu>(y);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) bad += __float_as_uint(y[e]) != __float_as_uint(ref[e]);
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// Runs gelu4 (the GEMM epilogue's GELU, four values a call with a branch-free
// division; gelu 3, the row quant's sigmoid form) against the scalar GELU on
// 4 * n values; adds the number of values whose bits differ to the device
// counter `mismatches` (u64).
extern "C" int cvt_gelu_selftest(long long n, int gelu, void* mismatches, void* stream) {
  if (n < 1 || gelu < kGeluErf || gelu > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* out = static_cast<unsigned long long*>(mismatches);
  switch (gelu) {
    case kGeluSigmoid: gelu_selftest_kernel<kGeluSigmoid><<<1024, 256, 0, st>>>(n, out); break;
    case kGeluHard: gelu_selftest_kernel<kGeluHard><<<1024, 256, 0, st>>>(n, out); break;
    case 3: gelu_selftest_kernel<3><<<1024, 256, 0, st>>>(n, out); break;
    default: gelu_selftest_kernel<kGeluErf><<<1024, 256, 0, st>>>(n, out); break;
  }
  return (int)cudaGetLastError();
}

// y = f32(xq @ w^T) * xs * ws + bias with xq int8 (m, k), xs f32 (m,),
// w int8 (o, k) (K contiguous), ws and bias f32 (o,); then by epilogue:
//   0  out = bf16(y)                                         out bf16 (m, o)
//   1  out = bf16(res + y)                                   res, out bf16
//   2  out = bf16(res + y); yq, ys = rowquant(LN(out))       + ln_g, ln_b f32
//   3  yq, ys = rowquant(gelu(y)); out is a scratch of m + ceil(m / 64) 32-bit
//      words (the row maxima and a count per 64 rows); o at most 256 columns
//      for each block the card holds at once   gelu 0 erf, 1 sigmoid, 2 hard;
//      3, 4, 5: the same in the JAX bf16 epilogue (rowquant.cuh gelu_bf16)
// yq int8 (m, o), ys f32 (m,). k % 16 == 0, o % 8 == 0, every pointer
// 16-byte aligned, tensors contiguous. Returns the first failing launch's
// cudaError_t.
extern "C" int cvt_int8_matmul(const void* xq, const void* xs, const void* w,
                               const void* ws, const void* bias, const void* res,
                               void* out, long long m, int k, int o,
                               int epilogue, int gelu, const void* ln_g,
                               const void* ln_b, float eps, void* yq, void* ys,
                               void* stream) {
  if (m < 1 || m > 0x7fffffffLL - kTileM || k < 16 || k % 16 || o < 8 || o % 8 ||
      epilogue < kEpiBias || epilogue > kEpiGeluQ || gelu < kGeluErf || gelu > kGeluLast) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_a, map_b;
  const int box_k = stage_k(epilogue == kEpiGeluQ ? kWgGeluQuant : kWgBias);
  if (!make_map(&map_a, xq, m, k, kTileM, box_k) || !make_map(&map_b, w, o, k, kTileN, box_k)) {
    return (int)cudaErrorInvalidValue;
  }
  WgArgs a{static_cast<const float*>(xs),
           static_cast<const float*>(ws),
           static_cast<const float*>(bias),
           static_cast<const __nv_bfloat16*>(res),
           static_cast<__nv_bfloat16*>(out),
           static_cast<float*>(out),
           reinterpret_cast<unsigned int*>(static_cast<float*>(out) + m),
           static_cast<int8_t*>(yq),
           static_cast<float*>(ys),
           m, k, o, gelu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int tiles_n = (o + kTileN - 1) / kTileN;
  const int route = res_route(epilogue, tiles_n);
  if ((epilogue == kEpiRes || epilogue == kEpiResLnQ) && route != kRouteTwoLaunch) {
    CUtensorMap map_res, map_out;
    if (!make_map_bf16(&map_res, res, m, o, kTileM) || !make_map_bf16(&map_out, out, m, o, kTileM)) {
      return (int)cudaErrorInvalidValue;
    }
    const LnArgs ln{static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), eps};
    if (route == kRouteTiles) {
      return (int)launch_res<0>(map_a, map_b, map_res, map_out, a, ln, st);
    }
    return (int)launch_res_ln(map_a, map_b, map_res, map_out, a, ln, st);
  }
  switch (epilogue) {
    case kEpiBias:
      return (int)launch_wgmma<kWgBias>(map_a, map_b, a, st);
    case kEpiRes:  // the two-launch route, one launch
      return (int)launch_wgmma<kWgRes>(map_a, map_b, a, st);
    case kEpiResLnQ:  // the two-launch route
      err = launch_wgmma<kWgRes>(map_a, map_b, a, st);
      if (err != cudaSuccess) return (int)err;
      return (int)cvt::launch_rowquant_mode<cvt::kRowLn>(
          static_cast<const __nv_bfloat16*>(out), m, o, static_cast<const float*>(ln_g),
          static_cast<const float*>(ln_b), eps, a.yq, a.ys, st);
    default:  // kEpiGeluQ
      err = cudaMemsetAsync(a.amax, 0, 4 * (m + (m + kTileM - 1) / kTileM), st);
      if (err != cudaSuccess) return (int)err;
      switch (gelu) {
        case kGeluSigmoid: return (int)launch_gelu_quant<kGeluSigmoid>(map_a, map_b, a, st);
        case kGeluHard: return (int)launch_gelu_quant<kGeluHard>(map_a, map_b, a, st);
        case kGeluErf: return (int)launch_gelu_quant<kGeluErf>(map_a, map_b, a, st);
        default: return (int)launch_gelu_quant<kGeluBf16>(map_a, map_b, a, st);
      }
  }
}

// The route of the residual epilogues (1: K10, 2: K9) at o output columns:
// info[0] the route (0 two launches, 1 one kernel with one block per SM, 2
// one kernel on clusters), info[1] the blocks of a cluster (the column
// tiles; 0 without a cluster), info[2] how many clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), or on route 1 the blocks of the
// grid, else 0, info[3] a block's dynamic shared memory in bytes. Returns
// the occupancy query's cudaError_t.
extern "C" int cvt_int8_res_route(int o, int epilogue, void* info) {
  if (o < 8 || o % 8 || (epilogue != kEpiRes && epilogue != kEpiResLnQ)) {
    return (int)cudaErrorInvalidValue;
  }
  int* out = static_cast<int*>(info);
  const int tiles_n = (o + kTileN - 1) / kTileN;
  const int route = res_route(epilogue, tiles_n);
  int count = 0;
  cudaError_t err = cudaSuccess;
  if (route == kRouteCluster) err = res_cluster_count(tiles_n, &count);
  if (route == kRouteTiles) count = persistent_blocks();
  out[0] = route;
  out[1] = route == kRouteCluster ? tiles_n : 0;
  out[2] = count;
  out[3] = route == kRouteTwoLaunch ? wg_smem_bytes(kWgRes) : res_smem_bytes();
  return (int)err;
}
