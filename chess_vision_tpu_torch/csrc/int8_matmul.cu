// int8 x int8 -> int32 GEMM with the int8 serving path's epilogues.
//
// Replaces the TPU kernels of chess_vision_tpu/ops/int8_matmul.py:
//   K8  int8_matmul_gelu_quant      yq, ys = rowquant(gelu(y))
//   K9  int8_matmul_res_ln_quant    x' = bf16(res + y); yq, ys = rowquant(LN(x'))
//   K10 int8_matmul_res             x' = bf16(res + y)
// and their flat twins K11-K13, which are the same math on (M, K) rows,
// where y = f32(xq @ wq) * xs * ws + bias. It also serves the qkv product,
// which the JAX package leaves to XLA (quant.py quant_dense_q): bf16(y).
//
// Bound on this card: at the ViT-B serving shapes (M = 256 * 257 rows, K and
// O of 768 or 3072) the products are 78-310 GOP per call against 50-250 MB
// of operands, far above the ~600 operations per byte where int8 tensor
// cores rather than HBM become the limit: compute-bound (0.04-0.16 ms at
// 1,979 TOP/s).
//
// Design, one kernel for every variant (int8_wgmma_kernel), whose body is the
// device code of int8_gemm.cuh (wgmma_produce, wgmma_consume); the
// whole-block kernel (fused_block.cu) runs its four products through the same
// functions:
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
//  - K9's LayerNorm needs the whole row of x' as stored (bf16-rounded), which
//    must be written anyway: the GEMM writes x' and the row pass of
//    rowquant.cuh quantizes LN(x'), inside the same entry point.
// ptxas -v (CUDA 12.8, -O3): see chip_smoke.py's build phase; the kernel is
// compiled for 168 registers at launch (384 threads), consumers 232 after
// setmaxnreg, no spills but 20 bytes in the residual epilogue; 160 KB of
// dynamic shared memory for the ring and 38 KB for the warps' staging tiles
// (K8: 80 KB and 145 KB).
// Measured (NVIDIA H100 80GB HBM3, 700 W; M = 65,792; the mma.sync loop's
// time and torch._int_mm's for the bare product in brackets): qkv 0.31 ms
// (0.58; 0.42), proj with its LN pass 0.21 (0.32; 0.14), fc2 0.39 and 0.33
// (0.71, 0.67; 0.42), K8 0.88 (1.28; 0.54). K8 is bound by its epilogue, not
// by the products: 0.70 ms with the hard GELU (no exponential, no division),
// 0.88 with sigmoid, 1.00 with erf. Two other designs were measured on the
// same loop: the product twice (row maxima in a first sweep, codes in a
// second, nothing kept) 1.17 ms; one sweep with gelu(y) held in the
// accumulator registers across the exchange, its epilogue unrolled over all
// 128 of them, 1.12.
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

// gelu4 against the scalar GELU of the other kernels on n values spread over
// signs, 40 binades and all mantissas: counts the values whose bits differ.
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
      ref[e] = gelu(y[e], Gelu);
    }
    gelu4<Gelu>(y);
#pragma unroll
    for (int e = 0; e < 4; ++e) bad += __float_as_uint(y[e]) != __float_as_uint(ref[e]);
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// Runs gelu4 (the GEMM epilogue's GELU, four values a call with a branch-free
// division) against the scalar GELU on 4 * n values; adds the number of
// values whose bits differ to the device counter `mismatches` (u64).
extern "C" int cvt_gelu_selftest(long long n, int gelu, void* mismatches, void* stream) {
  if (n < 1 || gelu < kGeluErf || gelu > kGeluHard) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* out = static_cast<unsigned long long*>(mismatches);
  switch (gelu) {
    case kGeluSigmoid: gelu_selftest_kernel<kGeluSigmoid><<<1024, 256, 0, st>>>(n, out); break;
    case kGeluHard: gelu_selftest_kernel<kGeluHard><<<1024, 256, 0, st>>>(n, out); break;
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
//      for each block the card holds at once   gelu 0 erf, 1 sigmoid, 2 hard
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
      epilogue < kEpiBias || epilogue > kEpiGeluQ || gelu < kGeluErf || gelu > kGeluHard) {
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
  switch (epilogue) {
    case kEpiBias:
      return (int)launch_wgmma<kWgBias>(map_a, map_b, a, st);
    case kEpiRes:
      return (int)launch_wgmma<kWgRes>(map_a, map_b, a, st);
    case kEpiResLnQ:
      err = launch_wgmma<kWgRes>(map_a, map_b, a, st);
      if (err != cudaSuccess) return (int)err;
      return (int)cvt::launch_rowquant(static_cast<const __nv_bfloat16*>(out), m, o,
                                       cvt::kRowLn, static_cast<const float*>(ln_g),
                                       static_cast<const float*>(ln_b), eps, a.yq, a.ys, st);
    default:  // kEpiGeluQ
      err = cudaMemsetAsync(a.amax, 0, 4 * (m + (m + kTileM - 1) / kTileM), st);
      if (err != cudaSuccess) return (int)err;
      switch (gelu) {
        case kGeluSigmoid: return (int)launch_gelu_quant<kGeluSigmoid>(map_a, map_b, a, st);
        case kGeluHard: return (int)launch_gelu_quant<kGeluHard>(map_a, map_b, a, st);
        default: return (int)launch_gelu_quant<kGeluErf>(map_a, map_b, a, st);
      }
  }
}
