// One whole quantized ViT block of the int8 serving path in one launch.
//
// Replaces the TPU kernel chess_vision_tpu/ops/fused_block.py _pallas_fused
// (_fused_block_kernel), K14, reached through fused_vit_block and
// fused_vit_stack under CHESS_VISION_INT8_LAYOUT=fused. Inputs: this block's
// LN1 output already quantized (xq int8, xs f32 per token) and the bf16
// residual stream. Per token row, with y(a, w) = f32(a @ w) * a_s * w_s + b:
//
//   qkv  = bf16(y(xq, Wqkv))
//   att  = softmax(q k^T * scale) v per head, p = bf16(exp(s - shift)) in
//          both P V and the row sum, row sum floored at 1e-30      (f32)
//   aq   = rowquant(att)                        over all heads of the token
//   x1   = bf16(res + y(aq, Wproj))
//   hq   = rowquant(LN2(x1))                    two-pass LN of the rounded x1
//   g    = gelu(y(hq, Wfc1))                    sigmoid, erf or hard   (f32)
//   gq   = rowquant(g)
//   x2   = bf16(x1 + y(gq, Wfc2))               -> x_new
//   yq   = rowquant(LN_next(x2))                -> yq, ys, the next block's input
//
// which is, operation for operation, the chain of the split kernels (K8-K10,
// K4): the JAX kernel was written so (fused_block.py:26-28), and so is this
// one, from the same device code (int8_gemm.cuh, attention_quant.cuh,
// rowquant.cuh). Its outputs equal the split chain's bit for bit.
//
// Bound on this card: the four products, 2 * M * D * (3D + D + 2 * O1) int8
// operations (0.93 TOP at batch 256, ViT-B), against ~0.3 GB of inputs and
// outputs: compute-bound, as the split GEMMs are.
//
// Design. The TPU kernel keeps 7 MB of weights and one image's activations in
// VMEM and walks the images in order. An SM has 227 KB of shared memory, so
// neither fits; what the card has instead is 132 SMs that can all wait for
// each other. The kernel is one cooperative launch (cudaLaunchCooperativeKernel)
// of as many blocks as are resident at once (the occupancy query times the SM
// count), and runs the block's nine stages over ALL rows of the batch with a
// grid-wide barrier between them:
//
//   1 qkv GEMM | 2 attention | 3 row quant | 4 proj GEMM + residual |
//   5 LN2 row quant | 6 fc1 GEMM + GELU | 7 row quant | 8 fc2 GEMM +
//   residual | 9 next LN1 row quant
//
// Why this shape and not one thread block per image: a 257-row image fills
// 128-row GEMM tiles as 2 + 1/128, a third of the tensor-core work wasted,
// and 132 blocks of one image each leave 8 warps per SM to hide every
// latency. Over all rows the tiles are full (514 row tiles at batch 256) and
// every block walks tiles t, t + grid, ...: neighbouring blocks share their
// rows of A and all of B in L2, as in the split GEMM's grid.
//  - Row-wide epilogues (abs-max over 3,072 columns, LN over 768) do not fit
//    a 128-column tile: as in the split kernels, a GEMM stage writes its
//    epilogue values to a scratch in device memory and the next stage is the
//    row pass, one warp per row, rows shared among all warps of the grid.
//  - Attention work items are (64-query tile, head, image); the block's two
//    halves of 4 warps each take one item at a time, each half with its own
//    K/V tile in shared memory and its own named barrier (bar.sync 1 / 2,
//    128 threads), so the 256-thread block shape of the GEMM stages serves
//    the 128-thread attention loop unchanged.
//  - The grid barrier (cooperative groups) also orders memory: what a stage
//    wrote to the scratch is visible to every block after it. The scratch is
//    sized by the batch (26 KB per row at ViT-B: bf16 qkv, f32 attention,
//    f32 fc1 output and the int8 codes), allocated by the caller.
//  - The calibrated shift is a kernel argument, so every layer runs the same
//    compiled kernel (what fused_vit_stack's lax.scan is for on the TPU).
// Not yet done (later work): the row passes folded into the neighbouring
// GEMM stages' prologue, overlapping the attention stage (CUDA cores) with a
// GEMM stage (tensor cores) as the TPU kernel pipelines them, wgmma and TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_quant.cuh"
#include "int8_gemm.cuh"
#include "rowquant.cuh"

namespace cg = cooperative_groups;
using namespace cvt;

namespace {

struct Dense {
  const int8_t* w;    // (o, k) int8
  const float* ws;    // (o,)
  const float* bias;  // (o,)
};

struct FusedArgs {
  const int8_t* xq;          // (m, d)
  const float* xs;           // (m,)
  const __nv_bfloat16* res;  // (m, d)
  Dense qkv, proj, fc1, fc2;
  const float *g2, *b2;      // LN2 (d,)
  const float *gn, *bn;      // the next block's LN1 (d,)
  // scratch
  __nv_bfloat16* qkv_out;    // (m, 3d)
  float* att;                // (m, d)
  int8_t* aq;                // (m, d)
  float* as;                 // (m,)
  __nv_bfloat16* x1;         // (m, d)
  int8_t* hq;                // (m, d)
  float* hs;                 // (m,)
  float* g;                  // (m, o1)
  int8_t* gq;                // (m, o1)
  float* gs;                 // (m,)
  // outputs
  __nv_bfloat16* xn;         // (m, d)
  int8_t* yq;                // (m, d)
  float* ys;                 // (m,)
  int batch, n, heads, o1;
  float scale, shift;
  int fixed, gelu;
  float eps;
  unsigned long long* stage_ns;  // optional (kBlockStages + 1,): see mark_stage
};

constexpr int kBlockStages = 9;

// Where the caller asks for it, block 0 notes the card's nanosecond clock at
// the kernel's start (slot 0) and after each stage's grid barrier (slots 1 to
// 8: the stage is then done in every block) and after its own share of the
// last stage (slot 9): the differences are the stages' times.
__device__ __forceinline__ void mark_stage(unsigned long long* out, int slot) {
  if (out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    out[slot] = t;
  }
}

// The stages are separate functions, not inlined: each is compiled once for
// every head dim's kernel, and gets its registers allotted on its own.

// Every output tile of one product, tiles t = blockIdx.x, + gridDim.x, ...,
// column tiles fastest.
template <int Epi>
__device__ __noinline__ void gemm_stage(const GemmArgs p, uint8_t* smem) {
  const int tiles_n = (p.o + kBN - 1) / kBN;
  const long long tiles = ((p.m + kBM - 1) / kBM) * tiles_n;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    gemm_tile<Epi>(p, smem, (t / tiles_n) * kBM, (int)(t % tiles_n) * kBN);
  }
}

template <typename T>
__device__ __noinline__ void rowquant_stage(const T* x, long long rows, int d, int mode,
                                               const float* g, const float* b, float eps,
                                               int8_t* q, float* s) {
  constexpr int kWarpsPerBlock = kThreads / 32;
  rowquant_rows<T>(x, rows, d, mode, g, b, eps, q, s,
                   (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32,
                   (long long)gridDim.x * kWarpsPerBlock, threadIdx.x % 32);
}

// Attention work items (query tile, head, image), one per half block at a
// time: items it = 2 * blockIdx.x + half, + 2 * gridDim.x, ...
template <int Dh>
__device__ __noinline__ void attention_stage(const __nv_bfloat16* qkv, float* out, int batch,
                                             int n, int heads, float scale, float shift,
                                             int fixed, uint8_t* smem) {
  constexpr int kGroups = kThreads / kAttnThreads;
  const int group = threadIdx.x / kAttnThreads;
  AttnSmem<Dh>& sm = reinterpret_cast<AttnSmem<Dh>*>(smem)[group];
  const int qtiles = (n + kAttnQTile - 1) / kAttnQTile;
  const long long items = (long long)qtiles * heads * batch;
  for (long long it = (long long)blockIdx.x * kGroups + group; it < items;
       it += (long long)gridDim.x * kGroups) {
    const int qtile = (int)(it % qtiles);
    const int h = (int)((it / qtiles) % heads);
    const int b = (int)(it / ((long long)qtiles * heads));
    attention_quant_tile<Dh>(qkv, out, n, n, heads, scale, shift, fixed, qtile, h, b, sm,
                             threadIdx.x % kAttnThreads, 1 + group);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 2)
fused_block_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  static_assert(2 * sizeof(AttnSmem<Dh>) <= kSmemBytes, "two attention tiles fit");
  cg::grid_group grid = cg::this_grid();
  const long long m = (long long)a.batch * a.n;
  const int d = a.heads * Dh;

  mark_stage(a.stage_ns, 0);
  // 1. qkv = bf16(y(xq, Wqkv))
  gemm_stage<kEpiBias>(GemmArgs{a.xq, a.xs, a.qkv.w, a.qkv.ws, a.qkv.bias, nullptr,
                                a.qkv_out, m, d, 3 * d, a.gelu}, smem);
  grid.sync();
  mark_stage(a.stage_ns, 1);

  // 2. attention, f32 out
  attention_stage<Dh>(a.qkv_out, a.att, a.batch, a.n, a.heads, a.scale, a.shift, a.fixed,
                      smem);
  grid.sync();
  mark_stage(a.stage_ns, 2);

  // 3. aq, as = rowquant(att)
  rowquant_stage<float>(a.att, m, d, kRowNone, nullptr, nullptr, 0.f, a.aq, a.as);
  grid.sync();
  mark_stage(a.stage_ns, 3);

  // 4. x1 = bf16(res + y(aq, Wproj))
  gemm_stage<kEpiRes>(GemmArgs{a.aq, a.as, a.proj.w, a.proj.ws, a.proj.bias, a.res, a.x1,
                               m, d, d, a.gelu}, smem);
  grid.sync();
  mark_stage(a.stage_ns, 4);

  // 5. hq, hs = rowquant(LN2(x1)): the LN reads the rounded x1
  rowquant_stage<__nv_bfloat16>(a.x1, m, d, kRowLn, a.g2, a.b2, a.eps, a.hq, a.hs);
  grid.sync();
  mark_stage(a.stage_ns, 5);

  // 6. g = gelu(y(hq, Wfc1)), f32
  gemm_stage<kEpiGeluQ>(GemmArgs{a.hq, a.hs, a.fc1.w, a.fc1.ws, a.fc1.bias, nullptr, a.g,
                                 m, d, a.o1, a.gelu}, smem);
  grid.sync();
  mark_stage(a.stage_ns, 6);

  // 7. gq, gs = rowquant(g)
  rowquant_stage<float>(a.g, m, a.o1, kRowNone, nullptr, nullptr, 0.f, a.gq, a.gs);
  grid.sync();
  mark_stage(a.stage_ns, 7);

  // 8. x2 = bf16(x1 + y(gq, Wfc2)) -> x_new
  gemm_stage<kEpiRes>(GemmArgs{a.gq, a.gs, a.fc2.w, a.fc2.ws, a.fc2.bias, a.x1, a.xn, m,
                               a.o1, d, a.gelu}, smem);
  grid.sync();
  mark_stage(a.stage_ns, 8);

  // 9. yq, ys = rowquant(LN_next(x2))
  rowquant_stage<__nv_bfloat16>(a.xn, m, d, kRowLn, a.gn, a.bn, a.eps, a.yq, a.ys);
  mark_stage(a.stage_ns, kBlockStages);
}

constexpr long long kAlign = 256;

long long aligned(long long bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

// Offsets of the scratch arrays in the caller's buffer, in FusedArgs order;
// the last entry is the total size.
void scratch_layout(long long m, int d, int o1, long long (&off)[11]) {
  const long long sizes[10] = {m * 3 * d * 2, m * d * 4, m * d,      m * 4, m * d * 2,
                               m * d,         m * 4,     m * o1 * 4, m * o1, m * 4};
  off[0] = 0;
  for (int i = 0; i < 10; ++i) off[i + 1] = off[i] + aligned(sizes[i]);
}

template <int Dh>
cudaError_t launch(FusedArgs a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess) {
    return err;
  }
  if (!coop) return cudaErrorNotSupported;
  // a grid barrier deadlocks unless every block is resident: no more blocks
  // than the occupancy query allows
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_block_kernel<Dh>,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_block_kernel<Dh>),
                                     dim3(per_sm * sms), dim3(kThreads), params, kSmemBytes,
                                     stream);
}

}  // namespace

// Bytes of scratch cvt_fused_block needs for m = batch * n rows of width d
// and an MLP width of o1.
extern "C" long long cvt_fused_block_scratch_bytes(long long m, int d, int o1) {
  long long off[11];
  scratch_layout(m, d, o1, off);
  return off[10];
}

// xq int8 (batch, n, d), xs f32 (batch, n), res bf16 (batch, n, d), with
// d = heads * head_dim; w* int8 (O, K), K contiguous: wqkv (3d, d), wproj
// (d, d), wfc1 (o1, d), wfc2 (d, o1); s* and b* the f32 column scales and
// biases; g2, b2 and gn, bn the f32 (d,) LayerNorm parameters of this
// block's norm2 and the next block's norm1. scratch: at least
// cvt_fused_block_scratch_bytes bytes, 256-byte aligned. Outputs: xn bf16
// (batch, n, d), yq int8 (batch, n, d), ys f32 (batch, n). fixed != 0:
// exp(s - shift) with the given shift, else the exact row max. gelu: 0 erf,
// 1 sigmoid, 2 hard. stage_ns: null, or 10 x u64 that receive the card's
// nanosecond clock at the start and after each of the 9 stages. d % 16 == 0, o1 % 16 == 0, head_dim 16, 32 or 64; every
// pointer 16-byte aligned, tensors contiguous. One kernel launch; returns its
// cudaError_t.
extern "C" int cvt_fused_block(
    const void* xq, const void* xs, const void* res, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj,
    const void* g2, const void* b2, const void* wfc1, const void* sfc1, const void* bfc1,
    const void* wfc2, const void* sfc2, const void* bfc2, const void* gn, const void* bn,
    void* scratch, void* xn, void* yq, void* ys, int batch, int n, int heads, int head_dim,
    int o1, float scale, float shift, int fixed, int gelu, float eps, void* stage_ns,
    void* stream) {
  const long long m = (long long)batch * n;
  const int d = heads * head_dim;
  if (batch < 1 || n < 1 || heads < 1 || d % 16 || o1 < 16 || o1 % 16 || d > kRowMaxD ||
      o1 > kRowMaxD || gelu < kGeluErf || gelu > kGeluHard) {
    return (int)cudaErrorInvalidValue;
  }
  long long off[11];
  scratch_layout(m, d, o1, off);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto dense = [&](const void* w, const void* s, const void* b) {
    return Dense{static_cast<const int8_t*>(w), f32(s), f32(b)};
  };
  FusedArgs a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = f32(xs);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.qkv = dense(wqkv, sqkv, bqkv);
  a.proj = dense(wproj, sproj, bproj);
  a.fc1 = dense(wfc1, sfc1, bfc1);
  a.fc2 = dense(wfc2, sfc2, bfc2);
  a.g2 = f32(g2);
  a.b2 = f32(b2);
  a.gn = f32(gn);
  a.bn = f32(bn);
  a.qkv_out = reinterpret_cast<__nv_bfloat16*>(sc + off[0]);
  a.att = reinterpret_cast<float*>(sc + off[1]);
  a.aq = reinterpret_cast<int8_t*>(sc + off[2]);
  a.as = reinterpret_cast<float*>(sc + off[3]);
  a.x1 = reinterpret_cast<__nv_bfloat16*>(sc + off[4]);
  a.hq = reinterpret_cast<int8_t*>(sc + off[5]);
  a.hs = reinterpret_cast<float*>(sc + off[6]);
  a.g = reinterpret_cast<float*>(sc + off[7]);
  a.gq = reinterpret_cast<int8_t*>(sc + off[8]);
  a.gs = reinterpret_cast<float*>(sc + off[9]);
  a.xn = static_cast<__nv_bfloat16*>(xn);
  a.yq = static_cast<int8_t*>(yq);
  a.ys = static_cast<float*>(ys);
  a.batch = batch;
  a.n = n;
  a.heads = heads;
  a.o1 = o1;
  a.scale = scale;
  a.shift = shift;
  a.fixed = fixed;
  a.gelu = gelu;
  a.eps = eps;
  a.stage_ns = static_cast<unsigned long long*>(stage_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch<16>(a, st);
    case 32: return (int)launch<32>(a, st);
    case 64: return (int)launch<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
