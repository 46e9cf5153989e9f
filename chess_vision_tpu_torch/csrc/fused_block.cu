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
//          both P V and the row sum, row sum floored at 1e-30      (f32);
//          shift: the calibrated one, else the JAX default "bound"
//          |q_i| max_j |k_j| - 45 per row and head (fused_block.py:138-142)
//   aq   = rowquant(att)                        over all heads of the token
//   x1   = bf16(res + y(aq, Wproj))
//   hq   = rowquant(LN2(x1))                    two-pass LN of the rounded x1
//   gq   = rowquant(gelu(y(hq, Wfc1)))          sigmoid, erf or hard
//   x2   = bf16(x1 + y(gq, Wfc2))               -> x_new
//   yq   = rowquant(LN_next(x2))                -> yq, ys, the next block's input
//
// which is, operation for operation, the chain of the split kernels (the qkv
// product, K4, K9, K8, K9): the JAX kernel was written so
// (fused_block.py:26-28), and so is this one, from the split kernels' own
// device code. Its outputs equal the split chain's bit for bit: int32 sums are
// exact in any order, the epilogue arithmetic is the same code, max is exact
// in any order, and the row passes are rowquant.cuh's.
//
// Bound on this card: the four products, 2 * M * D * (3D + D + 2 * O1) int8
// operations (0.93 TOP at batch 256, ViT-B), against ~0.3 GB of inputs and
// outputs: compute-bound, as the split GEMMs are.
//
// Design. The TPU kernel keeps 7 MB of weights and one image's activations in
// VMEM and walks the images in order. An SM has 227 KB of shared memory, so
// neither fits; what the card has instead is 132 SMs that can all wait for
// each other. The kernel is one cooperative launch of one 384-thread block per
// SM (the split GEMM's block: a producer warpgroup and two consumer
// warpgroups), and runs the block's seven stages over ALL rows of the batch
// with a grid-wide barrier between them (cooperative groups' grid sync, which
// the two roles reach from their own code):
//
//   1 qkv GEMM | 2 attention + row quant | 3 proj GEMM + residual |
//   4 LN2 row quant | 5 fc1 GEMM + GELU + row quant | 6 fc2 GEMM + residual |
//   7 next LN1 row quant
//
//  - The GEMM stages are the split kernels' code: wgmma_produce and
//    wgmma_consume of int8_gemm.cuh, the wgmma + TMA ring with ping-pong
//    consumers, with the tensor maps of xq, of the codes in the scratch and of
//    the four weights encoded in the entry point and passed as one
//    __grid_constant__ parameter. The ring's barriers are initialized once;
//    the count of ring steps goes on from one product to the next, so every
//    wait sees its own phase.
//  - Registers: the producer warpgroup gives its registers to the two
//    consumer warpgroups once, at the start (setmaxnreg 40 / 232), and the
//    roles never join again: the producer only feeds the four products and
//    meets the grid barriers, and the consumers' 8 warps also run the
//    attention and the row passes, at 232 registers. First built the other
//    way (the roles split around each product, all 12 warps at 168 between
//    them for four attention groups of 3 warps), ptxas kept the consumers at 168
//    registers through the products (5.7 KB spilled, the wgmma serialized,
//    C7512) and the kernel hung on the card; it honours setmaxnreg only where
//    the two roles do not merge again, as in the split kernels.
//  - The ping-pong's one left-over barrier arrival is taken at the end of
//    each product, so named barriers 1 and 2 start the next one complete.
//  - fc1 is K8's sweep: the grid as groups of as many blocks as the row has
//    256-column tiles (12 at O1 = 3072, so 11 groups on 132 SMs; leftover
//    blocks of a grid that is not a multiple take no tile and wait at the
//    barrier), gelu(y) kept as f32 in shared memory, the row maxima exchanged
//    through an f32 (M,) vector with atomicMax and a per-panel count: no f32
//    (M, O1) scratch and no row-pass stage.
//  - Attention is K4's loop (attention_loop.cuh) and epilogue on the 8
//    consumer warps: four groups of 2 warps, each with its own 45 KB of shared
//    memory (Q tile and a 2-stage K/V ring) and its own named barrier, each
//    taking one head of the same 64-row chunk (K4 runs 3 warps a chunk of 96
//    rows, four blocks an SM: 12 warps; the bits are the same, every row's
//    arithmetic is the loop's own). The per-token scale spans all heads: a
//    chunk's heads are taken by a team of ceil(H / 4) neighbouring blocks in
//    lockstep (3 at H = 12; teams walk the (image, chunk) items in the same
//    order), whose groups fold their rows' maxima in shared memory and then
//    across the team by atomicMax into an f32 (M,) vector and a per-chunk
//    count, as K8 does, before each group codes its own columns: no f32
//    (M, D) scratch and no row-pass stage. A thread-block cluster, K4's way,
//    is not open to a grid of one 227 KB block per SM.
//  - Every wait on another block (the fc1 panel, the attention chunk) waits
//    only on blocks of the same group or team, which are resident (the launch
//    is cooperative) and work on the same panel or chunk; a wait that never
//    ends traps after ~2^24 polls. The counts and maxima are zeroed by the
//    kernel itself before the first grid barrier.
//  - Codes written by generic stores (aq, hq, gq) are read by the next GEMM
//    stage through TMA, the async proxy: every thread fences the proxies
//    (fence.proxy.async) before each grid barrier and again before its next
//    product, which also orders the stages' shared-memory use against the
//    ring's TMA writes.
//  - The calibrated shift is a kernel argument, so every layer runs the same
//    compiled kernel (what fused_vit_stack's lax.scan is for on the TPU).
//    The bound shift costs each group a read of its head's K rows before
//    the loop (attention_loop.cuh flash_key_norm_max, through L2; the
//    group's slot of the row maxima holds the warps' key-norm maxima
//    meanwhile).
//  - One kernel for every head dim and GELU: the attention stage is a called
//    function per head dim and the fc1 epilogue picks its GELU at run time,
//    so the file compiles the four products once.
// Measured (NVIDIA H100 80GB HBM3, 700 W; (256, 257, 768), 12 heads, MLP
// 3072, fixed shift; chip_smoke.py phase 13 and experiments/kernel_ab.py):
// 6.96 ms, against 4.27 for the earlier design of this kernel (mma.sync
// loops, f32 scratch and row-pass stages) and 2.43 for the five split
// launches; stages qkv 0.57, attention 3.65, proj 0.34, LN2 0.25, fc1 1.29,
// fc2 0.57, next LN1 0.22 ms. What loses is register allocation, not the
// design's work: ptxas spills 2.2 KB in the kernel and 4-9 KB in the stage
// functions (attention_stage<64> 8.8 KB). A build with only the four
// products in it runs them in 2.84 ms against the split kernels' 1.74 on the
// same code; the attention stage inlined took 4.0-4.1 ms, as 2 groups of 3
// warps 4.7, with a 56 / 224 register split 4.2 (each a build of this file,
// timed in one call). Even one product alone in this kernel's frame runs 0.45
// ms against the split kernel's 0.31 (212 bytes spilled), whether the block
// asks for 231 or 160 KB of shared memory, and with the products' arguments
// as kernel parameters the kernel read 7.21-7.29 ms. Its attention also runs
// on 8 warps an SM where K4 runs 12, on 64-row chunks (5 an image, K4's 3).
// Not yet done (later work): a block shape whose roles need no setmaxnreg
// (256 threads, one consumer thread issuing the TMA loads, 255 registers
// each), so that ptxas allots the stages as it does the split kernels; the LN
// row passes folded into the neighbouring GEMM stages per 64-row panel;
// overlapping the attention stage (CUDA cores) with a GEMM stage (tensor
// cores) as the TPU kernel pipelines them.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_loop.cuh"
#include "int8_gemm.cuh"
#include "rowquant.cuh"

namespace cg = cooperative_groups;
using namespace cvt;

namespace {

// Tensor maps of the four products' operands: A boxes of kTileM rows, B boxes
// of kTileN rows, 128 bytes of K (fc1: 64, K8's stage).
struct FusedMaps {
  CUtensorMap xq, wqkv, aq, wproj, hq, wfc1, gq, wfc2;
};

struct FusedArgs {
  const float* xs;                        // (m,)
  const __nv_bfloat16* res;               // (m, d)
  const float *sqkv, *bqkv, *sproj, *bproj, *sfc1, *bfc1, *sfc2, *bfc2;  // (o,)
  const float *g2, *b2;                   // LN2 (d,)
  const float *gn, *bn;                   // the next block's LN1 (d,)
  // scratch
  __nv_bfloat16* qkv_out;                 // (m, 3d)
  int8_t* aq;                             // (m, d)
  float* as;                              // (m,)
  __nv_bfloat16* x1;                      // (m, d)
  int8_t* hq;                             // (m, d)
  float* hs;                              // (m,)
  int8_t* gq;                             // (m, o1)
  float* gs;                              // (m,)
  float* att_amax;                        // (m,) zeroed: rows' max |o| over all heads
  float* fc1_amax;                        // (m,) zeroed: rows' max |gelu(y)|
  unsigned int* att_count;                // (items,) zeroed: blocks done with a chunk
  unsigned int* fc1_count;                // (panels,) zeroed: warps done with a panel
  uint4* zero;                            // the four arrays above, zero_words 16-byte words
  long long zero_words;
  // outputs
  __nv_bfloat16* xn;                      // (m, d)
  int8_t* yq;                             // (m, d)
  float* ys;                              // (m,)
  int batch, n, heads, head_dim, o1;
  float scale, shift;
  int shift_mode, gelu;  // shift_mode: FlashShift (attention_loop.cuh)
  float eps;
  unsigned long long* stage_ns;  // optional (kBlockStages + 1,): see mark_stage
};

constexpr int kBlockStages = 7;
constexpr int kConsumers = 256;                    // threads of warpgroups 0 and 1
constexpr int kGroupWarps = 2;                     // warps of an attention group
constexpr int kGroupRows = 32 * kGroupWarps;       // query rows of a chunk
constexpr int kGroups = kConsumers / kGroupRows;   // groups a block: 4
constexpr int kGroupStages = 2;                    // K/V tiles in a group's ring
// Named barriers: 0 the block (grid barriers), 1 and 2 the products'
// ping-pong, kBarGroup + g attention group g, kBarConsumers the consumers.
constexpr int kBarGroup = 3;
constexpr int kBarConsumers = kBarGroup + kGroups;
static_assert(kGroups * kGroupRows == kConsumers, "whole groups");
static_assert(kBarConsumers < 16, "16 named barriers a block");

template <int Dh>
__host__ __device__ constexpr int attn_group_bytes() {
  return 2 * flash_smem_elems<Dh, kGroupWarps, kGroupStages>();
}

// The four groups' tiles, then each group's rows' maxima and the chunk's.
template <int Dh>
__host__ __device__ constexpr int attn_smem_bytes() {
  return kGroups * attn_group_bytes<Dh>() + (kGroups + 1) * kGroupRows * 4;
}

constexpr int smem_max(int a, int b) { return a > b ? a : b; }
constexpr int kSmemBytes = smem_max(smem_max(wg_smem_bytes(kWgGeluQuant), wg_smem_bytes(kWgBias)),
                                    attn_smem_bytes<64>());
static_assert(kSmemBytes + 64 <= 232448, "a block's shared memory");

// Where the caller asks for it, block 0 notes the card's nanosecond clock at
// the kernel's start (slot 0) and after each stage's grid barrier (slots 1 to
// 6: the stage is then done in every block) and after its own share of the
// last stage (slot 7): the differences are the stages' times.
__device__ __forceinline__ void mark_stage(unsigned long long* out, int slot) {
  if (out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    out[slot] = t;
  }
}

// Orders this thread's generic accesses, to global and shared memory, before
// later accesses through the async proxy (TMA), and the other way round.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The producer's half of a product of (m, k) by (o, k): it reads the shape
// alone.
template <int Epi>
__device__ __forceinline__ void produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        long long m, int k, int o, GemmRing& ring) {
  WgArgs p{};
  p.m = m;
  p.k = k;
  p.o = o;
  wgmma_produce<Epi>(map_a, map_b, tile_walk<Epi>(p), product_ksteps<Epi>(p), ring);
}

template <int Epi>
__device__ __forceinline__ void consume(const WgArgs& p, GemmRing& ring) {
  wgmma_consume<Epi, kGeluAny, true>(p, tile_walk<Epi>(p), product_ksteps<Epi>(p), ring);
}

// The stages after a product run on the consumer warps alone. The attention
// and the row passes are separate functions, not inlined: they spill either
// way (header), and the attention stage ran 3.65 ms so, 4.0-4.3 inlined.

template <typename T>
__device__ __noinline__ void rowquant_stage(const T* x, long long rows, int d, int mode,
                                               const float* g, const float* b, float eps,
                                               int8_t* q, float* s) {
  constexpr int kWarpsPerBlock = kConsumers / 32;
  rowquant_rows<T>(x, rows, d, mode, g, b, eps, q, s,
                   (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32,
                   (long long)gridDim.x * kWarpsPerBlock, threadIdx.x % 32);
}

// Attention and its per-token row quant: items (image, 64-row chunk) for the
// teams of ceil(heads / 4) blocks, item it = team, + teams, ...; group g of
// the block of rank r takes head 4 r + g.
template <int Dh>
__device__ __noinline__ void attention_stage(const __nv_bfloat16* qkv, int8_t* aq, float* as,
                                                float* amax, unsigned int* count, int batch,
                                                int n, int heads, float scale, float shift,
                                                int shift_mode, uint8_t* smem) {
  const int group = threadIdx.x / kGroupRows;
  const int tid = threadIdx.x % kGroupRows;
  const int warp = tid / 32;
  const int lane = tid % 32;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + group * attn_group_bytes<Dh>());
  float* part = reinterpret_cast<float*>(smem + kGroups * attn_group_bytes<Dh>());
  float* amax_s = part + kGroups * kGroupRows;
  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int chunks = flash_chunks(n, kGroupWarps);
  const int cb = flash_chunk_blocks(n, chunks);  // row blocks of a chunk
  const int team_blocks = (heads + kGroups - 1) / kGroups;
  const int teams = gridDim.x / team_blocks;
  const int team = blockIdx.x / team_blocks;
  const int rank = blockIdx.x % team_blocks;
  if (team >= teams) return;  // a leftover block: all its consumers idle
  const int h = rank * kGroups + group;
  const int heads_here = min(kGroups, heads - rank * kGroups);  // this block's
  const long long items = (long long)batch * chunks;
  const int r = threadIdx.x;  // the chunk row this thread folds and scales
  for (long long it = team; it < items; it += teams) {
    const int b = (int)(it / chunks);
    const int chunk = (int)(it % chunks);
    const int row0 = chunk * cb * 16;
    const int cblocks = min(cb, (n + 15) / 16 - chunk * cb);
    float o[2][Dh / 8][4];
    float l[2][2];
    bool has[2] = {false, false};
    if (h < heads) {
      flash_attention_rows<Dh, kGroupWarps, kGroupStages, true>(
          qkv + (long long)b * n * row_stride + h * Dh, row_stride, d_model, row0, cblocks, n,
          n, scale, shift, shift_mode, part + group * kGroupRows, tile, o, l, has, tid,
          kBarGroup + group);
      flash_quant_normalize<Dh, kGroupWarps>(o, l, has, part + group * kGroupRows, warp, lane);
    }
    named_bar_sync(kBarConsumers, kConsumers);
    // row r's max |o| over this block's heads, then over the team's
    const bool row_ok = r < cblocks * 16 && row0 + r < n;
    const long long row = (long long)b * n + row0 + r;
    float mx = 0.f;
    if (row_ok) {
      for (int g = 0; g < heads_here; ++g) mx = fmaxf(mx, part[g * kGroupRows + r]);
    }
    if (team_blocks == 1) {
      if (row_ok) amax_s[r] = fmaxf(mx, 1e-8f);
    } else {
      // non-negative floats order as their bits: exact in any order
      if (row_ok) atomicMax(reinterpret_cast<unsigned int*>(amax + row), __float_as_uint(mx));
      named_bar_sync(kBarConsumers, kConsumers);
      if (threadIdx.x == 0) {
        // release: the fence orders the block's maxima (before it through the
        // barrier) before the count; acquire: the last poll, and the barrier
        // after it, order the block's reads of amax after the counts
        __threadfence();
        atomicAdd(count + it, 1u);
        for (uint32_t spins = 0; ld_acquire(count + it) < (unsigned)team_blocks; ++spins) {
          if (spins > kSpinLimit) __trap();
          __nanosleep(32);
        }
      }
      named_bar_sync(kBarConsumers, kConsumers);
      if (row_ok) amax_s[r] = fmaxf(__ldcg(amax + row), 1e-8f);
    }
    if (rank == 0 && row_ok) as[row] = __fmul_rn(amax_s[r], kInv127);
    named_bar_sync(kBarConsumers, kConsumers);
    if (h < heads) {
      flash_quant_store<Dh, kGroupWarps>(
          o, has, amax_s,
          reinterpret_cast<int8_t*>(tile + flash_q_offset<Dh, kGroupStages>()),
          aq + (long long)b * n * d_model + h * Dh, d_model, row0, n, warp, lane);
    }
    named_bar_sync(kBarConsumers, kConsumers);  // tiles, part, amax_s free again
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_block_kernel(const __grid_constant__ FusedMaps maps, const FusedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full_bar[kRing];
  __shared__ __align__(8) uint64_t empty_bar[kRing];
  cg::grid_group grid = cg::this_grid();
  const long long m = (long long)a.batch * a.n;
  const int d = a.heads * a.head_dim;
  unsigned long long* const stage_ns = a.stage_ns;
  // A stage ends for the whole grid: every thread fences the proxies (codes
  // written by generic stores are read by the next product's TMA, which also
  // refills the shared memory the stage used), all blocks meet.
  auto barrier = [&grid, stage_ns](int slot) {
    proxy_fence();
    grid.sync();
    proxy_fence();
    mark_stage(stage_ns, slot);
  };
  mark_stage(stage_ns, 0);
  GemmRing ring = ring_init(smem, full_bar, empty_bar);
  for (long long i = (long long)blockIdx.x * kWgThreads + threadIdx.x; i < a.zero_words;
       i += (long long)gridDim.x * kWgThreads) {
    a.zero[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // the ring's barriers are initialized

  // The warpgroups split once: the producer's gives its registers to the
  // consumers' for the whole kernel; both meet at the grid barriers.
  if (threadIdx.x / 128 == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    produce<kWgBias>(&maps.xq, &maps.wqkv, m, d, 3 * d, ring);  // 1. qkv
    barrier(1);
    barrier(2);  // 2. attention
    produce<kWgRes>(&maps.aq, &maps.wproj, m, d, d, ring);  // 3. proj
    barrier(3);
    barrier(4);  // 4. LN2
    produce<kWgGeluQuant>(&maps.hq, &maps.wfc1, m, d, a.o1, ring);  // 5. fc1
    barrier(5);
    produce<kWgRes>(&maps.gq, &maps.wfc2, m, a.o1, d, ring);  // 6. fc2
    barrier(6);  // 7. next LN1
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));

  // 1. qkv = bf16(y(xq, Wqkv))
  consume<kWgBias>(WgArgs{a.xs, a.sqkv, a.bqkv, nullptr, a.qkv_out, nullptr, nullptr, nullptr,
                          nullptr, m, d, 3 * d, a.gelu},
                   ring);
  barrier(1);

  // 2. aq, as = rowquant(attention(qkv))
  switch (a.head_dim) {
    case 16:
      attention_stage<16>(a.qkv_out, a.aq, a.as, a.att_amax, a.att_count, a.batch, a.n,
                          a.heads, a.scale, a.shift, a.shift_mode, smem);
      break;
    case 32:
      attention_stage<32>(a.qkv_out, a.aq, a.as, a.att_amax, a.att_count, a.batch, a.n,
                          a.heads, a.scale, a.shift, a.shift_mode, smem);
      break;
    default:
      attention_stage<64>(a.qkv_out, a.aq, a.as, a.att_amax, a.att_count, a.batch, a.n,
                          a.heads, a.scale, a.shift, a.shift_mode, smem);
      break;
  }
  barrier(2);

  // 3. x1 = bf16(res + y(aq, Wproj))
  consume<kWgRes>(WgArgs{a.as, a.sproj, a.bproj, a.res, a.x1, nullptr, nullptr, nullptr,
                         nullptr, m, d, d, a.gelu},
                  ring);
  barrier(3);

  // 4. hq, hs = rowquant(LN2(x1)): the LN reads the rounded x1
  rowquant_stage<__nv_bfloat16>(a.x1, m, d, kRowLn, a.g2, a.b2, a.eps, a.hq, a.hs);
  barrier(4);

  // 5. gq, gs = rowquant(gelu(y(hq, Wfc1)))
  consume<kWgGeluQuant>(WgArgs{a.hs, a.sfc1, a.bfc1, nullptr, nullptr, a.fc1_amax,
                               a.fc1_count, a.gq, a.gs, m, d, a.o1, a.gelu},
                        ring);
  barrier(5);

  // 6. x2 = bf16(x1 + y(gq, Wfc2)) -> x_new
  consume<kWgRes>(WgArgs{a.gs, a.sfc2, a.bfc2, a.x1, a.xn, nullptr, nullptr, nullptr,
                         nullptr, m, a.o1, d, a.gelu},
                  ring);
  barrier(6);

  // 7. yq, ys = rowquant(LN_next(x2))
  rowquant_stage<__nv_bfloat16>(a.xn, m, d, kRowLn, a.gn, a.bn, a.eps, a.yq, a.ys);
  mark_stage(stage_ns, kBlockStages);
}

constexpr long long kAlign = 256;
constexpr int kScratch = 12;  // arrays in the scratch

long long aligned(long long bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

// Offsets of the scratch arrays in the caller's buffer, in FusedArgs order;
// the last entry is the total size. The attention's counts are one per
// (image, chunk) item, at most one per row.
void scratch_layout(long long m, int d, int o1, long long (&off)[kScratch + 1]) {
  const long long panels = (m + kTileM - 1) / kTileM;
  const long long sizes[kScratch] = {m * 3 * d * 2, m * d, m * 4, m * d * 2, m * d, m * 4,
                                     m * o1,        m * 4, m * 4, m * 4,     m * 4, panels * 4};
  off[0] = 0;
  for (int i = 0; i < kScratch; ++i) off[i + 1] = off[i] + aligned(sizes[i]);
}

cudaError_t launch(const FusedMaps& maps, const FusedArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_block_kernel, kWgThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = per_sm * sms;
  // fc1 needs one whole group of column-tile blocks, attention one team
  const int tiles_n = (a.o1 + kTileN - 1) / kTileN;
  const int team_blocks = (a.heads + kGroups - 1) / kGroups;
  if (grid < tiles_n || grid < team_blocks) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_block_kernel, maps, a);
}

}  // namespace

// Bytes of scratch cvt_fused_block needs for m = batch * n rows of width d
// and an MLP width of o1.
extern "C" long long cvt_fused_block_scratch_bytes(long long m, int d, int o1) {
  long long off[kScratch + 1];
  scratch_layout(m, d, o1, off);
  return off[kScratch];
}

// xq int8 (batch, n, d), xs f32 (batch, n), res bf16 (batch, n, d), with
// d = heads * head_dim; w* int8 (O, K), K contiguous: wqkv (3d, d), wproj
// (d, d), wfc1 (o1, d), wfc2 (d, o1); s* and b* the f32 column scales and
// biases; g2, b2 and gn, bn the f32 (d,) LayerNorm parameters of this
// block's norm2 and the next block's norm1. scratch: at least
// cvt_fused_block_scratch_bytes bytes, 256-byte aligned. Outputs: xn bf16
// (batch, n, d), yq int8 (batch, n, d), ys f32 (batch, n). shift_mode: 0
// the exact row max, 1 exp(s - shift) with the given shift, 2 the bound
// |q_i| max_j |k_j| - 45 of each row and head (FlashShift). gelu: 0 erf,
// 1 sigmoid, 2 hard. stage_ns: null, or 8 x u64 that receive the card's
// nanosecond clock at the start and after each of the 7 stages. d % 16 == 0,
// o1 % 16 == 0, head_dim 16, 32 or 64; every pointer 16-byte aligned, tensors
// contiguous. One kernel launch; returns its cudaError_t.
extern "C" int cvt_fused_block(
    const void* xq, const void* xs, const void* res, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj,
    const void* g2, const void* b2, const void* wfc1, const void* sfc1, const void* bfc1,
    const void* wfc2, const void* sfc2, const void* bfc2, const void* gn, const void* bn,
    void* scratch, void* xn, void* yq, void* ys, int batch, int n, int heads, int head_dim,
    int o1, float scale, float shift, int shift_mode, int gelu, float eps, void* stage_ns,
    void* stream) {
  const long long m = (long long)batch * n;
  const int d = heads * head_dim;
  if (batch < 1 || n < 1 || heads < 1 || d % 16 || o1 < 16 || o1 % 16 || d > kRowMaxD ||
      o1 > kRowMaxD || gelu < kGeluErf || gelu > kGeluHard || shift_mode < kShiftMax ||
      shift_mode > kShiftBound || m > 0x7fffffffLL - kTileM ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64)) {
    return (int)cudaErrorInvalidValue;
  }
  long long off[kScratch + 1];
  scratch_layout(m, d, o1, off);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  FusedArgs a{};
  a.xs = f32(xs);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.sqkv = f32(sqkv);
  a.bqkv = f32(bqkv);
  a.sproj = f32(sproj);
  a.bproj = f32(bproj);
  a.sfc1 = f32(sfc1);
  a.bfc1 = f32(bfc1);
  a.sfc2 = f32(sfc2);
  a.bfc2 = f32(bfc2);
  a.g2 = f32(g2);
  a.b2 = f32(b2);
  a.gn = f32(gn);
  a.bn = f32(bn);
  a.qkv_out = reinterpret_cast<__nv_bfloat16*>(sc + off[0]);
  a.aq = reinterpret_cast<int8_t*>(sc + off[1]);
  a.as = reinterpret_cast<float*>(sc + off[2]);
  a.x1 = reinterpret_cast<__nv_bfloat16*>(sc + off[3]);
  a.hq = reinterpret_cast<int8_t*>(sc + off[4]);
  a.hs = reinterpret_cast<float*>(sc + off[5]);
  a.gq = reinterpret_cast<int8_t*>(sc + off[6]);
  a.gs = reinterpret_cast<float*>(sc + off[7]);
  a.att_amax = reinterpret_cast<float*>(sc + off[8]);
  a.fc1_amax = reinterpret_cast<float*>(sc + off[9]);
  a.att_count = reinterpret_cast<unsigned int*>(sc + off[10]);
  a.fc1_count = reinterpret_cast<unsigned int*>(sc + off[11]);
  a.zero = reinterpret_cast<uint4*>(sc + off[8]);
  a.zero_words = (off[12] - off[8]) / 16;
  a.xn = static_cast<__nv_bfloat16*>(xn);
  a.yq = static_cast<int8_t*>(yq);
  a.ys = static_cast<float*>(ys);
  a.batch = batch;
  a.n = n;
  a.heads = heads;
  a.head_dim = head_dim;
  a.o1 = o1;
  a.scale = scale;
  a.shift = shift;
  a.shift_mode = shift_mode;
  a.gelu = gelu;
  a.eps = eps;
  a.stage_ns = static_cast<unsigned long long*>(stage_ns);

  FusedMaps maps;
  constexpr int kK = stage_k(kWgBias);       // 128 bytes of K a stage
  constexpr int kKfc1 = stage_k(kWgGeluQuant);  // 64
  if (!make_map(&maps.xq, xq, m, d, kTileM, kK) ||
      !make_map(&maps.wqkv, wqkv, 3LL * d, d, kTileN, kK) ||
      !make_map(&maps.aq, a.aq, m, d, kTileM, kK) ||
      !make_map(&maps.wproj, wproj, d, d, kTileN, kK) ||
      !make_map(&maps.hq, a.hq, m, d, kTileM, kKfc1) ||
      !make_map(&maps.wfc1, wfc1, o1, d, kTileN, kKfc1) ||
      !make_map(&maps.gq, a.gq, m, o1, kTileM, kK) ||
      !make_map(&maps.wfc2, wfc2, d, o1, kTileN, kK)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(maps, a, static_cast<cudaStream_t>(stream));
}
