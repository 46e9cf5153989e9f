// Multi-head attention forward, read straight from the packed qkv projection.
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention (_attn_kernel): for every (image, head),
// softmax(Q K^T / sqrt(Dh)) V, where Q, K and V are the column ranges
// [h*Dh, (h+1)*Dh) + {0, D, 2D} of qkv (B, N, 3*D), D = H*Dh, and the
// result lands in out (B, N, D). No (B, N, 3, H, Dh) permute copy is made.
// Scores, softmax and accumulation in f32, one bf16 rounding of the output.
//
// Bound on this card: at the serving shape (256, 257, 2304) the call reads
// qkv (303 MB) and writes out (101 MB): 0.1207 ms at 3.35 TB/s; its two
// products are 52 GFLOP, 0.053 ms at 989 TFLOP/s. Bytes bound it. The
// softmax's exp over the N x N scores runs on the CUDA cores: 203 M exp2 at
// 16 a clock per SM, about 0.05 ms more that the tensor cores cannot hide.
//
// Design: the loop of attention_loop.cuh (what it does and why is there):
// one block of 3 warps per (chunk of up to 96 query rows, head, image), two
// 16-row blocks a warp, 16-row and 16-key edges (272 x 272 for 257 tokens,
// where the earlier 64-row tiles did 320 x 320), Q and a 2-stage ring of
// 64-key K/V tiles copied by cp.async, every operand by ldmatrix, V by
// ldmatrix.trans as it lies, S computed twice a 64-key step to keep the
// registers under 168. Any N: the keys go through the ring, so no sequence
// length is too long for shared memory. The three chunks of a head (6, 6
// and 5 row blocks at 257 tokens) run side by side, so K and V come from
// device memory once and from L2 after. The output is staged in the chunk's
// Q rows and stored 16 bytes a lane.
//
// Bits: each score, exponential, row sum and product is the earlier kernel's
// (one block of 4 warps per 64-row tile, 64-key tiles, K and V through 32-bit
// loads): the online max is rescaled at the same 64-key steps, p is
// exp2f(fmaf(s, scale log2 e, -m scale log2 e)), the per-thread partial row
// sums and their final shuffles are taken in the same order, and mma.sync
// gets the same fragments in the same key order. Sub-steps past the last
// key, whose p were exact zeros, are skipped. So the output equals the
// earlier kernel's bit for bit (experiments/kernel_ab.py checks it: 0.0 max
// |difference| on the H100 at both path shapes).
//
// Shape: 3 warps a block, 4 blocks an SM (12 warps, so ptxas may give a
// thread 168 registers), 50,688 bytes of shared memory a block at Dh = 64.
// ptxas (CUDA 12.8, sm_90a): 168 registers at Dh = 64 with 116 bytes
// spilled, 168 at Dh = 32, 160 at Dh = 16; chip_smoke.py phase 4 prints the
// counts of its own build. Of the shapes tried, 2 warps x 4 blocks and 4 x 3
// were slower and 4 x 4 spilled. Head dims 80 and 128 (ViT-Huge's 80) run
// the same loop on fewer blocks an SM (min_blocks); a head dim between two
// instantiations runs the larger (cvt::flash_head_dim). Phase 25 of
// chip_smoke.py prints their counts and times.
//
// What bounds it now: not bytes. At the serving shape it takes about 3.3x
// its byte bound, while its products and exponentials each need under 0.1
// ms at the card's rates, so the 12 warps an SM wait on the softmax's chain
// (S, the row max, two shuffles, the exponentials) with too little else to
// issue; computing S twice adds half the tensor work again. Overlapping one
// step's softmax with the next step's products (a wgmma S, or warps
// specialized into producer and consumers) is the next design. Its timings
// are in PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_loop.cuh"

namespace {

constexpr int kWarps = 3;      // warps a block, 32 query rows each
constexpr int kStages = 2;     // K/V tiles in the ring

// Blocks an SM: 4 up to Dh = 64 (12 warps, 168 registers a thread; 4 blocks
// of 50,688 bytes fit 228 KB). Above, the accumulators o[2][Dh / 8][4] and
// Q's fragments grow (120 registers at 80, 192 at 128) and so does the
// block's shared memory (61,952 bytes at 80, 95,744 at 128): 3 blocks (227
// registers) at 80, 2 (255) at 128.
template <int Dh>
constexpr int min_blocks() {
  return Dh <= 64 ? 4 : Dh <= 80 ? 3 : 2;
}

template <int Dh>
__global__ void __launch_bounds__(32 * kWarps, min_blocks<Dh>())
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     int n, int heads, int dh, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kLd = Dh + cvt::kFlashPad;
  const int d_model = heads * dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int chunk = blockIdx.x;
  const int cb = cvt::flash_chunk_blocks(n, gridDim.x);  // row blocks of a chunk
  const int row0 = chunk * cb * 16;
  const int cblocks = min(cb, (n + 15) / 16 - chunk * cb);
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * dh;

  float o[2][Dh / 8][4];
  float l[2][2];
  bool has[2];
  cvt::flash_attention_rows<Dh, kWarps, kStages, false>(q_base, row_stride, d_model, row0, cblocks, n,
                                               n, scale_log2, 0.f, cvt::kShiftMax, nullptr,
                                               smem, o, l, has,
                                               threadIdx.x, 0, dh);

  // the warp's rows, rounded to bf16, into its own rows of the Q tile, then
  // to device memory 16 bytes a lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  __nv_bfloat16* stage = smem + cvt::flash_q_offset<Dh, kStages>();
  __nv_bfloat16* o_base = out + (long long)b * n * d_model + h * dh;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!has[j]) continue;
    const int rb = warp + j * kWarps;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = 1.f / l[j][i];
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) {
      __nv_bfloat16* at = stage + (rb * 16 + g) * kLd + nb * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(at) =
          cvt::flash_pack(o[j][nb][0] * inv[0], o[j][nb][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(at + 8 * kLd) =
          cvt::flash_pack(o[j][nb][2] * inv[1], o[j][nb][3] * inv[1]);
    }
    __syncwarp();
    constexpr int kChunks = Dh / 8;
    for (int idx = lane; idx < 16 * kChunks; idx += 32) {
      const int r = rb * 16 + idx / kChunks;
      const int c = (idx % kChunks) * 8;
      if (row0 + r < n && c < dh) {  // columns past dh are zero, not the head's
        *reinterpret_cast<uint4*>(o_base + (long long)(row0 + r) * d_model + c) =
            *reinterpret_cast<const uint4*>(stage + r * kLd + c);
      }
    }
  }
}

template <int Dh>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads, int dh,
                   float scale_log2, cudaStream_t stream) {
  const int bytes = 2 * cvt::flash_smem_elems<Dh, kWarps, kStages>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(cvt::flash_chunks(n, kWarps), heads, batch);
  attention_fwd_kernel<Dh><<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n, heads, dh,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim), contiguous, 16-byte aligned;
// head_dim a multiple of 8 up to 128 (cvt::flash_head_dim names the
// instantiation that runs it). out: bf16 (batch, n, heads * head_dim).
// scale: the softmax temperature (1 / sqrt(head_dim) for standard
// attention). Returns the launch's cudaError_t.
extern "C" int cvt_attention_fwd(const void* qkv, void* out, int batch, int n, int heads,
                                 int head_dim, float scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = head_dim;
  switch (cvt::flash_head_dim(dh)) {
    case 16: return (int)launch<16>(qkv, out, batch, n, heads, dh, scale_log2, s);
    case 32: return (int)launch<32>(qkv, out, batch, n, heads, dh, scale_log2, s);
    case 64: return (int)launch<64>(qkv, out, batch, n, heads, dh, scale_log2, s);
    case 80: return (int)launch<80>(qkv, out, batch, n, heads, dh, scale_log2, s);
    case 128: return (int)launch<128>(qkv, out, batch, n, heads, dh, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
