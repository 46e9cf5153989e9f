// Multi-head attention backward into the packed dqkv layout.
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention_bwd (_attn_bwd_kernel): from the saved packed projection
// qkv (B, N, 3*D), D = H*Dh, and the cotangent g (B, N, D) of the attention
// output, for every (image, head):
//   S = Q K^T * scale (f32), pn = softmax(S) (max-shifted, normalized in f32),
//   dV = bf16(pn)^T g,  dP = g V^T,  r = rowsum(dP * pn),
//   dS = bf16(pn * (dP - r) * scale),  dQ = dS K,  dK = dS^T Q,
// f32 accumulation, one bf16 rounding of each output, written at columns
// h*Dh, D + h*Dh and 2*D + h*Dh of dqkv (B, N, 3*D): no permute copy. The
// N x N tiles never reach device memory.
//
// Bound on this card: at the ViT-B shape (B 256, N 257, Dh 64) the call reads
// qkv (303 MB) and g (101 MB) and writes dqkv (303 MB): 0.21 ms at 3.35 TB/s;
// its five products are 130 GFLOP, 0.13 ms at 989 TFLOP/s. Bytes bound it.
//
// Design: one block of 9 warps per (image, head), one launch, deterministic
// (no atomics: two runs agree bit for bit).
//  - The head's Q, K, V and g (N rows padded to a multiple of 16, at most
//    288) are copied into shared memory once with cp.async, rows padded by 8
//    bf16 so that ldmatrix's eight row reads hit distinct banks; every byte
//    of qkv and g is read from device memory once, every byte of dqkv
//    written once.
//  - Query rows are cut into blocks of 16; warp w owns blocks w and w + 9.
//    Sweep 1 walks the keys 32 at a time with an online max-shifted sum and
//    leaves the row statistics (m, 1/l, r) of the warp's rows in registers:
//    no scratch in device memory (the forward saves nothing but qkv, as the
//    JAX package's).
//  - Sweep 2 walks the keys 32 at a time again. Phase A: each warp recomputes
//    S and dP for its rows, forms pn and dS once, adds dS K into its dQ
//    accumulators (dS re-packed in registers as the A fragment) and stores
//    bf16(pn) and dS into a (rows x 32) staging tile in shared memory. Phase
//    B: eight warps each take one of dK / dV, 16 of the 32 keys and half of
//    the head dim, and sum dS^T Q (pn^T g) over all query blocks in a fixed
//    order, reading the staging tile and Q (g) through ldmatrix.trans; the
//    32 keys' dK and dV rows are then final and go to device memory.
//    7 products (2 + 5) where the TPU kernel does 5.
//  - The ragged edge is handled per 16 rows or keys: 257 tokens cost 272 x
//    272 score elements per sweep (1.12x), keys past N are masked to -inf
//    (pn = 0, dS = 0), query rows past N get the statistics (0, 0, 0) so
//    they add nothing to dK and dV, and are not stored.
//  - Products are mma.sync m16n8k16 with every operand fragment read by
//    ldmatrix (.trans where the product wants the stored tile transposed),
//    not wgmma: its fixed 64-row M would spend 320 rows on 257 tokens
//    (1.38x in both directions of dK/dV) and make the 16-row split of the
//    statistics and of dQ across warps impossible; wgmma was not measured.
//  exp2 with scale*log2(e) folded. Against the JAX kernel the arithmetic
//  differs only in f32 rounding order: pn = exp2(...) * (1/l) for
//  exp(...) / l, and r from the online sum.
// ptxas -v (CUDA 12.8, -O3): 155, 121 and 92 registers for head dims 64, 32
// and 16, no spills; 200,192 bytes of dynamic shared memory at N 257, Dh 64
// (chip_smoke.py phase 10 prints both), so one block of 9 warps per SM.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W: 1.26 ms at (256, 257,
// 2304), 2.94 before this design, the library's backward 1.01): not
// occupancy (18 warps of one row block each read 1.24 ms) but shared-memory
// traffic. A warp owns 16 rows, so every ldmatrix of K, V, Q or g feeds two
// mma.sync only: ~6 MB of shared-memory reads per head, about half of a
// block's 54 us at 128 bytes a clock.
// Not yet done (later work): a forward that also writes the log-sum-exp
// (sweep 1 then goes), 32 rows a warp so that the B fragments are read half
// as often, the copy-in of the next head under this head's products (one
// block per SM today), 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerWarp = 2;                  // query blocks of 16 rows a warp owns
constexpr int kMaxN = 16 * kBlocksPerWarp * kWarps;  // 288 tokens
constexpr int kChunk = 32;                         // keys per step
constexpr int kPad = 8;                            // bf16 padding per shared-memory row
constexpr int kStageLd = kChunk + kPad;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments (16 rows x Dh) of rows r0 .. r0 + 15 of a row-major tile.
template <int Dh>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dh / 16][4], const __nv_bfloat16* tile,
                                       int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + (r0 + lane % 16) * (Dh + kPad) + kk * 16 + (lane / 16) * 8);
  }
}

// s (16 x 32 scores of the warp's rows against keys k0 .. k0 + 31) = A * tile^T,
// 16 keys at a time; a half whose keys all lie past n is skipped (s stays 0).
template <int Dh>
__device__ __forceinline__ void scores(float (&s)[4][4], const uint32_t (&a)[Dh / 16][4],
                                       const __nv_bfloat16* tile, int k0, int n, int lane) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (k0 + half * 16 >= n) continue;
    const __nv_bfloat16* rows =
        tile + (k0 + half * 16 + lane % 8 + (lane / 16) * 8) * (Dh + kPad) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, rows + kk * 16);
      mma_bf16_16816(s[half * 2], a[kk], b[0], b[1]);
      mma_bf16_16816(s[half * 2 + 1], a[kk], b[2], b[3]);
    }
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ grad,
                     __nv_bfloat16* __restrict__ dqkv, int n, int heads, float scale,
                     float scale_log2) {
  static_assert(Dh == 16 || Dh == 32 || Dh == 64, "head dim must be 16, 32 or 64");
  constexpr int kLd = Dh + kPad;
  extern __shared__ __align__(16) uint8_t smem[];

  const int nblk = (n + 15) / 16;
  const int np = nblk * 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + np * kLd;
  __nv_bfloat16* vs = ks + np * kLd;
  __nv_bfloat16* gs = vs + np * kLd;
  __nv_bfloat16* ps = gs + np * kLd;         // bf16(pn), (np, 32) per step
  __nv_bfloat16* dss = ps + np * kStageLd;   // dS, (np, 32) per step

  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;
  const __nv_bfloat16* g_base = grad + (long long)b * n * d_model + h * Dh;
  __nv_bfloat16* o_base = dqkv + (long long)b * n * row_stride + h * Dh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // the head's four operands, once; rows at or past n are zero-filled
  constexpr int kChunks = Dh / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < np * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = r < n;
    const __nv_bfloat16* src = q_base + (long long)(ok ? r : 0) * row_stride + c;
    cp_async16(qs + r * kLd + c, src, ok);
    cp_async16(ks + r * kLd + c, src + d_model, ok);
    cp_async16(vs + r * kLd + c, src + 2 * d_model, ok);
    cp_async16(gs + r * kLd + c, g_base + (long long)(ok ? r : 0) * d_model + c, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // Sweep 1: row max m (raw score units), l = sum exp(scale * (S - m)) and
  // racc = sum dP * exp(scale * (S - m)), online over the keys; then
  // shift = m * scale * log2(e), inv = 1 / l, rr = racc / l.
  float shift[kBlocksPerWarp][2], inv[kBlocksPerWarp][2], rr[kBlocksPerWarp][2];
#pragma unroll
  for (int j = 0; j < kBlocksPerWarp; ++j) {
    const int blk = warp + j * kWarps;
    shift[j][0] = shift[j][1] = inv[j][0] = inv[j][1] = rr[j][0] = rr[j][1] = 0.f;
    if (blk >= nblk) continue;
    uint32_t qa[Dh / 16][4], ga[Dh / 16][4];
    load_a<Dh>(qa, qs, blk * 16, lane);
    load_a<Dh>(ga, gs, blk * 16, lane);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float racc[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += kChunk) {
      float s[4][4], dp[4][4];
      scores<Dh>(s, qa, ks, k0, n, lane);
      scores<Dh>(dp, ga, vs, k0, n, lane);
      if (k0 + kChunk > n) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + nb * 8 + t * 2 + (e & 1) >= n) s[nb][e] = -INFINITY;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
      }
      float sh[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // every step holds a valid key, so mx is finite; exp2(-inf) = 0
        const float alpha = exp2f((m[i] - mx[i]) * scale_log2);
        l[i] *= alpha;
        racc[i] *= alpha;
        m[i] = mx[i];
        sh[i] = mx[i] * scale_log2;
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = exp2f(fmaf(s[nb][e], scale_log2, -sh[i]));
          l[i] += p;
          racc[i] = fmaf(dp[nb][e], p, racc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], 1);
      racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], 2);
      if (blk * 16 + g + 8 * i < n) {  // rows past n keep (0, 0, 0): pn = 0
        shift[j][i] = m[i] * scale_log2;
        inv[j][i] = 1.f / l[i];
        rr[j][i] = racc[i] * inv[j][i];
      }
    }
  }

  // Sweep 2.
  float dq[kBlocksPerWarp][Dh / 8][4];
#pragma unroll
  for (int j = 0; j < kBlocksPerWarp; ++j)
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) dq[j][nb][0] = dq[j][nb][1] = dq[j][nb][2] = dq[j][nb][3] = 0.f;

  constexpr int kPartD = Dh >= 32 ? 32 : 16;      // head-dim columns of one phase-B item
  constexpr int kItems = 4 * (Dh / kPartD);       // (dK | dV) x key half x head-dim part
  static_assert(kItems <= kWarps, "one phase-B item per warp");

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    // Phase A: pn and dS of the warp's rows against keys k0 .. k0 + 31
#pragma unroll
    for (int j = 0; j < kBlocksPerWarp; ++j) {
      const int blk = warp + j * kWarps;
      if (blk >= nblk) continue;
      float s[4][4], dp[4][4];
      {
        uint32_t a[Dh / 16][4];
        load_a<Dh>(a, qs, blk * 16, lane);
        scores<Dh>(s, a, ks, k0, n, lane);
        load_a<Dh>(a, gs, blk * 16, lane);
        scores<Dh>(dp, a, vs, k0, n, lane);
      }
      uint32_t dsa[2][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        float pn[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = exp2f(fmaf(s[nb][e], scale_log2, -shift[j][i])) * inv[j][i];
          pn[e] = k0 + nb * 8 + t * 2 + (e & 1) >= n ? 0.f : p;
          ds[e] = pn[e] * (dp[nb][e] - rr[j][i]) * scale;
        }
        const uint32_t p_lo = pack_bf16x2(pn[0], pn[1]), p_hi = pack_bf16x2(pn[2], pn[3]);
        const uint32_t d_lo = pack_bf16x2(ds[0], ds[1]), d_hi = pack_bf16x2(ds[2], ds[3]);
        const int at = (blk * 16 + g) * kStageLd + nb * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(ps + at) = p_lo;
        *reinterpret_cast<uint32_t*>(ps + at + 8 * kStageLd) = p_hi;
        *reinterpret_cast<uint32_t*>(dss + at) = d_lo;
        *reinterpret_cast<uint32_t*>(dss + at + 8 * kStageLd) = d_hi;
        dsa[nb / 2][(nb % 2) * 2] = d_lo;
        dsa[nb / 2][(nb % 2) * 2 + 1] = d_hi;
      }
      // dQ += dS K, 16 keys at a time; K read transposed
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (k0 + half * 16 >= n) continue;
        const __nv_bfloat16* rows =
            ks + (k0 + half * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;
#pragma unroll
        for (int c = 0; c < Dh / 16; ++c) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, rows + c * 16);
          mma_bf16_16816(dq[j][2 * c], dsa[half], kb[0], kb[1]);
          mma_bf16_16816(dq[j][2 * c + 1], dsa[half], kb[2], kb[3]);
        }
      }
    }
    __syncthreads();

    // Phase B: dK = dS^T Q and dV = pn^T g of these 32 keys, over all rows
    if (warp < kItems) {
      const int which = warp & 1;  // 0: dK from dS and Q; 1: dV from pn and g
      const int half = (warp >> 1) & 1;
      const int part = warp >> 2;
      if (k0 + half * 16 < n) {
        const __nv_bfloat16* stage = which ? ps : dss;
        const __nv_bfloat16* rows = which ? gs : qs;
        float acc[kPartD / 8][4];
#pragma unroll
        for (int nb = 0; nb < kPartD / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
        const __nv_bfloat16* a_at =
            stage + (lane % 8 + (lane / 16) * 8) * kStageLd + half * 16 + ((lane / 8) % 2) * 8;
        const __nv_bfloat16* b_at =
            rows + (lane % 8 + ((lane / 8) % 2) * 8) * kLd + part * kPartD + (lane / 16) * 8;
        for (int qb = 0; qb < nblk; ++qb) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, a_at + qb * 16 * kStageLd);
#pragma unroll
          for (int c = 0; c < kPartD / 16; ++c) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, b_at + qb * 16 * kLd + c * 16);
            mma_bf16_16816(acc[2 * c], a, bb[0], bb[1]);
            mma_bf16_16816(acc[2 * c + 1], a, bb[2], bb[3]);
          }
        }
        __nv_bfloat16* out = o_base + (1 + which) * d_model + part * kPartD + t * 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + half * 16 + g + 8 * i;
          if (key >= n) continue;
#pragma unroll
          for (int nb = 0; nb < kPartD / 8; ++nb) {
            *reinterpret_cast<uint32_t*>(out + (long long)key * row_stride + nb * 8) =
                pack_bf16x2(acc[nb][2 * i], acc[nb][2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kBlocksPerWarp; ++j) {
    const int blk = warp + j * kWarps;
    if (blk >= nblk) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = blk * 16 + g + 8 * i;
      if (r >= n) continue;
#pragma unroll
      for (int nb = 0; nb < Dh / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(o_base + (long long)r * row_stride + nb * 8 + t * 2) =
            pack_bf16x2(dq[j][nb][2 * i], dq[j][nb][2 * i + 1]);
      }
    }
  }
}

template <int Dh>
cudaError_t launch(const void* qkv, const void* grad, void* dqkv, int batch, int n, int heads,
                   float scale, cudaStream_t stream) {
  const int np = (n + 15) / 16 * 16;
  const int bytes = 2 * np * (4 * (Dh + kPad) + 2 * kStageLd);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  attention_bwd_kernel<Dh><<<dim3(heads, batch), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(grad),
      static_cast<__nv_bfloat16*>(dqkv), n, heads, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim); grad: bf16 (batch, n, heads *
// head_dim); dqkv: bf16, the shape of qkv. All contiguous and 16-byte
// aligned; n at most 288 (a head's operands stay in shared memory). scale:
// the softmax temperature (1 / sqrt(head_dim)). Returns the launch's
// cudaError_t.
extern "C" int cvt_attention_bwd(const void* qkv, const void* grad, void* dqkv,
                                 int batch, int n, int heads, int head_dim,
                                 float scale, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || heads < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch<16>(qkv, grad, dqkv, batch, n, heads, scale, s);
    case 32: return (int)launch<32>(qkv, grad, dqkv, batch, n, heads, scale, s);
    case 64: return (int)launch<64>(qkv, grad, dqkv, batch, n, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
