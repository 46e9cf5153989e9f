// Multi-head attention forward, read straight from the packed qkv projection.
//
// Replaces the TPU kernel chess_vision_tpu/ops/attention.py
// _kernel_attention (_attn_kernel): for every (image, head),
// softmax(Q K^T / sqrt(Dh)) V, where Q, K and V are the column ranges
// [h*Dh, (h+1)*Dh) + {0, D, 2D} of qkv (B, N, 3*D), D = H*Dh, and the
// result lands in out (B, N, D). No (B, N, 3, H, Dh) permute copy is made.
//
// Bound on this card: at the ViT-B serving shape (N = 257, Dh = 64) one
// (image, head) does 4*N*N*Dh = 16.9 MFLOP on 132 KB of q, k, v and output,
// about 130 FLOP per byte, below the ~295 FLOP/byte at which the bf16 tensor
// cores rather than memory become the limit. The softmax's max, exp and sum
// over the N x N scores run on the CUDA cores, not the tensor cores, and at
// Dh = 64 they cost about as many instructions as the two products.
//
// Design (flash-attention-2 form, mma.sync tensor-core tiles):
//  - one block of 4 warps per (query tile of 64 rows, head, image); each warp
//    owns 16 query rows and keeps its Q fragments in registers;
//  - the block walks the keys in tiles of 64: K is staged in shared memory
//    row-major and V transposed, so both operands of m16n8k16 are read as
//    aligned 32-bit pairs; rows are padded by 8 bf16 to keep those reads free
//    of bank conflicts;
//  - scores stay in registers: an online max-shifted softmax in f32
//    (exp2 with the 1/sqrt(Dh) scale and log2(e) folded into one FMA per
//    score), P re-packed in registers as bf16 A fragments for P V, f32
//    accumulation, one bf16 rounding of the output;
//  - the ragged key tail is masked to -inf and zero-filled in shared memory;
//    query rows past N compute on zeros and are not stored.
// Not yet done (later work): wgmma, TMA, double buffering, persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kQTile = 16 * kWarps;  // query rows per block
constexpr int kKTile = 64;           // keys per shared-memory tile
constexpr int kPad = 8;              // bf16 padding per shared-memory row

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

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int Dh>
__global__ void __launch_bounds__(32 * kWarps)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int n, int heads,
                     float scale_log2) {
  static_assert(Dh % 16 == 0 && Dh <= 128, "head dim must be 16..128, x16");
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile][Dh + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[Dh][kKTile + kPad];

  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // q of this head at q_base, k at +d_model, v at +2*d_model
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group
  const int r0 = blockIdx.x * kQTile + warp * 16 + g;  // rows r0 and r0 + 8

  // Q as m16n8k16 A fragments: Dh/16 k-steps of 16 x 16.
  uint32_t qa[Dh / 16][4];
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    const __nv_bfloat16* lo = q_base + (long long)r0 * row_stride + c;
    const __nv_bfloat16* hi = lo + 8 * row_stride;
    const bool lo_ok = r0 < n, hi_ok = r0 + 8 < n;
    qa[kk][0] = lo_ok ? load_pair(lo) : 0u;
    qa[kk][1] = hi_ok ? load_pair(hi) : 0u;
    qa[kk][2] = lo_ok ? load_pair(lo + 8) : 0u;
    qa[kk][3] = hi_ok ? load_pair(hi + 8) : 0u;
  }

  float o[Dh / 8][4];
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }
  // Running max (in raw score units) and per-thread partial row sums for
  // rows r0 (index 0) and r0 + 8 (index 1).
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  constexpr int kChunks = Dh / 8;  // 16-byte chunks per K/V row
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kKTile * kChunks; idx += blockDim.x) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n) {
        const __nv_bfloat16* src = q_base + (long long)(k0 + r) * row_stride + c;
        kv = *reinterpret_cast<const uint4*>(src + d_model);
        vv = *reinterpret_cast<const uint4*>(src + 2 * d_model);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[c + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: kKTile/8 n-blocks of 8 keys.
    float s[kKTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kKTile / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < Dh / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(s[nb], qa[kk], load_pair(kr), load_pair(kr + 8));
      }
    }
    if (k0 + kKTile > n) {
#pragma unroll
      for (int nb = 0; nb < kKTile / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + nb * 8 + t * 2 + (j & 1) >= n) s[nb][j] = -INFINITY;
        }
      }
    }

    // Online softmax. Rows are spread over the 4 threads of a group, so the
    // max is reduced across them; the sums stay per thread until the end.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kKTile / 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // every tile holds a valid key, so mx is finite; exp2(-inf) = 0
      alpha[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      shift[i] = mx[i] * scale_log2;
    }

    // P = exp(scale * (S - max)) as A fragments of P V: n-blocks 2kk and
    // 2kk+1 of S are the left and right halves of k-step kk.
    uint32_t pa[kKTile / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kKTile / 8; ++nb) {
      const float p0 = exp2f(fmaf(s[nb][0], scale_log2, -shift[0]));
      const float p1 = exp2f(fmaf(s[nb][1], scale_log2, -shift[0]));
      const float p2 = exp2f(fmaf(s[nb][2], scale_log2, -shift[1]));
      const float p3 = exp2f(fmaf(s[nb][3], scale_log2, -shift[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int nb = 0; nb < Dh / 8; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        const __nv_bfloat16* vr = &vt[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16_16816(o[nb], pa[kk], load_pair(vr), load_pair(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  __nv_bfloat16* o_base = out + (long long)b * n * d_model + h * Dh;
#pragma unroll
  for (int nb = 0; nb < Dh / 8; ++nb) {
    const int c = nb * 8 + t * 2;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(o_base + (long long)r0 * d_model + c) =
          pack_bf16x2(o[nb][0] * inv[0], o[nb][1] * inv[0]);
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(o_base + (long long)(r0 + 8) * d_model + c) =
          pack_bf16x2(o[nb][2] * inv[1], o[nb][3] * inv[1]);
    }
  }
}

template <int Dh>
void launch(const void* qkv, void* out, int batch, int n, int heads,
            float scale_log2, cudaStream_t stream) {
  const dim3 grid((n + kQTile - 1) / kQTile, heads, batch);
  attention_fwd_kernel<Dh><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      n, heads, scale_log2);
}

}  // namespace

// qkv: bf16 (batch, n, 3 * heads * head_dim), contiguous, 16-byte aligned.
// out: bf16 (batch, n, heads * head_dim). scale: the softmax temperature
// (1 / sqrt(head_dim) for standard attention). Returns the launch's
// cudaError_t.
extern "C" int cvt_attention_fwd(const void* qkv, void* out, int batch, int n,
                                 int heads, int head_dim, float scale,
                                 void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(qkv, out, batch, n, heads, scale_log2, s); break;
    case 32: launch<32>(qkv, out, batch, n, heads, scale_log2, s); break;
    case 64: launch<64>(qkv, out, batch, n, heads, scale_log2, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
