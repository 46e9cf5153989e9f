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
// cores rather than HBM become the limit: compute-bound.
//
// Design:
//  - one main loop for every variant: 128 x 128 output tiles, 8 warps of
//    64 x 32, mma.sync m16n8k32 s8 x s8 -> s32 with operands read by
//    ldmatrix; K in steps of 64 bytes through a 3-stage cp.async ring in
//    dynamic shared memory (rows padded to 80 bytes, so ldmatrix's eight
//    16-byte row reads hit distinct banks). B is the weight stored (O, K),
//    K contiguous: the "col" operand of mma.sync, no transpose anywhere;
//  - the grid runs over output-column tiles fastest, so the blocks on the
//    card at one time share their rows of xq and read them from L2;
//  - ragged M, O and K edges are zero-filled by cp.async's source size and
//    masked at the store;
//  - the epilogue is per element: y in f32 with every product and sum an
//    explicit round-to-nearest intrinsic (no FMA contraction), in the JAX
//    order ((acc * xs) * ws) + bias, then bias-only -> bf16, residual ->
//    bf16, or GELU -> f32;
//  - K8 and K9 end in a reduction over the whole output row (abs-max over
//    3072 columns; mean, variance and abs-max over 768) that one tile does
//    not see. Staging a full row block in shared memory would need BM x O
//    f32 (16 x 3072 x 4 = 192 KB at most), and a 16-row block re-reads the
//    whole 2.4 MB fc1 weight 4,112 times per call. So the GEMM writes its
//    epilogue values to HBM (bf16 x' for K9, which LN reads rounded as in
//    the JAX code; f32 GELU output for K8, so requantization starts from
//    f32 values as in the JAX code) and the row pass of rowquant.cuh
//    quantizes them, inside the same entry point.
// Not yet done (later work): wgmma, TMA, a persistent schedule, the row
// reduction fused into the GEMM through a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rowquant.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;  // bytes of K per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRowBytes = kBK + 16;  // padded shared-memory row
constexpr int kTileBytes = kBM * kRowBytes;
constexpr int kStageBytes = 2 * kTileBytes;  // A tile + B tile (kBN == kBM)
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kLoadIters = kBM * (kBK / 16) / kThreads;  // 16-byte copies
static_assert(kBN == kBM, "one tile size for A and B");
static_assert(kLoadIters * kThreads == kBM * (kBK / 16), "whole tiles per stage");

enum Epilogue : int {
  kEpiBias = 0,     // bf16(y)                     qkv
  kEpiRes = 1,      // bf16(res + y)               K10
  kEpiResLnQ = 2,   // bf16(res + y), then LN row quant   K9
  kEpiGeluQ = 3,    // f32 gelu(y), then row quant        K8
};

enum Gelu : int { kGeluErf = 0, kGeluSigmoid = 1, kGeluHard = 2 };

struct GemmArgs {
  const int8_t* xq;      // (m, k)
  const float* xs;       // (m,)
  const int8_t* w;       // (o, k)
  const float* ws;       // (o,)
  const float* bias;     // (o,)
  const __nv_bfloat16* res;  // (m, o) for the residual epilogues
  void* out;             // (m, o) bf16, or f32 for kEpiGeluQ
  long long m;
  int k;
  int o;
  int gelu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu(float x, int mode) {
  return mode == kGeluSigmoid ? cvt::gelu_sigmoid_div(x)
         : mode == kGeluHard  ? cvt::gelu_hard(x)
                              : cvt::gelu_erf(x);
}

template <int Epi>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int wm = (warp / 4) * 64;  // warp's rows within the tile
  const int wn = (warp % 4) * 32;  // warp's columns within the tile

  auto load_stage = [&](int stage, int kt) {
    uint8_t* sa = smem + stage * kStageBytes;
    uint8_t* sb = sa + kTileBytes;
    const int kb = kt * kBK;
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kBK / 16);
      const int c = (i % (kBK / 16)) * 16;
      const bool k_ok = kb + c < p.k;
      const bool a_ok = k_ok && m0 + r < p.m;
      const bool b_ok = k_ok && n0 + r < p.o;
      cp_async16(sa + r * kRowBytes + c, a_ok ? p.xq + (m0 + r) * p.k + kb + c : p.xq,
                 a_ok);
      cp_async16(sb + r * kRowBytes + c,
                 b_ok ? p.w + (long long)(n0 + r) * p.k + kb + c : p.w, b_ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % kStages) * kStageBytes;
    const uint8_t* sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(a[mt], sa + (wm + mt * 16 + lane % 16) * kRowBytes + kk +
                               (lane / 16) * 16);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn + np * 16 + lane % 8 + (lane / 16) * 8) * kRowBytes +
                           kk + ((lane / 8) % 2) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread holds rows (g, g + 8) x columns (2t, 2t + 1) of each
  // 16 x 8 tile.
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= p.m) continue;
      const float xs = p.xs[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + t * 2;
        if (col >= p.o) continue;  // o % 8 == 0: both columns or neither
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __fmul_rn(__fmul_rn((float)acc[mt][nt][half * 2 + e], xs),
                                    p.ws[col + e]);
          y[e] = __fadd_rn(a, p.bias[col + e]);
        }
        const long long at = row * p.o + col;
        if (Epi == kEpiGeluQ) {
          float2 v = make_float2(gelu(y[0], p.gelu), gelu(y[1], p.gelu));
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = v;
        } else {
          if (Epi != kEpiBias) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.res + at));
            y[0] = __fadd_rn(r.x, y[0]);
            y[1] = __fadd_rn(r.y, y[1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
  }
}

template <int Epi>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.o + kBN - 1) / kBN, (unsigned)((a.m + kBM - 1) / kBM));
  int8_gemm_kernel<Epi><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y = f32(xq @ w^T) * xs * ws + bias with xq int8 (m, k), xs f32 (m,),
// w int8 (o, k) (K contiguous), ws and bias f32 (o,); then by epilogue:
//   0  out = bf16(y)                                         out bf16 (m, o)
//   1  out = bf16(res + y)                                   res, out bf16
//   2  out = bf16(res + y); yq, ys = rowquant(LN(out))       + ln_g, ln_b f32
//   3  out = gelu(y) (f32 scratch); yq, ys = rowquant(out)   gelu 0 erf,
//                                                            1 sigmoid, 2 hard
// yq int8 (m, o), ys f32 (m,). k % 16 == 0, o % 8 == 0, every pointer
// 16-byte aligned, tensors contiguous. Returns the first failing launch's
// cudaError_t.
extern "C" int cvt_int8_matmul(const void* xq, const void* xs, const void* w,
                               const void* ws, const void* bias, const void* res,
                               void* out, long long m, int k, int o,
                               int epilogue, int gelu, const void* ln_g,
                               const void* ln_b, float eps, void* yq, void* ys,
                               void* stream) {
  if (m < 1 || k < 16 || k % 16 || o < 8 || o % 8 ||
      (m + kBM - 1) / kBM > 65535 || epilogue < kEpiBias || epilogue > kEpiGeluQ ||
      gelu < kGeluErf || gelu > kGeluHard) {
    return (int)cudaErrorInvalidValue;
  }
  GemmArgs a{static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
             static_cast<const int8_t*>(w),  static_cast<const float*>(ws),
             static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
             out, m, k, o, gelu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(yq);
  float* s = static_cast<float*>(ys);
  cudaError_t err;
  switch (epilogue) {
    case kEpiBias:
      return (int)launch_gemm<kEpiBias>(a, st);
    case kEpiRes:
      return (int)launch_gemm<kEpiRes>(a, st);
    case kEpiResLnQ:
      err = launch_gemm<kEpiRes>(a, st);
      if (err != cudaSuccess) return (int)err;
      return (int)cvt::launch_rowquant(static_cast<const __nv_bfloat16*>(out), m, o,
                                       cvt::kRowLn, static_cast<const float*>(ln_g),
                                       static_cast<const float*>(ln_b), eps, q, s, st);
    default:  // kEpiGeluQ
      err = launch_gemm<kEpiGeluQ>(a, st);
      if (err != cudaSuccess) return (int)err;
      return (int)cvt::launch_rowquant(static_cast<const float*>(out), m, o,
                                       cvt::kRowNone, nullptr, nullptr, 0.f, q, s, st);
  }
}
