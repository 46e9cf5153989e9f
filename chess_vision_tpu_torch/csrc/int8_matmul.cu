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

#include "int8_gemm.cuh"
#include "rowquant.cuh"

using namespace cvt;

namespace {

template <int Epi>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  gemm_tile<Epi>(p, smem, (long long)blockIdx.y * kBM, blockIdx.x * kBN);
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
