// Fused pre-op + per-row dynamic int8 quantization.
//
// Replaces the TPU kernels chess_vision_tpu/ops/quant.py fused_rowquant
// (_rowquant_kernel): K7 on (B, N, D) and K6 on flat (M, D) rows. Both are
// the same row-local math, so one kernel over rows = B*N or M covers them.
// The device code, its numerics and its bound are in rowquant.cuh.

#include "rowquant.cuh"

// x: (rows, d) bf16 (x_f32 = 0) or f32 (x_f32 = 1), contiguous, 16-byte
// aligned. mode: cvt::RowMode. ln_g, ln_b: f32 (d,) for mode kRowLn, else
// ignored. q: int8 (rows, d); s: f32 (rows,). Returns the launch's
// cudaError_t.
extern "C" int cvt_rowquant(const void* x, int x_f32, long long rows, int d,
                            int mode, const void* ln_g, const void* ln_b,
                            float eps, void* q, void* s, void* stream) {
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return (int)cvt::launch_rowquant(static_cast<const float*>(x), rows, d,
                                     mode, g, b, eps, qo, so, st);
  }
  return (int)cvt::launch_rowquant(static_cast<const __nv_bfloat16*>(x), rows,
                                   d, mode, g, b, eps, qo, so, st);
}
