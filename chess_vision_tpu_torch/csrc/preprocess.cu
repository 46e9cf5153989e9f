// uint8 NHWC images -> mean/std-normalized bf16 (or f32), one pass.
//
// Replaces the TPU kernel chess_vision_tpu/ops/preprocess.py
// _preprocess_pallas (_kernel): out = x * scale[c] + bias[c] with
// scale = 1 / (255 * std_c) and bias = -mean_c / std_c, computed in f32.
// The multiply and the add are rounded each (__fmul_rn, __fadd_rn), as the
// plain version's separate ops are: a fused multiply-add rounds once and put
// a bf16 output one ulp off the plain one, which is enough to move a square
// whose top-2 logit margin is ~1e-3 on a trained model.
//
// Bound on this card: device memory. Each element is read once (1 byte) and
// written once (2 bytes in bf16); there is no reuse, so the best it can do is
// stream both at full bandwidth. Design: every thread owns 16 consecutive
// elements, loads them with one 16-byte load and writes them with 16-byte
// stores (two in bf16, four in f32). The channel of element i is i % C, so no
// (W*C) tiling constraint of the TPU version survives. The ragged tail and
// pointers that are not 16-byte aligned take a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kPerThread = 16;
constexpr int kThreads = 256;

struct NormVec {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

template <typename T>
__device__ __forceinline__ T from_float(float v);

__device__ __forceinline__ float normalize(float x, float scale, float bias) {
  return __fadd_rn(__fmul_rn(x, scale), bias);
}

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ x, T* __restrict__ out,
                  long long n, int channels, bool aligned, NormVec nv) {
  // Indexing the parameter struct with a run-time channel would spill it to
  // local memory; a shared copy is indexed for free.
  __shared__ float scale[kMaxChannels], bias[kMaxChannels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      scale[c] = nv.scale[c];
      bias[c] = nv.bias[c];
    }
  }
  __syncthreads();
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kPerThread;
  if (i0 >= n) return;
  int c = (int)(i0 % channels);
  if (aligned && i0 + kPerThread <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    __align__(16) T vals[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      vals[j] = from_float<T>(normalize((float)bytes[j], scale[c], bias[c]));
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + i0);
    const uint4* src = reinterpret_cast<const uint4*>(vals);
#pragma unroll
    for (int k = 0; k < kPerThread * (int)sizeof(T) / 16; ++k) dst[k] = src[k];
    return;
  }
  for (long long i = i0; i < n && i < i0 + kPerThread; ++i) {
    out[i] = from_float<T>(normalize((float)x[i], scale[c], bias[c]));
    c = (c + 1 == channels) ? 0 : c + 1;
  }
}

}  // namespace

// x: n uint8 elements of a contiguous NHWC tensor with `channels` channels.
// out: n elements, bf16 when out_bf16 != 0, else f32. scale, bias: host
// arrays of `channels` floats. Returns the launch's cudaError_t.
extern "C" int cvt_preprocess_u8(const void* x, void* out, long long n,
                                 int channels, const float* scale,
                                 const float* bias, int out_bf16,
                                 void* stream) {
  if (channels < 1 || channels > kMaxChannels || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  NormVec nv;
  for (int c = 0; c < kMaxChannels; ++c) {
    nv.scale[c] = c < channels ? scale[c] : 0.f;
    nv.bias[c] = c < channels ? bias[c] : 0.f;
  }
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long threads_needed = (n + kPerThread - 1) / kPerThread;
  const unsigned blocks = (unsigned)((threads_needed + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    preprocess_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<__nv_bfloat16*>(out), n,
        channels, aligned, nv);
  } else {
    preprocess_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(out), n, channels,
        aligned, nv);
  }
  return (int)cudaGetLastError();
}
