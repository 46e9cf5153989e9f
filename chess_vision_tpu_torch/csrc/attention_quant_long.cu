// The int8 legs' long route (attention_quant_i8_long_kernel): K4/K5 under
// qk_int8 / pv_int8 at any key count, a head streamed through shared memory
// in 64-key tiles; attention_quant.cu's header gives the design, and
// attention_quant_i8.cuh the device code it shares with the short route.
// cvt_attention_quant_i8 (attention_quant.cu) launches it through
// launch_i8_long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_loop.cuh"
#include "attention_quant_i8.cuh"
#include "rowquant.cuh"

namespace cvt::quant {
namespace {

// Shared memory of the long route's block, by byte offset: the ring of
// kStages bf16 K and V tiles ([stage][K | V][64][Dh + 8], flash_walk's), the
// codes of the tile in hand (K's [64][Dh + 16] and their scales [64], qk_int8;
// V's [Dh][kVld] in P's A fragment order, pv_int8), then I8Layout's stage,
// V's column scales and inverses and column maxima (pv_int8), part and amax.
template <int Dh, bool kQk8, bool kPv8>
struct I8LongLayout {
  static constexpr int kLd8 = Dh + 16;
  static constexpr int kVld = cvt::kFlashKTile + 32;  // % 128 = 96, as I8Layout's vld
  static constexpr int k_codes = 2 * cvt::flash_q_offset<Dh, kStages>();
  static constexpr int k_scale = k_codes + (kQk8 ? cvt::kFlashKTile * kLd8 : 0);
  static constexpr int v_codes = k_scale + (kQk8 ? cvt::kFlashKTile * 4 : 0);
  static constexpr int stage = v_codes + (kPv8 ? Dh * kVld : 0);
  static constexpr int v_scale = stage + kRows * Dh;
  static constexpr int v_inv = v_scale + (kPv8 ? Dh * 4 : 0);
  static constexpr int colmax = v_inv + (kPv8 ? Dh * 4 : 0);
  static constexpr int part = colmax + (kPv8 ? kWarps * Dh * 4 : 0);
  static constexpr int amax = part + kRows * 4;
  static constexpr int bytes = amax + kRows * 4;
  static_assert(bytes * kI8MinBlocks + kI8MinBlocks * 1024 <= 233472,
                "the long route's blocks share an SM four at a time");
};

// The ring tile's 64 K rows (bf16, Dh + 8 apart; keys k0 ..) into codes and
// scales, code_k_rows's arithmetic a warp warp_rows(Dh) rows at a time; keys
// at or past n_keys (zeros in the tile) get zero codes and scales.
template <int Dh>
__device__ __forceinline__ void code_k_tile(const __nv_bfloat16* ks, int k0, int n_keys,
                                            int8_t* kc, float* kscale, int tid) {
  constexpr int kLanes = row_lanes(Dh);
  constexpr int kStep = kWarps * warp_rows(Dh);
  const int lane = tid % 32;
  const int col = (lane % kLanes) * 8;
  for (int r0 = tid / 32 * warp_rows(Dh); r0 < cvt::kFlashKTile; r0 += kStep) {
    const int r = r0 + lane / kLanes;  // below 64: warp_rows(Dh) divides it
    float v[8];
    cvt::load8(ks + r * (Dh + cvt::kFlashPad) + col, v);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    amax = fmaxf(amax, 1e-8f);
    const float inv = __fdiv_rn(127.f, amax);
    const bool valid = k0 + r < n_keys;
    uint2 w = make_uint2(0u, 0u);
    if (valid) {
      w.x = cvt::pack4(cvt::quant1_bits(v[0], inv), cvt::quant1_bits(v[1], inv),
                       cvt::quant1_bits(v[2], inv), cvt::quant1_bits(v[3], inv));
      w.y = cvt::pack4(cvt::quant1_bits(v[4], inv), cvt::quant1_bits(v[5], inv),
                       cvt::quant1_bits(v[6], inv), cvt::quant1_bits(v[7], inv));
    }
    *reinterpret_cast<uint2*>(kc + r * (Dh + 16) + col) = w;
    if (col == 0) kscale[r] = valid ? __fmul_rn(amax, cvt::kInv127) : 0.f;
  }
}

// The ring tile's 64 V rows into V's codes ([Dh][kVld], each 32-key group's
// keys in v_key_at's order), code_v_cols's arithmetic against the head's
// column inverses: a thread takes lane t's 8 keys of a group and 8 columns.
// Keys past n_keys are zeros in the tile, so their codes are zeros.
template <int Dh, int kVld>
__device__ __forceinline__ void code_v_tile(const __nv_bfloat16* vs, const float* v_inv,
                                            int8_t* vt, int tid) {
  constexpr int kGroups = cvt::kFlashKTile / 32;
  for (int item = tid; item < kGroups * 4 * (Dh / 8); item += kThreads) {
    const int t = item % 4;
    const int grp = item / 4 % kGroups;
    const int col = item / (4 * kGroups) * 8;
    float inv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) inv[e] = v_inv[col + e];
    uint32_t bits[8][8];  // [position][column]
#pragma unroll
    for (int pos = 0; pos < 8; ++pos) {
      const int key = 32 * grp + v_key_at(8 * t + pos);
      float v[8];
      cvt::load8(vs + key * (Dh + cvt::kFlashPad) + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) bits[pos][e] = cvt::quant1_bits(v[e], inv[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      *reinterpret_cast<uint2*>(vt + (col + e) * kVld + 32 * grp + 8 * t) =
          make_uint2(cvt::pack4(bits[0][e], bits[1][e], bits[2][e], bits[3][e]),
                     cvt::pack4(bits[4][e], bits[5][e], bits[6][e], bits[7][e]));
    }
  }
}

// The int8 legs' long route: attention_quant_i8_kernel's block, cluster, row
// chunks, walks and epilogue, with each walk over the head's 64-key tiles as
// they stream through the ring (cvt::flash_walk), coded as they land; the
// design is in the header.
template <int Dh, bool kQk8, bool kPv8>
__global__ void __launch_bounds__(kThreads, kI8MinBlocks)
attention_quant_i8_long_kernel(const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ oq,
                               float* __restrict__ os, int n, int n_keys, int heads, float scale) {
  static_assert(kQk8 || kPv8, "the int8 legs take one leg at least");
  using L = I8LongLayout<Dh, kQk8, kPv8>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int8_t* kc = reinterpret_cast<int8_t*>(smem_raw + L::k_codes);
  float* k_scale = reinterpret_cast<float*>(smem_raw + L::k_scale);
  int8_t* vt = reinterpret_cast<int8_t*>(smem_raw + L::v_codes);
  int8_t* stage = reinterpret_cast<int8_t*>(smem_raw + L::stage);
  float* v_scale = reinterpret_cast<float*>(smem_raw + L::v_scale);
  float* v_inv = reinterpret_cast<float*>(smem_raw + L::v_inv);
  float* part = reinterpret_cast<float*>(smem_raw + L::part);
  float* amax_s = reinterpret_cast<float*>(smem_raw + L::amax);
  const int d_model = heads * Dh;
  const long long row_stride = 3LL * d_model;
  const int h = blockIdx.y;  // = the block's rank in its cluster
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const __nv_bfloat16* q_base = qkv + (long long)b * n * row_stride + h * Dh;

  // V's column scales over all n rows, once for every row chunk
  if constexpr (kPv8) {
    v_col_scales<Dh>(q_base + 2 * d_model, row_stride, n,
                     reinterpret_cast<float*>(smem_raw + L::colmax), v_inv, v_scale, tid);
  }

  // A walk over the head's key tiles: body(k0, full, kb, vb) on each, with
  // the tile's K codes and scales (qk_int8) and V codes (pv_int8, kV) made
  // into kc, k_scale and vt first; kb, vb: the tile's bf16 K and V rows.
  auto walk = [&](auto with_v, auto&& body) {
    constexpr bool kV = decltype(with_v)::value;
    cvt::flash_walk<Dh, kWarps, kStages, kV>(
        q_base, row_stride, d_model, n_keys, ring, tid, 0, [] {},
        [&](const __nv_bfloat16* kb, const __nv_bfloat16* vb, int k0, bool full) {
          if constexpr (kQk8 || (kPv8 && kV)) {
            if constexpr (kQk8) code_k_tile<Dh>(kb, k0, n_keys, kc, k_scale, tid);
            if constexpr (kPv8 && kV) code_v_tile<Dh, L::kVld>(vb, v_inv, vt, tid);
            __syncthreads();  // the tile's codes are made
          }
          body(k0, full, kb, vb);
        });
  };

  const int chunks = cvt::flash_chunks(n, kWarps);
  const int cb = cvt::flash_chunk_blocks(n, chunks);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int row0 = chunk * cb * 16;
    const int cblocks = min(cb, (n + 15) / 16 - chunk * cb);
    const bool has[2] = {warp < cblocks, warp + kWarps < cblocks};
    uint32_t qa8[2][i8_steps<Dh>()][4];
    uint32_t qa[2][Dh / 16][4];
    float qf[2][2];
    if constexpr (kQk8) {
      q_codes<Dh>(q_base, row_stride, row0, n, has, scale, qa8, qf, warp, lane);
    } else {
      q_frags<Dh>(q_base, row_stride, row0, n, has, qa, warp, lane);
    }
    // S of the tile at k0, from its codes or its bf16 rows kb
    auto scores = [&](int k0, const __nv_bfloat16* kb, auto nb, auto whole) {
      constexpr int NB = decltype(nb)::value;
      constexpr bool kFull = decltype(whole)::value;
      return [&, k0, kb](float (&s)[NB][2][4], int hs) {
        if constexpr (kQk8) {
          sub_scores_i8<Dh, NB, kFull>(s, kc, k_scale, hs, k0, n_keys, qa8, qf, lane);
        } else {
          cvt::flash_sub_scores<Dh, cvt::kScoreScaled, NB, kFull>(s, kb, hs, k0, n_keys, scale,
                                                                  qa, lane);
        }
      };
    };

    // walk 1: S and the exact row max
    float m[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) m[j][0] = m[j][1] = -INFINITY;
    walk(std::false_type{}, [&](int k0, bool full, const __nv_bfloat16* kb, const __nv_bfloat16*) {
      cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
        cvt::flash_max_step_with<decltype(nb)::value, decltype(whole)::value>(
            k0, n_keys, scores(k0, kb, nb, whole), m);
      });
    });
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[j][i] = fmaxf(m[j][i], __shfl_xor_sync(0xffffffffu, m[j][i], 1));
        m[j][i] = fmaxf(m[j][i], __shfl_xor_sync(0xffffffffu, m[j][i], 2));
      }

    float o[2][Dh / 8][4];
    float l[2][2];
    if constexpr (!kPv8) {
      // the walk: p = bf16(exp(s - m)) in P V (bf16 products) and the row sum
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j][0] = l[j][1] = 0.f;
#pragma unroll
        for (int nb = 0; nb < Dh / 8; ++nb) o[j][nb][0] = o[j][nb][1] = o[j][nb][2] = o[j][nb][3] = 0.f;
      }
      walk(std::true_type{}, [&](int k0, bool full, const __nv_bfloat16* kb, const __nv_bfloat16* vb) {
        cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
          cvt::flash_fixed_step_with<Dh, decltype(nb)::value, decltype(whole)::value>(
              vb, k0, n_keys, scores(k0, kb, nb, whole), m, l, o, lane,
              [](float x, float mx) { return expf(__fsub_rn(x, mx)); });
        });
      });
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 1));
          l[j][i] = __fadd_rn(l[j][i], __shfl_xor_sync(0xffffffffu, l[j][i], 2));
        }
    } else {
      // walk 2: the f32 row sums of exp(s - m) over the valid keys, each
      // thread's keys in order (8 m + 2 t, + 1 for m = 0, 1, ..., tile after tile)
      float lsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      walk(std::false_type{}, [&](int k0, bool full, const __nv_bfloat16* kb, const __nv_bfloat16*) {
        cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
          constexpr int NB = decltype(nb)::value;
          constexpr bool kFull = decltype(whole)::value;
          const int nsub = kFull ? 4 : min(4, (n_keys - k0 + 15) / 16);
          auto sc = scores(k0, kb, nb, whole);
#pragma unroll
          for (int hs = 0; hs < 4; ++hs) {
            if (!kFull && hs >= nsub) continue;
            float s[NB][2][4];
            sc(s, hs);
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  lsum[j][e / 2] = __fadd_rn(lsum[j][e / 2], expf(__fsub_rn(s[j][hh][e], m[j][e / 2])));
                }
          }
        });
      });
      // P's row amax is fl(1 / rowsum): the row max's p is exp(0) = 1
      float lrcp[2][2], pinv[2][2], ps[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lsum[j][i] = __fadd_rn(lsum[j][i], __shfl_xor_sync(0xffffffffu, lsum[j][i], 1));
          lsum[j][i] = __fadd_rn(lsum[j][i], __shfl_xor_sync(0xffffffffu, lsum[j][i], 2));
          lrcp[j][i] = div_rn_recip(lsum[j][i]);
          const float amax = fmaxf(__fdiv_rn(1.f, lsum[j][i]), 1e-8f);
          pinv[j][i] = __fdiv_rn(127.f, amax);
          ps[j][i] = __fmul_rn(amax, cvt::kInv127);
        }
      // walk 3: P's codes and their int8 product with the tile's V codes
      int o32[2][Dh / 8][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nb = 0; nb < Dh / 8; ++nb) o32[j][nb][0] = o32[j][nb][1] = o32[j][nb][2] = o32[j][nb][3] = 0;
      walk(std::true_type{}, [&](int k0, bool full, const __nv_bfloat16* kb, const __nv_bfloat16*) {
        cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
          // pv_i8_step reads V's codes at k0 + the key: the tile's start is k0
          pv_i8_step<Dh, decltype(nb)::value, decltype(whole)::value>(
              k0, n_keys, scores(k0, kb, nb, whole), m, lsum, lrcp, pinv, vt - k0, L::kVld, o32,
              lane);
        });
      });
      // o = fl(fl(f32(o32) * ps) * vs), l = 1
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[j][i] = 1.f;
#pragma unroll
          for (int nb = 0; nb < Dh / 8; ++nb)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              o[j][nb][2 * i + c] = __fmul_rn(__fmul_rn(__int2float_rn(o32[j][nb][2 * i + c]), ps[j][i]),
                                              v_scale[nb * 8 + t * 2 + c]);
            }
        }
    }
    quant_epilogue<Dh>(o, l, has, part, amax_s, stage, oq, os, b, n, row0, cblocks, h, heads);
    __syncthreads();  // every warp has stored its codes from the stage
  }
}

template <int Dh, bool kQk8, bool kPv8>
cudaError_t launch(const __nv_bfloat16* qkv, int8_t* oq, float* os, int batch, int n,
                   int n_keys, int heads, float scale, cudaStream_t stream) {
  auto kernel = attention_quant_i8_long_kernel<Dh, kQk8, kPv8>;
  const int smem = I8LongLayout<Dh, kQk8, kPv8>::bytes;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cvt::flash_cluster_config(kernel, dim3(1, heads, batch), kThreads, smem,
                                              stream, config, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, qkv, oq, os, n, n_keys, heads, scale);
}

template <int Dh>
cudaError_t launch_legs(int legs, const __nv_bfloat16* qkv, int8_t* oq, float* os, int batch,
                        int n, int n_keys, int heads, float scale, cudaStream_t stream) {
  switch (legs) {
    case 1: return launch<Dh, true, false>(qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    case 2: return launch<Dh, false, true>(qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    case 3: return launch<Dh, true, true>(qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int Dh>
int smem_legs(int legs) {
  return legs == 1   ? I8LongLayout<Dh, true, false>::bytes
         : legs == 2 ? I8LongLayout<Dh, false, true>::bytes
         : legs == 3 ? I8LongLayout<Dh, true, true>::bytes
                     : -1;
}

}  // namespace

cudaError_t launch_i8_long(int head_dim, int legs, const __nv_bfloat16* qkv, int8_t* oq,
                           float* os, int batch, int n, int n_keys, int heads, float scale,
                           cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_legs<16>(legs, qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    case 32: return launch_legs<32>(legs, qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    case 64: return launch_legs<64>(legs, qkv, oq, os, batch, n, n_keys, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

int i8_long_smem(int head_dim, int legs) {
  switch (head_dim) {
    case 16: return smem_legs<16>(legs);
    case 32: return smem_legs<32>(legs);
    case 64: return smem_legs<64>(legs);
    default: return -1;
  }
}

}  // namespace cvt::quant
