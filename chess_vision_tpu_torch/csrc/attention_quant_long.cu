// The int8 legs' long route (attention_quant_i8_long_kernel): K4/K5 under
// qk_int8 / pv_int8 at any key count. attention_quant.cu's header gives the
// arithmetic and the design; attention_quant_i8.cuh holds the device code
// the two routes share. cvt_attention_quant_i8 (attention_quant.cu) launches
// it through launch_i8_long.
//
// A block per (head, image), the heads of an image a cluster (K4's epilogue
// takes each token's amax over all heads). The block first codes its head
// once, with the short route's functions, into its slice of a device
// scratch: K's codes [kp][Dh] and scales [kp] (qk_int8), V's codes [Dh][kp],
// each column's keys in P's A fragment order (pv_int8), kp the keys rounded
// up to a 64-key tile, zeros past the last key. Then it takes the image's rows
// kLongWarps * 32 at a time (a pass), and each walk of a pass streams the
// head's tiles through a kLongStages-deep cp.async ring: 64 rows of K's
// codes and their scales, 64 keys of each V column's codes, or a bf16 leg's
// 64 rows from qkv. The walks code nothing and wait on no coding barrier; a
// tile is read once a walk of a pass, in int8 where its leg is int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_loop.cuh"
#include "attention_quant_i8.cuh"
#include "rowquant.cuh"

namespace cvt::quant {
namespace {

constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kLongMinBlocks = 12 / kLongWarps;  // 12 warps an SM at 168 registers
constexpr int kTile = cvt::kFlashKTile;

// Shared memory of the long route's block, by byte offset: the ring of
// kLongStages tiles, each K's part (qk_int8: codes [64][Dh + 16] and scales
// [64] f32; else bf16 rows [64][Dh + 8]) then V's (pv_int8: codes [Dh][kVld]
// in P's A fragment order; else bf16 rows [64][Dh + 8]); then the staging of
// a pass's output codes [32 W][Dh], V's column scales, inverses and maxima
// (pv_int8), the epilogue's part and amax.
template <int Dh, bool kQk8, bool kPv8>
struct I8LongLayout {
  static constexpr int kLd8 = Dh + 16;
  static constexpr int kVld = kTile + 32;  // % 128 = 96, as I8Layout's vld
  static constexpr int kRowsBf16 = kTile * (Dh + cvt::kFlashPad) * 2;
  static constexpr int tile_k = kQk8 ? kTile * kLd8 + kTile * 4 : kRowsBf16;
  static constexpr int tile_v = kPv8 ? Dh * kVld : kRowsBf16;
  static constexpr int tile = tile_k + tile_v;
  static constexpr int rows = 32 * kLongWarps;
  static constexpr int stage = kLongStages * tile;
  static constexpr int v_scale = stage + rows * Dh;
  static constexpr int v_inv = v_scale + (kPv8 ? Dh * 4 : 0);
  static constexpr int colmax = v_inv + (kPv8 ? Dh * 4 : 0);
  static constexpr int part = colmax + (kPv8 ? kLongWarps * Dh * 4 : 0);
  static constexpr int amax = part + rows * 4;
  static constexpr int bytes = amax + rows * 4;
  static_assert(tile % 16 == 0 && stage % 16 == 0, "16-byte copies");
  static_assert(bytes * kLongMinBlocks + kLongMinBlocks * 1024 <= 233472,
                "the long route's blocks share an SM kLongMinBlocks at a time");
};

// The scratch of one (image, head), by byte offset, for kp keys: K's codes
// [kp][Dh] and scales [kp] (qk_int8), then V's codes [Dh][kp] (pv_int8).
__host__ __device__ constexpr long long long_scratch_bytes(int dh, int kp, bool qk, bool pv) {
  return (qk ? (long long)kp * (dh + 4) : 0) + (pv ? (long long)dh * kp : 0);
}

__host__ __device__ constexpr int long_keys(int n_keys) { return (n_keys + kTile - 1) / kTile * kTile; }

// A bf16 tile's 64 rows k0 .. of K or V (src: the head's first row of it in
// qkv) into dst ([64][Dh + 8]), zeros past n_keys.
template <int Dh>
__device__ __forceinline__ void copy_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int k0, int n_keys, int tid) {
  constexpr int kChunks = Dh / 8;
  for (int idx = tid; idx < kTile * kChunks; idx += kLongThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks * 8;
    const bool ok = k0 + r < n_keys;
    cvt::flash_cp16(dst + r * (Dh + cvt::kFlashPad) + c,
                    src + (long long)(ok ? k0 + r : 0) * row_stride + c, ok);
  }
}

// The tile of keys k0 .. k0 + 63 into ring stage st: K's codes and scales
// from the scratch (qk_int8) or its bf16 rows, and with kV V's codes from the
// scratch (pv_int8) or its bf16 rows. The caller commits.
template <int Dh, bool kQk8, bool kPv8, bool kV>
__device__ __forceinline__ void copy_tile(uint8_t* st, const int8_t* kc, const float* ks,
                                          const int8_t* vc, int kp, const __nv_bfloat16* q_base,
                                          long long row_stride, int d_model, int k0, int n_keys,
                                          int tid) {
  using L = I8LongLayout<Dh, kQk8, kPv8>;
  if constexpr (kQk8) {
    constexpr int kPieces = Dh / 16;  // 16-byte pieces of a row's codes
    for (int idx = tid; idx < kTile * kPieces + kTile / 4; idx += kLongThreads) {
      if (idx < kTile * kPieces) {
        const int r = idx / kPieces;
        const int c = idx % kPieces * 16;
        cvt::flash_cp16(st + r * L::kLd8 + c, kc + (long long)(k0 + r) * Dh + c, true);
      } else {
        const int j = 4 * (idx - kTile * kPieces);
        cvt::flash_cp16(st + kTile * L::kLd8 + 4 * j, ks + k0 + j, true);
      }
    }
  } else {
    copy_rows_bf16<Dh>(reinterpret_cast<__nv_bfloat16*>(st), q_base + d_model, row_stride, k0,
                       n_keys, tid);
  }
  if constexpr (kV) {
    uint8_t* vs = st + L::tile_k;
    if constexpr (kPv8) {
      for (int idx = tid; idx < Dh * (kTile / 16); idx += kLongThreads) {
        const int c = idx / (kTile / 16);
        const int p = idx % (kTile / 16) * 16;
        cvt::flash_cp16(vs + c * L::kVld + p, vc + (long long)c * kp + k0 + p, true);
      }
    } else {
      copy_rows_bf16<Dh>(reinterpret_cast<__nv_bfloat16*>(vs), q_base + 2 * d_model, row_stride,
                         k0, n_keys, tid);
    }
  }
}

// The int8 legs' long route: the head coded once into the scratch, then
// the image's rows a pass at a time, each pass's walks over the tiles as
// they stream through the ring; the design is in the opening comment.
template <int Dh, bool kQk8, bool kPv8>
__global__ void __launch_bounds__(kLongThreads, kLongMinBlocks)
attention_quant_i8_long_kernel(const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ oq,
                               float* __restrict__ os, uint8_t* __restrict__ scratch, int n,
                               int n_keys, int heads, float scale) {
  static_assert(kQk8 || kPv8, "the int8 legs take one leg at least");
  constexpr int W = kLongWarps;
  using L = I8LongLayout<Dh, kQk8, kPv8>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
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
  const int kp = long_keys(n_keys);
  int8_t* kc = reinterpret_cast<int8_t*>(scratch) +
               ((long long)b * heads + h) * long_scratch_bytes(Dh, kp, kQk8, kPv8);
  float* ks = reinterpret_cast<float*>(kc + (long long)kp * Dh);
  int8_t* vc = kc + long_scratch_bytes(Dh, kp, kQk8, false);

  // 1. the head's codes, once: K's, V's column scales over all n rows, V's
  if constexpr (kQk8) {
    for (int rep = 0; rep < i8_reps(7); ++rep) {
      code_k_rows<Dh, W, Dh>(q_base + d_model, row_stride, n_keys, kp, kc, ks, tid);
    }
  }
  if constexpr (kPv8) {
    for (int rep = 0; rep < i8_reps(6); ++rep) {
      v_col_scales<Dh, W>(q_base + 2 * d_model, row_stride, n,
                          reinterpret_cast<float*>(smem_raw + L::colmax), v_inv, v_scale, tid);
    }
    for (int rep = 0; rep < i8_reps(8); ++rep) {
      code_v_cols<Dh, W>(q_base + 2 * d_model, row_stride, n_keys, kp, kp, v_inv, vc, tid);
    }
  }
  __syncthreads();  // the block's codes are in the scratch, for every thread to copy

  // A walk over the head's tiles: body(st, k0, full) on each as it lands
  // (st: its ring stage), V's part too with kV.
  const int ntiles = kp / kTile;
  auto walk = [&](auto with_v, auto&& body) {
    constexpr bool kV = decltype(with_v)::value;
    __syncthreads();  // every thread is done with the ring's tiles of the walk before
#pragma unroll
    for (int s = 0; s < kLongStages - 1; ++s) {
      if (s < ntiles) {
        copy_tile<Dh, kQk8, kPv8, kV>(smem_raw + s * L::tile, kc, ks, vc, kp, q_base, row_stride,
                                      d_model, s * kTile, n_keys, tid);
      }
      cvt::flash_commit();
    }
    for (int tile = 0; tile < ntiles; ++tile) {
      cvt::flash_wait<kLongStages - 2>();
      __syncthreads();  // tile `tile` has landed; every warp is done with tile - 1
      const int next = tile + kLongStages - 1;
      if (next < ntiles && CVT_I8_PROBE != 9) {
        copy_tile<Dh, kQk8, kPv8, kV>(smem_raw + next % kLongStages * L::tile, kc, ks, vc, kp,
                                      q_base, row_stride, d_model, next * kTile, n_keys, tid);
      }
      cvt::flash_commit();
      const int k0 = tile * kTile;
      body(smem_raw + tile % kLongStages * L::tile, k0, k0 + kTile <= n_keys);
    }
    cvt::flash_wait<0>();
  };

  const int chunks = cvt::flash_chunks(n, W);
  const int cb = cvt::flash_chunk_blocks(n, chunks);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int row0 = chunk * cb * 16;
    const int cblocks = min(cb, (n + 15) / 16 - chunk * cb);
    const bool has[2] = {warp < cblocks, warp + W < cblocks};
    uint32_t qa8[2][i8_steps<Dh>()][4];
    uint32_t qa[2][Dh / 16][4];
    float qf[2][2];
    if constexpr (kQk8) {
      q_codes<Dh, W>(q_base, row_stride, row0, n, has, scale, qa8, qf, warp, lane);
    } else {
      q_frags<Dh, W>(q_base, row_stride, row0, n, has, qa, warp, lane);
    }
    // S of the tile at k0 in ring stage st, from K's codes or its bf16 rows
    auto scores = [&](const uint8_t* st, int k0, auto nb, auto whole) {
      constexpr int NB = decltype(nb)::value;
      constexpr bool kFull = decltype(whole)::value;
      return [&, st, k0](float (&s)[NB][2][4], int hs) {
        if constexpr (kQk8) {
          sub_scores_i8<Dh, NB, kFull>(s, reinterpret_cast<const int8_t*>(st),
                                       reinterpret_cast<const float*>(st + kTile * L::kLd8), hs,
                                       k0, n_keys, qa8, qf, lane);
        } else {
          cvt::flash_sub_scores<Dh, cvt::kScoreScaled, NB, kFull>(
              s, reinterpret_cast<const __nv_bfloat16*>(st), hs, k0, n_keys, scale, qa, lane);
        }
      };
    };

    // walk 1: S and the exact row max
    float m[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) m[j][0] = m[j][1] = -INFINITY;
    for (int rep = 0; rep < i8_reps(2); ++rep) {
      walk(std::false_type{}, [&](const uint8_t* st, int k0, bool full) {
        cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
          cvt::flash_max_step_with<decltype(nb)::value, decltype(whole)::value>(
              k0, n_keys, scores(st, k0, nb, whole), m);
        });
      });
    }
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
      for (int rep = 0; rep < i8_reps(4); ++rep) {
        walk(std::true_type{}, [&](const uint8_t* st, int k0, bool full) {
          cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
            cvt::flash_fixed_step_with<Dh, decltype(nb)::value, decltype(whole)::value>(
                reinterpret_cast<const __nv_bfloat16*>(st + L::tile_k), k0, n_keys,
                scores(st, k0, nb, whole), m, l, o, lane,
                [](float x, float mx) { return expf(__fsub_rn(x, mx)); });
          });
        });
      }
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
      for (int rep = 0; rep < i8_reps(3); ++rep) {
        walk(std::false_type{}, [&](const uint8_t* st, int k0, bool full) {
          cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
            constexpr int NB = decltype(nb)::value;
            constexpr bool kFull = decltype(whole)::value;
            const int nsub = kFull ? 4 : min(4, (n_keys - k0 + 15) / 16);
            auto sc = scores(st, k0, nb, whole);
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
      }
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
      for (int rep = 0; rep < i8_reps(4); ++rep) {
        walk(std::true_type{}, [&](const uint8_t* st, int k0, bool full) {
          cvt::flash_for_rows(has, full, [&](auto nb, auto whole) {
            // pv_i8_step reads V's codes at k0 + the key: the tile's start is k0
            pv_i8_step<Dh, decltype(nb)::value, decltype(whole)::value>(
                k0, n_keys, scores(st, k0, nb, whole), m, lsum, lrcp, pinv,
                reinterpret_cast<const int8_t*>(st + L::tile_k) - k0, L::kVld, o32, lane);
          });
        });
      }
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
    for (int rep = 0; rep < i8_reps(5); ++rep) {
      quant_epilogue<Dh, W>(o, l, has, part, amax_s, stage, oq, os, b, n, row0, cblocks, h, heads);
      __syncthreads();  // every warp has stored its codes from the stage
    }
  }
}

template <int Dh, bool kQk8, bool kPv8>
cudaError_t launch(const __nv_bfloat16* qkv, int8_t* oq, float* os, uint8_t* scratch, int batch,
                   int n, int n_keys, int heads, float scale, cudaStream_t stream) {
  auto kernel = attention_quant_i8_long_kernel<Dh, kQk8, kPv8>;
  const int smem = I8LongLayout<Dh, kQk8, kPv8>::bytes;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cvt::flash_cluster_config(kernel, dim3(1, heads, batch), kLongThreads, smem,
                                              stream, config, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, qkv, oq, os, scratch, n, n_keys, heads, scale);
}

template <int Dh>
cudaError_t launch_legs(int legs, const __nv_bfloat16* qkv, int8_t* oq, float* os,
                        uint8_t* scratch, int batch, int n, int n_keys, int heads, float scale,
                        cudaStream_t stream) {
  switch (legs) {
    case 1: return launch<Dh, true, false>(qkv, oq, os, scratch, batch, n, n_keys, heads, scale, stream);
    case 2: return launch<Dh, false, true>(qkv, oq, os, scratch, batch, n, n_keys, heads, scale, stream);
    case 3: return launch<Dh, true, true>(qkv, oq, os, scratch, batch, n, n_keys, heads, scale, stream);
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
                           float* os, void* scratch, int batch, int n, int n_keys, int heads,
                           float scale, cudaStream_t stream) {
  auto s = static_cast<uint8_t*>(scratch);
  if (s == nullptr) return cudaErrorInvalidValue;
  switch (head_dim) {
#if !CVT_I8_PROBE
    case 16: return launch_legs<16>(legs, qkv, oq, os, s, batch, n, n_keys, heads, scale, stream);
    case 32: return launch_legs<32>(legs, qkv, oq, os, s, batch, n, n_keys, heads, scale, stream);
#endif
    case 64: return launch_legs<64>(legs, qkv, oq, os, s, batch, n, n_keys, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

int i8_long_smem(int head_dim, int legs) {
  switch (head_dim) {
#if !CVT_I8_PROBE
    case 16: return smem_legs<16>(legs);
    case 32: return smem_legs<32>(legs);
#endif
    case 64: return smem_legs<64>(legs);
    default: return -1;
  }
}

long long i8_long_scratch(int n_keys, int head_dim, int legs) {
  if (legs < 1 || legs > 3) return -1;
  return long_scratch_bytes(head_dim, long_keys(n_keys), legs & 1, legs & 2);
}

}  // namespace cvt::quant
