// Multi-head attention forward and backward at any head dim, bf16 and f32,
// read straight from the packed qkv projection: the form of K2 and K3 for the
// head dims and addresses that their instantiated kernels (attention.cu,
// attention_bwd.cu, attention_bwd_cluster.cu, attention_f32.cu: a head dim
// that is a multiple of 8 up to 128, qkv at a 16-byte aligned address) do
// not take: a head dim that is not a multiple of 8 (ViT-B/16's width on 64
// heads of 12), one above 128 (3 heads of 256), or a qkv view that starts
// off a 16-byte boundary. This file holds the forward (K2) and the entries;
// the backward (K3) is attention_any_bwd.cu, the device code both share
// attention_any.cuh.
//
// Replaces the TPU kernels chess_vision_tpu/ops/attention.py
// _kernel_attention (_attn_kernel) and _kernel_attention_bwd
// (_attn_bwd_kernel), which block qkv by whole heads and fix no head dim. For
// every (image, head), Q, K and V are the column ranges [h*Dh, (h+1)*Dh) +
// {0, D, 2D} of qkv (B, N, 3*D), D = H*Dh; the output lands in out (B, N, D)
// and the gradient in dqkv (B, N, 3*D) at the same columns.
//
// Arithmetic (the JAX kernels' rounding points): S = Q K^T summed in f32 (bf16
// on the tensor cores, f32 in FFMA in full f32: no TF32). Forward: the online
// row max, rescaled once per ring stage of fwd_keys keys; bf16 p =
// exp2f(fmaf(s, scale log2 e, -m scale log2 e)) rounded to bf16, the row sum
// adding the rounded p as the JAX kernel's ones column of V does; f32 p =
// expf(fl(s scale) - m); P V summed in f32, divided by the row sum floored at
// 1e-30, one rounding of the output. Backward: the row statistics (max, sum,
// sum dP p) recomputed in the kernel, pn = p / l, r = sum dP pn, dS = pn (dP
// - r) scale rounded to the input dtype, pn rounded as dV's operand; dQ = dS
// K, dK = dS^T Q, dV = pn^T g summed in f32, each output rounded once.
//
// Design (one CTA, or one cluster, over all of a head's output columns up
// to a head dim of 256):
//  - The head dim is padded with zeros in shared memory to a multiple of 16
//    (the score products' depth) and the output columns to any_cols(Dh):
//    16, 32, 64, 128 or 256, a template argument, so that the accumulators
//    stay in registers. Above 256 (384, 768, 1,024) the output columns go in
//    chunks of 256, a CTA (or cluster) each, and every chunk computes S (and
//    in the backward dP) over the whole head dim again: the score products
//    cost any_chunks(Dh) times (2 at 384, 3 at 768, 4 at 1,024). At or below
//    256 no score or dP product is computed for another column chunk.
//  - Above a head dim of 256 the tiles hold the depth a window of 256
//    columns at a time (any_window; the kernels' kDeep form), so no head dim
//    is refused and the forward and the backward take the same ones: the
//    forward copies Q's and a stage's K columns window by window and sums S
//    over them in order, one stage at a time with no copy under the
//    products; the backward copies a query tile's Q and g and its CTA's K
//    and V window by window, sums each unit's S^T and dP^T over them into
//    shared memory, which both of its passes read, then copies the chunk's
//    window again for dV, dK and dQ. Every chunk sums the windows in the
//    same order, so every chunk's S has the same bits.
//  - Whole Q/K/V/g tiles come into shared memory by cp.async, each call at
//    the widest width its addresses allow (copy_bytes: 16 bytes at 3 heads of
//    256, 8 at 64 heads of 12, 2-byte element copies only for an odd head dim
//    in bf16), zero past the head dim and past the last token. No barrier per
//    column slice.
//  - Query rows go in 16-row blocks, a warp each; keys in 16-key sub-steps,
//    those wholly past the last key skipped: 257 tokens cost 272 x 272
//    scores, not 320 x 320.
//  - Forward (any_fwd_kernel): a CTA of 4 warps (64 query rows) walks the
//    head's keys through a two-stage cp.async ring of K (the whole depth)
//    and V (the chunk's columns), tiles copied without a division an element; each
//    stage's S is computed once (the next depth step's fragments read under
//    this one's products), its row max taken,
//    o rescaled, p formed and P V added (bf16: p re-packed in registers as
//    the A fragment, V by ldmatrix.trans; f32: p through the warp's tile in
//    shared memory). At 256 columns a warp holds 16 rows x 256 columns of o
//    (128 f32 a thread), FlashAttention-2's head-dim-256 form, with 32-key
//    stages (two CTAs an SM in bf16).
//  - Backward (any_bwd_kernel, attention_any_bwd.cu): attention_bwd_cluster.cu's
//    plan on every head dim. A thread-block cluster of up to 16 CTAs per
//    (image, head, chunk); the head's 16-key steps shared out evenly, each
//    CTA keeping its keys' K and V in shared memory and their dK / dV sums in
//    registers for the whole launch (a warp 16 keys by up to 128 columns:
//    at 256 two warps share a key block); the cluster walks the query rows in
//    tiles (bwd_rows: 128 rows at 16 columns, 64 up to 64, else 32; f32 64
//    and 16), more rows where a tile's barriers would outweigh its products.
//    A tile: S^T and dP^T of each 16 x 16 unit in one walk over the depth
//    (four chains of products, the next fragments read under this step's),
//    for the row statistics, which cross the cluster through distributed
//    shared memory (a lane a CTA, a fixed xor tree); S^T and dP^T again,
//    the same units with the same operands (the same bits), for pn^T and
//    dS^T into shared memory; dV += pn^T g and dK += dS^T Q; the CTA's
//    partial dQ = dS K, each row's slice stored into the shared memory of the
//    CTA that owns the row, added there in rank order after a cluster
//    barrier. 7 products
//    (S and dP twice), one launch per call up to the keys 16 CTAs hold
//    (1,024 tokens at every head dim, 64 or 128 keys a CTA), no
//    scratch, no atomics: every backward gives the same bits twice. Past
//    that a head's keys split over several clusters: a statistics launch and
//    the main one through f32 scratches (the clusters' statistics and dQ
//    partials) and a summing launch, as the long routes do.
// ptxas's registers and spills and the readings on the card are in PERF.md
// section 6 (chip_smoke.py phase 26 prints them).

#include "attention_any.cuh"

namespace cvt_any {
namespace {

// kDeep: a depth above 256, which the tiles hold a window at a time (DP is
// 256 then). Each ring stage copies Q's and the stage's K columns of each
// window in turn, S summed over them in order, then the stage's V: one
// stage, no copy under the products.
template <typename T, int DP, bool kWhole, bool kDeep>
__global__ void __launch_bounds__(32 * kFwdWarps, sizeof(T) == 2 && DP <= 64 ? 4 : 2)
any_fwd_kernel(const Call a) {
  constexpr int KS = fwd_keys(sizeof(T), DP);  // keys a stage
  constexpr int NB = KS / 8;
  constexpr int P = row_pad(sizeof(T));
  constexpr int LP = KS + 4;  // f32: a row of a warp's P tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int b = blockIdx.z;
  const int h = blockIdx.y / a.chunks;
  const int c0 = blockIdx.y % a.chunks * DP;
  const int cols = min(DP, a.dh - c0);  // the chunk's columns
  const int d_model = a.heads * a.dh;
  const long long rs = 3LL * d_model;
  const int depth = a.depth;
  constexpr int kStages = kDeep ? 1 : 2;
  const int ldq = any_window(depth) + P;      // Q and K rows
  const int ldv = min(DP, depth) + P;         // V rows: the chunk's columns
  const int vw = min(DP, depth - c0);         // V columns copied
  T* qs = smem;
  T* kr = qs + 16 * warps * ldq;
  T* vr = kr + kStages * KS * ldq;
  float* ps = reinterpret_cast<float*>(vr + kStages * KS * ldv) + warp * 16 * LP;
  const T* base = static_cast<const T*>(a.qkv) + (long long)b * a.n * rs + (long long)h * a.dh;
  const int row0 = blockIdx.x * 16 * warps;
  const int nst = (a.n + KS - 1) / KS;

  if constexpr (!kDeep) {  // the CTA's Q rows and the first stage, one group
    copy_tile<kWhole>(qs, ldq, base, rs, row0, 16 * warps, a.n, depth, a.dh, a.wbytes);
    copy_tile<kWhole>(kr, ldq, base + d_model, rs, 0, KS, a.n, depth, a.dh, a.wbytes);
    copy_tile<kWhole>(vr, ldv, base + 2 * d_model + c0, rs, 0, KS, a.n, vw, a.dh - c0, a.wbytes);
    cvt::flash_commit();
  }

  const Softmax<T> sm{a.scale, a.scale_log2};
  const bool has = row0 + 16 * warp < a.n;
  float o[DP / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int st = 0; st < nst; ++st) {
    const int live = min(KS, a.n - st * KS);  // the stage's keys below n
    float s[NB][4];
    zero(s);
    if constexpr (kDeep) {
      for (int w0 = 0; w0 < depth; w0 += kMaxCols) {
        const int ww = min(kMaxCols, depth - w0);
        __syncthreads();  // every warp is done with the last window (and stage)
        if ((st == 0 && w0 == 0) || !probe(kNoCopies)) {
          copy_tile<kWhole>(qs, ldq, base + w0, rs, row0, 16 * warps, a.n, ww, a.dh - w0,
                            a.wbytes);
          copy_tile<kWhole>(kr, ldq, base + d_model + w0, rs, st * KS, KS, a.n, ww, a.dh - w0,
                            a.wbytes);
          if (w0 == 0) {
            copy_tile<kWhole>(vr, ldv, base + 2 * d_model + c0, rs, st * KS, KS, a.n, vw,
                              a.dh - c0, a.wbytes);
          }
        }
        cvt::flash_commit();
        cvt::flash_wait<0>();
        __syncthreads();
        if (has && !probe(kNoScores)) {
          dot<NB>(s, qs + 16 * warp * ldq, ldq, kr, ldq, ww, live, lane);
        }
      }
    }
    if (!kDeep) {
      cvt::flash_wait<0>();
      __syncthreads();  // stage st has landed; every warp is done with stage st - 1
      if (st + 1 < nst && !probe(kNoCopies)) {
        const int k1 = (st + 1) * KS;
        T* kn = kr + (st + 1) % 2 * KS * ldq;
        T* vn = vr + (st + 1) % 2 * KS * ldv;
        copy_tile<kWhole>(kn, ldq, base + d_model, rs, k1, KS, a.n, depth, a.dh, a.wbytes);
        copy_tile<kWhole>(vn, ldv, base + 2 * d_model + c0, rs, k1, KS, a.n, vw, a.dh - c0,
                          a.wbytes);
      }
      cvt::flash_commit();
    }
    if (!has) continue;
    const T* vs = vr + st % kStages * KS * ldv;
    if (!kDeep && !probe(kNoScores)) {
      dot<NB>(s, qs + 16 * warp * ldq, ldq, kr + st % 2 * KS * ldq, ldq, depth, live, lane);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = 8 * j + 2 * t + (e & 1) < live ? sm.score(s[j][e]) : -INFINITY;
        s[j][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float sh[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = sm.factor(m[i], mx[i]);  // 0 on the first stage: m = -inf
      l[i] *= alpha;
      // once the maxima settle o stays: wide rows skip the multiplies
      if (DP < 64 || __any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int nb = 0; nb < DP / 8; ++nb) {
          o[nb][2 * i] *= alpha;
          o[nb][2 * i + 1] *= alpha;
        }
      }
      m[i] = mx[i];
      sh[i] = sm.shift(mx[i]);
    }
    if constexpr (std::is_same<T, bf16>::value) {
      // p rounded to bf16, re-packed as P's A fragment, 16 keys at a time
#pragma unroll
      for (int hs = 0; hs < KS / 16; ++hs) {
        if (16 * hs >= live) continue;  // p = 0 exactly: nothing to add
        uint32_t pa[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = operand<T>(sm.p(s[2 * hs + x][e], sh[e / 2]));
          l[0] += p[0] + p[1];
          l[1] += p[2] + p[3];
          pa[2 * x] = cvt::flash_pack(p[0], p[1]);
          pa[2 * x + 1] = cvt::flash_pack(p[2], p[3]);
        }
        // V's fragments by ldmatrix.trans, the next 16 columns' read while
        // this one's products run
        const bf16* vrow = reinterpret_cast<const bf16*>(vs) +
                           (16 * hs + lane % 8 + ((lane / 8) % 2) * 8) * ldv + (lane / 16) * 8;
        uint32_t bv0[4], bv1[4];
        cvt::flash_ldsm_x4_trans(bv0, vrow);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          if (16 * dp >= cols || probe(kNoValues)) break;
          uint32_t(&cur)[4] = dp % 2 ? bv1 : bv0;
          uint32_t(&next)[4] = dp % 2 ? bv0 : bv1;
          if (dp + 1 < DP / 16 && 16 * (dp + 1) < cols) {
            cvt::flash_ldsm_x4_trans(next, vrow + 16 * (dp + 1));
          }
          cvt::mma_bf16_16816(o[2 * dp], pa, cur[0], cur[1]);
          cvt::mma_bf16_16816(o[2 * dp + 1], pa, cur[2], cur[3]);
        }
      }
    } else {
      // p through the warp's tile: rows g and g + 8, the stage's keys
      float* prow = ps + (lane / 4) * LP + 2 * t;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = sm.p(s[j][e], sh[e / 2]);
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        store_pair(prow + 8 * j, p[0], p[1]);
        store_pair(prow + 8 * LP + 8 * j, p[2], p[3]);
      }
      __syncwarp();
      if (!probe(kNoValues)) {
        outer_rm<DP / 8>(o, reinterpret_cast<const float*>(ps), LP,
                         reinterpret_cast<const float*>(vs), ldv, (live + 3) / 4 * 4, cols, lane);
      }
      __syncwarp();  // the tile is read before the next stage writes it
    }
  }
  cvt::flash_wait<0>();
  if (!has) return;
  T* out = static_cast<T*>(a.out) + ((long long)b * a.n) * d_model + (long long)h * a.dh + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= a.n) continue;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nb + 2 * t + e;
        if (col < cols) {
          out[(long long)row * d_model + col] = narrow<T>(__fdiv_rn(o[nb][2 * i + e], den));
        }
      }
    }
  }
}

template <typename T, int DP, bool kWhole, bool kDeep>
cudaError_t launch_fwd_as(const Call& a, int batch, cudaStream_t stream) {
  const int bytes = fwd_smem_bytes(sizeof(T), DP, a.depth);  // within kSmemLimit: every_plan_fits
  const auto kernel = any_fwd_kernel<T, DP, kWhole, kDeep>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 16 * kFwdWarps - 1) / (16 * kFwdWarps), a.heads * a.chunks, batch);
  kernel<<<grid, 32 * kFwdWarps, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP, bool kDeep = false>
cudaError_t launch_fwd(const Call& a, int batch, cudaStream_t stream) {
  return whole_copies(a.wbytes, a.dh) ? launch_fwd_as<T, DP, true, kDeep>(a, batch, stream)
                                      : launch_fwd_as<T, DP, false, kDeep>(a, batch, stream);
}

template <typename T>
cudaError_t dispatch_fwd(const Call& a, int batch, cudaStream_t s) {
  switch (any_cols(a.dh)) {
    case 16: return launch_fwd<T, 16>(a, batch, s);
    case 32: return launch_fwd<T, 32>(a, batch, s);
    case 64: return launch_fwd<T, 64>(a, batch, s);
    case 128: return launch_fwd<T, 128>(a, batch, s);
    default:
      return a.depth > kMaxCols ? launch_fwd<T, 256, true>(a, batch, s)
                                : launch_fwd<T, 256>(a, batch, s);
  }
}

}  // namespace
}  // namespace cvt_any

// qkv: (batch, n, 3 * heads * head_dim), bf16 (f32 = 0) or f32 (f32 = 1),
// contiguous; any head_dim >= 1, any alignment of the dtype. out: the same
// dtype, (batch, n, heads * head_dim). scale: the softmax temperature
// (1 / sqrt(head_dim)). Returns the launch's cudaError_t.
extern "C" int cvt_attention_fwd_any(const void* qkv, void* out, int batch, int n, int heads,
                                     int head_dim, int f32, float scale, void* stream) {
  using namespace cvt_any;
  if (batch < 1 || n < 1 || heads < 1 || head_dim < 1 || batch > 65535 ||
      (long long)heads * any_chunks(head_dim) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int es = f32 ? 4 : 2;
  Call a{};
  a.qkv = qkv;
  a.out = out;
  a.n = n;
  a.heads = heads;
  a.dh = head_dim;
  a.depth = any_depth(head_dim);
  a.chunks = any_chunks(head_dim);
  a.wbytes = copy_bytes(qkv, nullptr, head_dim, es);
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? dispatch_fwd<float>(a, batch, s) : dispatch_fwd<bf16>(a, batch, s));
}
