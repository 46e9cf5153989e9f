#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chess_vision_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0] [--boards 300] [--bench-boards 1024]
                          [--profile-train N]

Phases, one line each; any failure exits non-zero before the last line:
  1. device  card name, ``nvidia-smi`` name and power limit; TF32 off.
  2. build   nvcc builds ``chess_vision_tpu_torch/csrc/*.cu`` for sm_90a, one
             process per source, all started together; its seconds are
             printed, and the script's total seconds before the report.
  3. K1      preprocess kernel vs its plain version, (256,256,256,3) u8 -> bf16,
             at most 1 bf16 ulp apart.
  4. K2      attention kernel vs ``reference_attention`` at (256,257,2304) bf16
             with 12 heads, at (3,17,96) with 1 head, and at N = 17, 64, 65,
             264, 577 and 1025 with head dims 16, 32 and 64 (the 16-row and
             64-key edges, and sequences longer than any shared-memory
             tile), atol 2e-2; the scores it computes, ptxas's registers and
             spills and its shared memory per block printed.
  5. path    ViT-B/16 at 256 px, full width (embed 768, depth 12, 12 heads),
             bf16, weights drawn from --seed in the JAX layout and carried
             through the weight bridge; ``Predictor.predict_array`` on --boards
             random boards (a padded tail batch) must launch K1 once and K2 12
             times per batch, and agree with the same Predictor running the
             plain ops on the card; boards/s of both at batch 256.
  6. K6/K7   row-quant kernel vs ``rowquant_plain`` at (65792, 768) ln and
             (65792, 3072) gelu_sigmoid, bf16 in: int8 codes within one
             level in under 1e-3 of the elements, scales rtol 1e-5; exact
             ties k + 0.5 round half to even.
  7. K8-K13  int8 GEMM kernel (wgmma main loop), every epilogue, vs its plain
             version at (65792, 768) -> 2304 / 768 / 3072 and (65792, 3072) ->
             768: codes and scales as in 6, bf16 outputs within one bf16 ulp;
             each GEMM's share of the int8 peak beside ``torch._int_mm``'s
             time; K8's time with each GELU beside the bias epilogue's on
             the same operands; K9's and K10's routes (``mm.res_route``: K9's
             thread-block cluster and how many the card holds at once, K10's
             grid, ptxas's registers and spills of both kernels); every
             epilogue at ragged shapes (M not a multiple of the tile's 64
             rows, O = 8k not of its 256 columns, K = 16k not of the stage's
             128 bytes, and O = 2304, where K9 takes the two-launch route)
             with the three GELUs; the epilogue's four-at-a-time GELU against
             the scalar GELU of the other kernels, bit for bit on 2^28 values
             per GELU.
  8. K4      quantizing attention vs ``reference_attention_quant`` at
             (256, 257, 2304) with the exact row max and with a fixed shift,
             at (3, 17, 384) and at the ragged (2, 65, 2304) with 12 heads
             both ways: dequantized outputs within ATTN_ATOL; ptxas's
             registers and spills, its shared memory per block and how many
             clusters of 12 blocks (one per head) the card holds printed.
  9. int8    the same ViT-B/16 through ``Predictor(quant="int8")``, its
             softmax shifts calibrated on 8 boards; ``predict_array`` on
             --boards boards must launch, per batch, the row quant once, the
             quantizing attention 12 times, the GEMM 12 (qkv), 23 (proj,
             fc2), 12 (fc1) and 1 (last fc2) times, the preprocess once, and
             agree with the same Predictor on the plain versions on the
             card; then every kernel call of one batch must meet the
             criteria of 6-8 against its plain version on the same inputs,
             the path's own activations; int8-vs-bf16 FEN agreement
             printed; boards/s of int8 kernel, int8 plain and bf16 kernel
             paths at batch 256. ``--profile-int8 N`` also prints a
             ``torch.profiler`` table of N boards through this Predictor
             (and, after phase 15, through the flat and fused ones) and
             requires one row-pass kernel a batch (the first LayerNorm's:
             K9 folds its own into its one launch).
 10. K3      attention backward kernel vs ``reference_attention_bwd`` at
             (256,257,2304) and (64,257,2304) with 12 heads and (3,17,96) with
             1 head, bf16: dq, dk and dv each within K3_ATOL, a planted fault
             (dK from the unscaled dS) outside it, two launches bit-identical;
             the same at N = 17, 64, 65, 257, 264 with head dims 16, 32, 64,
             and past 288 tokens, where the long route
             (``attention_bwd_long.cu``) takes the call, at N = 289 and 577
             with those head dims and at (64, 577, 2304), whose time goes in
             the kernels line;
             the products it executes and ptxas's registers and its shared
             memory per block printed;
             ``scaled_dot_product_attention`` forward and backward timed on
             the same values as the library yardstick of K2 and K3.
 11. train   the same ViT-B/16 through the trainer's ``train`` function
             (``python -m chess_vision_tpu_torch.train`` calls it): the
             ``configs/vit.yaml`` values, batch 64, an in-memory corpus of 320
             random boards with labels from random FENs, 2 epochs of 4 steps,
             each followed by the eval epoch on the held-out 64; every train
             step must launch K2 12 times and K3 12 times (24 and 12 with
             remat), every eval step K2 12 times and K3 never; finite losses,
             the last epoch's mean train loss below the first's; one step
             with dropout and drop path off and fixed augmentation draws
             through the kernels and through the plain versions on the card:
             loss and per-tensor gradients within TRAIN_GRAD_RTOL; train
             img/s of both, peak device memory with and without remat; the
             checkpoint written and read back. ``--profile-train N`` also
             prints a ``torch.profiler`` table of N warm train steps.
 12. K5      flat quantizing attention vs ``reference_attention_quant_flat``
             at (73728, 2304) (256 images of 288 rows, 257 real) with the
             exact row max and with a fixed shift, and at a small ragged
             shape: real rows within ATTN_ATOL; real rows equal K4's on the
             unpadded values bit for bit; padded keys filled with large
             values change no real row. Then K11-K13, the flat layout's
             GEMMs, at its own 73,728 rows, checked and timed as in 7, with
             K9's route printed again.
 13. K14     the whole-block kernel on block 0 of phase 9's pack at
             (256, 257, 768) and on a small shape: bit-identical to the chain
             of split kernels it replaces and to a second launch; against
             ``fused_vit_block_plain`` within BLOCK_BOUNDS, a planted fault
             (the residual not rounded before the LN) outside them; its time
             beside the split chain's, taken in turns; its stages' times by
             the card's clock (``fused_block.STAGES``).
 14. flat    the ViT-B/16 of phase 9 through ``Predictor(quant="int8")``
             under CHESS_VISION_INT8_LAYOUT=flat: per batch the row quant
             once, the GEMM 12 + 23 + 12 + 1 times, K5 12 times, K4 never;
             logits and FENs against the same Predictor on the plain versions
             as in 9; every kernel call of one batch against its plain
             version; FEN agreement with the block layout.
 15. fused   the same under CHESS_VISION_INT8_LAYOUT=fused: per batch the row
             quant once, K14 11 times, and for the last block the GEMM
             1 + 1 + 1 + 1 times and K4 once; checked as 14; boards/s of the
             block, flat and fused layouts at batch 256, in turns.
 16. K15     the attention-variant sweep (``experiments.attn_variants.sweep``)
             at batch 256, which must launch each of the 8 variants 17 times
             and the row-quant kernel never (the kernel quantizes in its one
             launch; one call of each variant under ``torch.profiler`` must
             run one kernel and no row pass); each variant vs
             ``variant_plain`` at (256, 257, 2304) on randn values within its
             stated tolerance, ``bb=2`` bit-identical to ``bb=1``; its time
             beside the earlier design's reading (``K15_EARLIER_MS``) and
             ptxas's registers and spills printed.
 17. report  the kernels JSON line (every kernel with its bound and, where
             one PyTorch call computes the same function, that call's time;
             every kernel but K3's long route, which no 257-token path
             takes, must have been launched by a main path),
             the nvidia-smi line, then {"ok": true, "device": {...}}.

Bounds: ``bound_ms`` is the larger of the bytes a call must move (inputs
read once, outputs written once) over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s
f32), the H100 SXM's published rates at its full 700 W.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from contextlib import ExitStack, contextmanager, nullcontext
from unittest import mock

import numpy as np

# logits of the kernel path vs the plain path on the card: bf16 rounds at
# other points in the two attentions (the kernel's probabilities are unrounded
# f32 in its row sums), and the differences pass through 12 bf16 blocks; about
# ten bf16 ulps at the random model's logit scale (~0.5)
SQUARES_ATOL = 5e-2
ATTN_ATOL = 2e-2  # the JAX package's bound for its own kernel
# logits of the int8 kernel path vs its plain path on the card: an int8 code
# may land one level apart where a value sits on a rounding boundary (sums
# in another order; ~1e-6 of the elements measured in phases 6-8), which
# moves that output by one quantization step of its row, and 48 requants
# through 12 blocks spread it. On the random model (H100) this reads
# 0.052-0.062 for seeds 0-4, and so does any other one-rounding change of a
# kernel (0.050-0.059 planted), so this bound only fails gross faults (a
# wrong softmax scale read 0.119, a dropped residual 2.56). The per-op check
# of phase 9 (path_op_checks) is the one that fails rounding-level faults.
INT8_SQUARES_ATOL = 1e-1
# K3 vs its plain version, per output element: both round dS and pn to bf16
# and each output once from f32 sums taken in another order, so values near a
# rounding boundary land one bf16 ulp apart: 3.9e-3 read at |values| up to 2.8
# (ulp 7.8e-3 in [1, 2), 1.6e-2 in [2, 4)). The planted fault, dK made from
# the unscaled dS, reads 4.5 to 19.8. The JAX package holds its own kernel to
# 5e-2 against an f32 reference.
K3_ATOL = 1.6e-2
# gradients of one train step, kernel path vs plain path on the card, per
# parameter tensor: max |difference| over max |plain gradient|. bf16 rounds at
# other points in the two attentions (K2's unrounded row sums, K3's f32
# rounding order), and the differences pass back through up to 12 bf16 blocks.
# Read on the H100 at seed 0: worst tensor 0.018 (the CLS token), median
# 0.004, losses 2.8e-4 apart.
TRAIN_GRAD_RTOL = 4e-2
TRAIN_LOSS_ATOL = 5e-3
# K14 (and the split chain, which gives the same bits) vs
# ``fused_vit_block_plain`` over a whole block: each of the block's four
# row quants may put a code one level apart where a value sits on a rounding
# boundary (~1e-6 to 1e-4 of the elements, phases 6-8), and such a code moves
# its whole row a little through the products and LayerNorms that follow. So
# the block's outputs are held to shares, not to one level everywhere: x more
# than one bf16 ulp off, and codes that differ, each in under BLOCK_SHARE of
# the elements; codes at most BLOCK_LEVELS apart; scales within
# BLOCK_SCALE_RTOL. Read on the H100 over the 11 blocks of the served model:
# shares up to 0.0032 and 0.0016, 3 levels, scales 0.009. The planted fault
# (LN2 reading the unrounded residual) reads shares of 0.16-0.53 and
# 0.09-0.30 and falls outside; its levels and scales do not tell it apart.
BLOCK_SHARE = 2e-2
BLOCK_LEVELS = 4
BLOCK_SCALE_RTOL = 2e-2
# K15 vs ``variant_plain``, dequantized, per variant: 2e-2 as K4; bf16s rounds
# scores, differences and exponentials to bf16, so a last-bit difference in a
# sum becomes a bf16 step of p
VARIANT_ATOL = {"bf16s": 4e-2}
# K15's times a call at (256, 257, 2304) in the earlier design (a 4-warp tile
# per 64 rows, an f32 scratch and a row-pass launch), ms on the H100 80GB
# HBM3 at 700 W: printed beside this run's for the reader, never compared
K15_EARLIER_MS = {"base": 1.3138, "foldscale": 1.2960, "noshift": 0.8690,
                  "noexp": 1.2769, "fexp": 1.3298, "fexp_ns": 1.0049,
                  "bf16s": 1.3566, "normbound": 1.2766}
# kernels of the kernels line that no main path launches
OFF_PATH = ("fused_qkv_attention_bwd_long",)
BATCH = 256
SIZE = 256
TRAIN_BATCH = 64
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_entry(name: str, source: str, replaces: str, err: float, ms: float,
                 plain_ms: float, nbytes: float, ops, op_type: str | None = None,
                 library_ms: float | None = None) -> dict:
    """One entry of the kernels line; the bound from this run's shapes.
    ``ops`` is a count of ``op_type`` operations, or {type: count} for a
    kernel that works in more than one type (their times add)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    counts = ops if isinstance(ops, dict) else {op_type: ops}
    by_ops = sum(n / PEAK_OPS[t] for t, n in counts.items()) * 1e3
    return {"name": name, "route": "cuda",
            "source": "chess_vision_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def bf16_ulps(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return ((a - b).abs() / ulp).max().item()


def random_jax_params(cfg: dict, seed: int) -> dict:
    """ChessViT params in the JAX package's tree layout: trunc-normal(0.02)
    kernels and pos_embed (chess_vision_tpu/models/layers.py), zero biases and
    cls_token, unit LayerNorm scales."""
    m = cfg["model"]
    D, depth, size = m["embed_dim"], m["depth"], m["input_size"]
    hidden = int(D * m["mlp_ratio"])
    rng = np.random.default_rng(seed)

    def tn(*shape):
        # truncated at 2 sigma, rescaled to std 0.02 as flax's initializer
        z = np.clip(rng.standard_normal(shape, dtype=np.float32), -2.0, 2.0)
        return z * np.float32(0.02 / 0.87962566)

    def dense(i, o):
        return {"kernel": tn(i, o), "bias": np.zeros(o, np.float32)}

    def norm():
        return {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}

    backbone = {
        "patch_embed": {"kernel": tn(16, 16, 3, D), "bias": np.zeros(D, np.float32)},
        "cls_token": np.zeros((1, 1, D), np.float32),
        "pos_embed": tn(1, (size // 16) ** 2 + 1, D),
        "norm": norm(),
    }
    for i in range(depth):
        backbone[f"block{i}"] = {
            "norm1": norm(), "norm2": norm(),
            "attn": {"qkv": dense(D, 3 * D), "proj": dense(D, D)},
            "mlp": {"fc1": dense(D, hidden), "fc2": dense(hidden, D)},
        }
    return {"backbone": backbone, "type_head": dense(D, 7),
            "color_head": dense(D, 3), "turn_head": dense(D, 1),
            "castling_head": dense(D, 4)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--boards", type=int, default=300)
    parser.add_argument("--bench-boards", type=int, default=4 * BATCH)
    parser.add_argument("--profile-train", type=int, default=0,
                        help="also profile this many warm train steps")
    parser.add_argument("--profile-int8", type=int, default=0,
                        help="also profile this many boards through each "
                             "int8 layout")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA device", file=sys.stderr)
        return 2
    from chess_vision_tpu_torch import fen_to_labels
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    started = time.perf_counter()

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH}",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip(), file=sys.stderr)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data_cfg = get_data_config("vit_base_patch16_224.augreg_in21k")
    mean, std = data_cfg["mean"], data_cfg["std"]
    kernels = {}

    # 3. K1
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                       device=dev, generator=gen)
    out_k = pre_ops.preprocess_u8(u8, mean, std, torch.bfloat16)
    out_p = pre_ops.preprocess_u8_plain(u8, mean, std, torch.bfloat16)
    torch.cuda.synchronize()
    ulps = bf16_ulps(out_k, out_p)
    err = (out_k.float() - out_p.float()).abs().max().item()
    ms = cuda_ms(lambda: pre_ops.preprocess_u8(u8, mean, std), 50)
    plain_ms = cuda_ms(lambda: pre_ops.preprocess_u8_plain(u8, mean, std), 50)
    print(f"[3 K1] preprocess {tuple(u8.shape)} u8->bf16: max |diff| {err} "
          f"({ulps} bf16 ulp); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    require(ulps <= 1.0, f"K1 is {ulps} bf16 ulp from its plain version")
    kernels["preprocess_u8"] = kernel_entry(
        "preprocess_u8", "preprocess.cu",
        "chess_vision_tpu/ops/preprocess.py:43", err, ms, plain_ms,
        nbytes=3 * u8.numel(), ops=2 * u8.numel(), op_type="f32")

    # 4. K2: the path's shape, then the ragged edges and long sequences
    N = SIZE // 16 * SIZE // 16 + 1
    odd = [(2, n, 2, Dh) for n in (17, 64, 65, 264, 577, 1025)
           for Dh in (16, 32, 64)]
    for B, n, H, Dh in ((BATCH, N, 12, 64), (3, 17, 1, 32), *odd):
        qkv = torch.randn((B, n, 3 * H * Dh), device=dev,
                          generator=gen).to(torch.bfloat16)
        out_k = attn_ops.fused_qkv_attention(qkv, H)
        out_p = attn_ops.reference_attention(qkv, H)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        finite = bool(torch.isfinite(out_k).all())
        require(finite and err <= ATTN_ATOL,
                f"K2 at {tuple(qkv.shape)}: max |diff| {err}, finite {finite}")
        if B != BATCH:
            print(f"  [4 K2] attention {tuple(qkv.shape)} H={H}: max |diff| "
                  f"{err}", flush=True)
            continue
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention(qkv, H), 20)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, H), 5)
        kernels["fused_qkv_attention"] = kernel_entry(
            "fused_qkv_attention", "attention.cu",
            "chess_vision_tpu/ops/attention.py:90", err, ms, plain_ms,
            nbytes=2 * qkv.numel() * 4 // 3, ops=4 * B * H * n * n * Dh,
            op_type="bf16")
        print(f"[4 K2] attention {tuple(qkv.shape)} H={H}: max |diff| {err}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{kernels['fused_qkv_attention']['bound_ms']:.4f} ms; "
              f"{flash_work('attention_fwd_kernel', n, Dh)}", flush=True)
        del qkv, out_k, out_p
    del u8

    # 5. full path
    cfg = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                     "input_size": SIZE, "embed_dim": 768, "depth": 12,
                     "num_heads": 12, "mlp_ratio": 4.0},
           "training": {"mixed_precision": True}}
    depth = cfg["model"]["depth"]
    t0 = time.perf_counter()
    predictor = Predictor((cfg, random_jax_params(cfg, args.seed)),
                          batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(args.seed)
    boards = rng.integers(0, 256, (args.boards, SIZE, SIZE, 3), dtype=np.uint8)
    predictor.predict_array(boards[:BATCH])  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    pre_ops.LAUNCHES = 0
    attn_ops.LAUNCHES = 0
    fens = predictor.predict_array(boards)
    launches = {"preprocess_u8": pre_ops.LAUNCHES,
                "fused_qkv_attention": attn_ops.LAUNCHES}
    batches = math.ceil(args.boards / BATCH)
    print(f"[5 path] ViT-B/16 {SIZE}px bf16 full width, {args.boards} boards "
          f"in {batches} batches of {BATCH}: launches {launches} "
          f"(set-up {setup_s:.1f} s)", flush=True)
    require(launches == {"preprocess_u8": batches,
                         "fused_qkv_attention": depth * batches},
            f"launch counts {launches} for {batches} batches")
    for name, count in launches.items():
        kernels[name]["launches"] = count

    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
    require(pre_ops.LAUNCHES == batches and attn_ops.LAUNCHES == depth * batches,
            "the plain-ops run launched a kernel")

    logits_k = forward_logits(predictor, boards, mean, std)
    with plain_ops(attn_ops, pre_ops):
        logits_p = forward_logits(predictor, boards, mean, std)
    sq_k, sq_p = logits_k["squares"], logits_p["squares"]
    require(sq_k.shape == (args.boards, 64 * 13) and np.isfinite(sq_k).all(),
            f"kernel-path logits: shape {sq_k.shape}, finite {np.isfinite(sq_k).all()}")
    sq_err = float(np.abs(sq_k - sq_p).max())
    require(len(fens) == len(fens_plain) == args.boards, "FEN count")
    ids_k = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    ids_p = sq_p.reshape(-1, 64, 13).argmax(-1)
    top2 = np.sort(sq_p.reshape(-1, 64, 13), axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 2 * SQUARES_ATOL
    square_mismatch = int((ids_k != ids_p)[confident].sum())
    turn_k = np.array([f.split()[1] == "b" for f in fens])
    turn_conf = np.abs(logits_p["turn"][:, 0]) > 2 * SQUARES_ATOL
    turn_mismatch = int((turn_k != (logits_p["turn"][:, 0] > 0))[turn_conf].sum())
    same_fens = sum(a == b for a, b in zip(fens, fens_plain))
    print(f"[5 path] squares logits kernel vs plain: max |diff| {sq_err} "
          f"(atol {SQUARES_ATOL}); {int(confident.sum())} of {confident.size} "
          f"squares have top-2 margin > {2 * SQUARES_ATOL}, {square_mismatch} "
          f"differ; turn mismatches on confident boards {turn_mismatch}; "
          f"{same_fens}/{args.boards} FEN strings identical", flush=True)
    require(sq_err <= SQUARES_ATOL, f"squares logits differ by {sq_err}")
    require(square_mismatch == 0 and turn_mismatch == 0,
            "FENs differ on confident squares or turns")

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        with plain_ops(attn_ops, pre_ops) if which == "plain" else nullcontext():
            t0 = time.perf_counter()
            predictor.predict_array(bench)
            rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"[5 path] predict_array boards/s at batch {BATCH} "
          f"({len(bench)} boards per run; kernel, plain, plain, kernel): "
          f"kernel {rates['kernel']}, plain {rates['plain']}; {kind}, {smi}",
          flush=True)

    int8_kernel_phases(dev, kernels)
    int8 = int8_path_phase(args, cfg, boards, fens, predictor, kernels, kind,
                           smi)
    del predictor
    torch.cuda.empty_cache()
    attention_bwd_phase(args, dev, kernels)
    train_path_phase(args, kernels, kind, smi)
    layout_kernel_phases(args, dev, int8, kernels)
    flat = layout_path_phase(14, "flat", args, cfg, boards, int8, kernels)
    fused = layout_path_phase(15, "fused", args, cfg, boards, int8, kernels)
    layout_bench(args, boards, {"block": int8["predictor"], "flat": flat,
                                "fused": fused}, kind, smi)
    del int8, flat, fused
    torch.cuda.empty_cache()
    variant_sweep_phase(args, dev, kernels)

    # 17. report
    # the long route of K3 takes more than 288 tokens: no main path (257
    # tokens) runs it, so its entry keeps launches 0; phase 10 checks it
    idle = [k["name"] for k in kernels.values()
            if k["launches"] < 1 and k["name"] not in OFF_PATH]
    require(not idle, f"kernels that no path launched: {idle}")
    print(f"[17 report] {time.perf_counter() - started:.1f} s in all, the build "
          f"included", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def codes_check(what: str, q, s, rq, rs) -> float:
    """int8 codes within one level in under 1e-3 of the elements, scales
    rtol 1e-5; returns the max |difference| of the dequantized values."""
    import torch

    diff = (q.int() - rq.int()).abs()
    flips = (diff > 0).float().mean().item()
    scale_rel = ((s - rs).abs() / rs.abs()).max().item()
    deq = (q.float() * s - rq.float() * rs).abs().max().item()
    print(f"  {what}: max level diff {diff.max().item()}, {flips:.2e} of "
          f"codes differ, scale rel diff {scale_rel:.2e}, dequantized "
          f"max |diff| {deq}", flush=True)
    require(diff.max().item() <= 1 and flips < 1e-3,
            f"{what}: codes differ by {diff.max().item()} in {flips}")
    require(scale_rel <= 1e-5 and bool(torch.isfinite(s).all()),
            f"{what}: scales differ by {scale_rel}")
    return deq


def bf16_check(what: str, out, ref) -> float:
    """bf16 outputs within one bf16 ulp; returns the max |difference|."""
    ulps = bf16_ulps(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  {what}: max |diff| {err} ({ulps} bf16 ulp)", flush=True)
    require(ulps <= 1.0, f"{what}: {ulps} bf16 ulp from the plain version")
    return err


def int8_kernel_phases(dev, kernels: dict) -> None:
    """Phases 6-8: each int8 kernel at the main path's shapes vs its plain
    version on the same inputs, timed with CUDA events."""
    import torch

    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    gen = torch.Generator(device=dev).manual_seed(1)
    M = BATCH * (SIZE // 16 * SIZE // 16 + 1)

    # 6. row quant (K7 in the path; K6 is the same rows flat)
    for D, mode in ((768, "ln"), (3072, "gelu_sigmoid")):
        x = (torch.randn((M, D), device=dev, generator=gen) * 2).bfloat16()
        g = torch.rand(D, device=dev, generator=gen) + 0.5
        b = torch.randn(D, device=dev, generator=gen) * 0.1
        q, s = rq.fused_rowquant(x, mode, g, b)
        rq_, rs = rq.rowquant_plain(x, mode, g, b)
        torch.cuda.synchronize()
        err = codes_check(f"[6 K6/K7] row quant ({M}, {D}) {mode}", q, s, rq_, rs)
        ms = cuda_ms(lambda: rq.fused_rowquant(x, mode, g, b), 20)
        plain_ms = cuda_ms(lambda: rq.rowquant_plain(x, mode, g, b), 5)
        entry = kernel_entry(
            "fused_rowquant", "rowquant.cu",
            "chess_vision_tpu/ops/quant.py:159", err, ms, plain_ms,
            nbytes=3 * M * D + 4 * M + 8 * D, ops=8 * M * D, op_type="f32")
        print(f"[6 K6/K7] row quant ({M}, {D}) {mode}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']})", flush=True)
        if mode == "ln":
            kernels["fused_rowquant"] = entry
        del x, q, s, rq_, rs

    # exact ties: with the row's abs-max at 127 each code is its value, so
    # k + 0.5 must round half to even (as jnp.round), not away from zero
    halves = torch.arange(-126, 127, device=dev, dtype=torch.float32) + 0.5
    x = torch.cat([halves.new_tensor([127.0]), halves, halves.new_zeros(2)])
    q, s = rq.fused_rowquant(x[None], "none")
    torch.cuda.synchronize()
    wrong = int((q[0].float() != torch.round(x)).sum())
    print(f"  [6 K6/K7] row quant of {halves.numel()} exact ties: {wrong} codes "
          f"not rounded half to even", flush=True)
    require(wrong == 0 and abs(s.item() - 1.0) <= 1e-6,
            f"row quant ties: {wrong} wrong, scale {s.item()}")

    # 7. int8 GEMM epilogues (K8-K10 in the path; K11-K13 the same rows)
    def operands(K, O):
        return operands_at(dev, gen, M, K, O)

    cases = (("scale_bias", 768, 2304, "chess_vision_tpu/ops/quant.py:251"),
             ("res_ln_quant", 768, 768, "chess_vision_tpu/ops/int8_matmul.py:254"),
             ("gelu_quant", 768, 3072, "chess_vision_tpu/ops/int8_matmul.py:219"),
             ("res_ln_quant", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:254"),
             ("res", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:297"))
    print(f"  [7 GEMM] {res_route_line(768)}", flush=True)
    for epi, K, O, replaces in cases:
        ops = operands(K, O)
        what = f"[7 GEMM] {epi} ({M}, {K}) -> {O}"
        # proj and fc2 share the res_ln_quant kernel: the entry keeps fc2's
        kernels[f"int8_matmul_{epi}"] = gemm_case(what, dev, gen, ops, epi,
                                                  replaces)
        if epi == "gelu_quant":
            # what K8's epilogue costs: its two sweeps by GELU, beside the
            # same product with the bias epilogue (one sweep)
            by_gelu = {gelu: cuda_ms(
                lambda: mm.int8_matmul_gelu_quant(*ops, gelu), 20)
                for gelu in mm.GELUS}
            bias_ms = cuda_ms(lambda: mm.int8_matmul_scale_bias(*ops), 20)
            print(f"  {what}: ms by GELU "
                  f"{ {k: round(v, 4) for k, v in by_gelu.items()} }; the bias "
                  f"epilogue on the same operands {bias_ms:.4f} ms", flush=True)
        del ops

    # the main loop's ragged edges: rows, columns and depth that end inside
    # a tile, a stage or a 16-row group, with every epilogue and GELU
    # (300, 128, 2304): K9 and K10 on the two-launch route (9 column tiles)
    for M_, K, O in ((300, 80, 72), (129, 16, 8), (1000, 768, 264),
                     (64, 128, 256), (4999, 3072, 776), (300, 128, 2304)):
        ops = operands_at(dev, gen, M_, K, O)
        res = torch.randn((M_, O), device=dev, generator=gen).bfloat16()
        g = torch.rand(O, device=dev, generator=gen) + 0.5
        b = torch.randn(O, device=dev, generator=gen) * 0.1
        what = f"  [7 GEMM] ragged ({M_}, {K}) -> {O}"
        print(f"{what}: {res_route_line(O, ptxas=False)}", flush=True)
        bf16_check(what + " scale_bias", mm.int8_matmul_scale_bias(*ops),
                   mm.int8_matmul_scale_bias_plain(*ops))
        bf16_check(what + " res", mm.int8_matmul_res(*ops, res),
                   mm.int8_matmul_res_plain(*ops, res))
        out = mm.int8_matmul_res_ln_quant(*ops, res, g, b)
        ref = mm.int8_matmul_res_ln_quant_plain(*ops, res, g, b)
        bf16_check(what + " res_ln_quant x'", out[0], ref[0])
        codes_check(what + " res_ln_quant", *out[1:], *ref[1:])
        for gelu in mm.GELUS:
            codes_check(f"{what} gelu_quant {gelu}",
                        *mm.int8_matmul_gelu_quant(*ops, gelu),
                        *mm.int8_matmul_gelu_quant_plain(*ops, gelu))
        del ops, res, out, ref
    for gelu in mm.GELUS:
        bad = mm.gelu_selftest(1 << 26, gelu)
        print(f"  [7 GEMM] the epilogue's {gelu} GELU, four values a call with "
              f"a branch-free division, vs the scalar GELU on {4 << 26} values: "
              f"{bad} differ in a bit", flush=True)
        require(bad == 0, f"the epilogue's {gelu} GELU differs in {bad} values")

    # 8. quantizing attention
    N = SIZE // 16 * SIZE // 16 + 1
    for B, n, H, shift in ((BATCH, N, 12, None), (BATCH, N, 12, "fixed"),
                           (3, 17, 2, "fixed"), (2, 65, 12, None),
                           (2, 65, 12, "fixed")):
        qkv = torch.randn((B, n, 3 * H * 64), device=dev,
                          generator=gen).to(torch.bfloat16)
        if shift == "fixed":  # as calibrate_attn_shifts sets it
            q, k = qkv[:8].float().reshape(min(B, 8), n, 3, H, 64)[:, :, :2].unbind(2)
            shift = torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() / 8 - 40
        oq, os_ = attn_ops.fused_qkv_attention_quant(qkv, H, shift)
        rq_, rs = attn_ops.reference_attention_quant(qkv, H, shift)
        torch.cuda.synchronize()
        err = (oq.float() * os_ - rq_.float() * rs).abs().max().item()
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_quant(qkv, H, shift), 20)
        plain_ms = cuda_ms(
            lambda: attn_ops.reference_attention_quant(qkv, H, shift), 5)
        flips = (oq != rq_).float().mean().item()
        print(f"[8 K4] attention quant {tuple(qkv.shape)} H={H} shift={shift}: "
              f"dequantized max |diff| {err} (atol {ATTN_ATOL}), {flips:.2e} "
              f"of codes differ; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        require(bool(torch.isfinite(os_).all()) and err <= ATTN_ATOL,
                f"K4 at {tuple(qkv.shape)}, shift {shift}: max |diff| {err}")
        if B == BATCH and shift is not None:
            kernels["fused_qkv_attention_quant"] = kernel_entry(
                "fused_qkv_attention_quant", "attention_quant.cu",
                "chess_vision_tpu/ops/attention.py:486", err, ms, plain_ms,
                nbytes=2 * qkv.numel() + B * n * H * 64 + 4 * B * n,
                ops=4 * B * H * n * n * 64, op_type="bf16")
        del qkv, oq, os_, rq_, rs
    lib = _build.library()
    print(f"  [8 K4] {flash_work('attention_quant_kernel', N, 64, 2 * 96 * 4)}; "
          f"clusters of 12 blocks the card holds at once: "
          f"{lib.cvt_attention_quant_max_clusters(12, 64)}", flush=True)


def gemm_case(what: str, dev, gen, ops, epi: str, replaces: str) -> dict:
    """One int8 GEMM epilogue on the operands ``ops`` (``operands_at``)
    against its plain version, as in phase 7; prints its time beside its
    share of the int8 peak, its bound and ``torch._int_mm``'s time on the same
    operands, and returns its kernels-line entry."""
    import torch

    from chess_vision_tpu_torch.ops import int8_matmul as mm

    M, K = ops[0].shape
    O = ops[2].shape[0]
    res = torch.randn((M, O), device=dev, generator=gen).bfloat16()
    g = torch.rand(O, device=dev, generator=gen) + 0.5
    b = torch.randn(O, device=dev, generator=gen) * 0.1
    kernel = getattr(mm, f"int8_matmul_{epi}")
    plain = getattr(mm, f"int8_matmul_{epi}_plain")
    extra = {"scale_bias": (), "res": (res,), "gelu_quant": ("sigmoid",),
             "res_ln_quant": (res, g, b)}[epi]
    out, ref = kernel(*ops, *extra), plain(*ops, *extra)
    torch.cuda.synchronize()
    if epi == "gelu_quant":
        err = codes_check(what, *out, *ref)
    elif epi == "res_ln_quant":
        err = max(bf16_check(what + " x'", out[0], ref[0]),
                  codes_check(what, *out[1:], *ref[1:]))
    else:
        err = bf16_check(what, out, ref)
    del out, ref
    ms = cuda_ms(lambda: kernel(*ops, *extra), 20)
    plain_ms = cuda_ms(lambda: plain(*ops, *extra), 5)
    tops = 2 * M * K * O / ms / 1e9
    # inputs: int8 x, its f32 row scales, the int8 weight, f32 column
    # scales and bias; outputs and extra inputs by epilogue (bf16 out;
    # int8 codes + row scales; the bf16 residual, and for res_ln_quant
    # also the bf16 x' and the LN's gamma and beta)
    nbytes = M * K + 4 * M + O * K + 8 * O + {
        "scale_bias": 2 * M * O, "res": 4 * M * O,
        "gelu_quant": M * O + 4 * M,
        "res_ln_quant": 5 * M * O + 4 * M + 8 * O}[epi]
    entry = kernel_entry(
        f"int8_matmul_{epi}", "int8_matmul.cu", replaces, err, ms, plain_ms,
        nbytes=nbytes, ops=2 * M * K * O, op_type="int8",
        library_ms=int_mm_ms(ops[0], ops[2], what))
    print(f"{what}: kernel {ms:.4f} ms ({tops:.0f} TOP/s, "
          f"{tops * 1e12 / PEAK_OPS['int8']:.3f} of the int8 peak), plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), torch._int_mm {entry['library_ms']} ms",
          flush=True)
    return entry


def operands_at(dev, gen, M: int, K: int, O: int) -> tuple:
    """Random operands of an int8 GEMM: xq (M, K), xs (M, 1), wq (O, K), ws
    and bias (O,), at the serving path's scales."""
    import torch

    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    return (ri(M, K), torch.rand((M, 1), device=dev, generator=gen) * 0.02
            + 0.002, ri(O, K),
            torch.rand(O, device=dev, generator=gen) * 0.0004 + 0.0002,
            torch.randn(O, device=dev, generator=gen) * 0.1)


def int_mm_ms(xq, wq, what: str) -> float | None:
    """The library yardstick of the int8 GEMMs: ``torch._int_mm`` on the same
    int8 operands, the product only (s32 out, no scales, no epilogue). The
    port never calls it; where this PyTorch build refuses the shapes the
    entry carries null."""
    import torch

    try:
        ms = cuda_ms(lambda: torch._int_mm(xq, wq.t()), 10)
    except RuntimeError as exc:
        print(f"  {what}: torch._int_mm does not run here "
              f"({str(exc).splitlines()[0]}): library_ms null", flush=True)
        return None
    print(f"  {what}: torch._int_mm (product only) {ms:.4f} ms", flush=True)
    return ms


def res_route_line(o: int, ptxas: bool = True) -> str:
    """K9's and K10's routes at o output columns (``mm.res_route``): K9's
    cluster and how many the card holds at once, K10's grid, a block's
    shared memory, and ptxas's registers and spills of the route kernels."""
    from chess_vision_tpu_torch.ops import int8_matmul as mm

    parts = []
    for epi in ("res_ln_quant", "res"):
        route = mm.res_route(o, epi)
        where = {"cluster": f"clusters of {route['cluster_blocks']} blocks, "
                            f"{route['count']} of them at once",
                 "tiles": f"one kernel, {route['count']} blocks, no cluster",
                 "two_launch": "the two-launch route"}
        parts.append(f"{epi} at O={o}: {where[route['route']]}, "
                     f"{route['smem_bytes']} bytes of shared memory a block")
        want = ("tiles" if epi == "res" else
                "cluster" if mm.res_cluster_blocks(o) else "two_launch")
        require(route["route"] == want
                and (route["count"] > 0 or want == "two_launch"),
                f"{epi} at O={o}: route {route}, expected {want}")
    if ptxas:
        tiles = -(-o // mm.TILE_N)  # K9's kernel takes its chunk count from them
        for kch in (tiles if tiles <= 4 else mm.CLUSTER_MAX, 0):
            parts.append(f"int8_res_kernel<{kch}>: {res_ptxas(kch)}")
    return "; ".join(parts)


def res_ptxas(kch: int) -> str:
    """ptxas's registers and spills of one instantiation of the residual
    kernel (kCh 0: K10's, else K9's), from this process's build."""
    import re

    from chess_vision_tpu_torch.ops import _build

    found = re.search(
        rf"Compiling entry function '[^']*int8_res_kernelILi{kch}E[^']*'.*?"
        rf"(\d+) bytes spill stores.*?Used (\d+) registers", _build.build_log,
        re.S)
    if not found:
        return "registers not in this build's log"
    return f"{found.group(2)} registers, {found.group(1)} bytes spilled"


def reset_counts() -> None:
    from chess_vision_tpu_torch.experiments import attn_variants as av
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    pre_ops.LAUNCHES = rq.LAUNCHES = fb.LAUNCHES = 0
    attn_ops.LAUNCHES = attn_ops.BWD_LAUNCHES = attn_ops.QUANT_LAUNCHES = 0
    attn_ops.FLAT_LAUNCHES = 0
    for counts in (mm.LAUNCHES, av.LAUNCHES):
        for key in counts:
            counts[key] = 0


def int8_counts() -> dict:
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    return {"preprocess_u8": pre_ops.LAUNCHES,
            "fused_qkv_attention": attn_ops.LAUNCHES,
            "fused_rowquant": rq.LAUNCHES,
            "fused_qkv_attention_quant": attn_ops.QUANT_LAUNCHES,
            "fused_qkv_attention_quant_flat": attn_ops.FLAT_LAUNCHES,
            "fused_vit_block": fb.LAUNCHES,
            **{f"int8_matmul_{k}": v for k, v in mm.LAUNCHES.items()}}


def int8_want(layout: str, depth: int, batches: int) -> dict:
    """The launches of ``batches`` int8 forwards of ``depth`` blocks."""
    split = {"block": depth, "flat": depth, "fused": 1}[layout]
    return {"preprocess_u8": batches, "fused_qkv_attention": 0,
            "fused_rowquant": batches,
            "fused_qkv_attention_quant":
                0 if layout == "flat" else split * batches,
            "fused_qkv_attention_quant_flat":
                depth * batches if layout == "flat" else 0,
            "fused_vit_block": (depth - 1) * batches if layout == "fused" else 0,
            "int8_matmul_scale_bias": split * batches,
            "int8_matmul_gelu_quant": split * batches,
            "int8_matmul_res_ln_quant": (2 * split - 1) * batches,
            "int8_matmul_res": batches}


def path_op_checks(predictor, boards, mean, std) -> dict:
    """Run one int8 forward on ``boards`` in which every kernel call is also
    computed by its plain version on the same inputs (the path goes on with
    the kernel's outputs). Returns, per op, the worst over its calls of: max
    int8 level difference, share of codes that differ, scale relative
    difference, dequantized max |difference| and bf16 ulps of bf16 outputs."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    worst: dict[str, dict] = {}

    def record(name, **vals):
        slot = worst.setdefault(name, {"calls": 0})
        slot["calls"] += 1
        for key, val in vals.items():
            slot[key] = max(slot.get(key, 0.0), val)

    def codes(q, s, rq_, rs):
        diff = (q.int() - rq_.int()).abs()
        return {"levels": diff.max().item(),
                "flips": (diff > 0).float().mean().item(),
                "scale_rel": ((s - rs).abs() / rs.abs()).max().item(),
                "deq": (q.float() * s - rq_.float() * rs).abs().max().item(),
                "nonfinite": float(not torch.isfinite(s).all())}

    shift_arg = {"fused_qkv_attention_quant": 2,
                 "fused_qkv_attention_quant_flat": 4, "fused_vit_block": 6}

    def hook(module, name, plain):
        kernel = getattr(module, name)

        def run(*a, **kw):
            out, ref = kernel(*a, **kw), plain(*a, **kw)
            if name in shift_arg:
                at = shift_arg[name]
                shift = a[at] if len(a) > at else kw.get("softmax_shift")
            if name == "fused_vit_block":  # x', yq, ys of a whole block
                vals = block_diff(out, ref)
                if shift is None:  # as for the attention below
                    del vals["levels"], vals["flips"], vals["x_off"]
                record(name, **vals)
            elif isinstance(out, torch.Tensor):  # scale_bias, res: bf16 out
                record(name, ulps=bf16_ulps(out, ref))
            elif len(out) == 3:  # res_ln_quant: x', yq, ys
                record(name, ulps=bf16_ulps(out[0], ref[0]),
                       **codes(*out[1:], *ref[1:]))
            elif name in shift_arg:  # the quantizing attentions
                vals = codes(*out, *ref)
                if name.endswith("flat"):  # real rows only: qkv, images, n_real
                    real = lambda t: t.reshape(a[1], -1, t.shape[-1])[:, :a[2]]  # noqa: E731
                    vals = codes(*(real(t) for t in (*out, *ref)))
                if shift is None:  # the exact row max: p rounds at other
                    del vals["levels"], vals["flips"]  # values (phase 8)
                record(name, **vals)
            else:
                record(name, **codes(*out, *ref))
            return out
        return run

    hooks = [(rq, "fused_rowquant", rq.rowquant_plain),
             (attn_ops, "fused_qkv_attention_quant",
              attn_ops.reference_attention_quant),
             (attn_ops, "fused_qkv_attention_quant_flat",
              attn_ops.reference_attention_quant_flat),
             (fb, "fused_vit_block", fb.fused_vit_block_plain)]
    hooks += [(mm, f"int8_matmul_{k}", getattr(mm, f"int8_matmul_{k}_plain"))
              for k in mm.LAUNCHES]
    with ExitStack() as stack:
        for module, name, plain in hooks:
            stack.enter_context(
                mock.patch.object(module, name, hook(module, name, plain)))
        int8_logits(predictor, boards, mean, std)
    return worst


def block_diff(out, ref) -> dict:
    """(x', yq, ys) of a whole block, kernel vs plain: the share of x' more
    than one bf16 ulp off, the largest code difference, the share of codes
    that differ, the scales' relative difference, the dequantized max
    |difference|."""
    import torch

    (x, q, s), (rx, rq_, rs) = out, ref
    xf, rf = x.float(), rx.float()
    ulp = torch.exp2(torch.floor(torch.log2(rf.abs().clamp_min(1e-30))) - 7)
    levels = (q.int() - rq_.int()).abs()
    return {"x_off": ((xf - rf).abs() > ulp).float().mean().item(),
            "x_max": (xf - rf).abs().max().item(),
            "levels": levels.max().item(),
            "flips": (levels > 0).float().mean().item(),
            "scale_rel": ((s - rs).abs() / rs.abs()).max().item(),
            "deq": (q.float() * s - rq_.float() * rs).abs().max().item(),
            "nonfinite": float(not (torch.isfinite(s).all()
                                    and torch.isfinite(xf).all()))}


def block_ok(w: dict) -> bool:
    """BLOCK_BOUNDS: see BLOCK_SHARE."""
    return (w.get("x_off", 0.0) < BLOCK_SHARE
            and w.get("flips", 0.0) < BLOCK_SHARE
            and w.get("levels", 0) <= BLOCK_LEVELS
            and w["scale_rel"] <= BLOCK_SCALE_RTOL and not w["nonfinite"])


def require_path_ops(worst: dict, tag: str = "[9 int8]") -> None:
    """The criteria of phases 6-8 at the path's own activations; the
    quantizing attention's codes, where its shift is the calibrated one, also
    within one level in under 1e-3 of the elements; the whole-block kernel
    within BLOCK_BOUNDS."""
    for name, w in worst.items():
        if name == "fused_vit_block":
            require(block_ok(w), f"{tag} {name} on the path: {w}")
            continue
        if "levels" in w:
            require(w["levels"] <= 1 and w["flips"] < 1e-3,
                    f"{tag} {name} on the path: {w}")
        if "ulps" in w:
            require(w["ulps"] <= 1.0, f"{tag} {name} on the path: {w}")
        if name.startswith("fused_qkv_attention_quant"):
            require(w["deq"] <= ATTN_ATOL and not w["nonfinite"],
                    f"{tag} {name} on the path: {w}")
        elif "scale_rel" in w:
            require(w["scale_rel"] <= 1e-5 and not w["nonfinite"],
                    f"{tag} {name} on the path: {w}")


def build_int8_predictor(args, cfg, layout: str | None = None):
    """``Predictor(quant="int8")`` on the seed's random weights, its shifts
    calibrated on 8 random boards, under CHESS_VISION_INT8_LAYOUT=layout
    (unset for None), warmed up; returns it and the set-up seconds."""
    import os

    import torch

    from chess_vision_tpu_torch.serve import Predictor

    rng = np.random.default_rng(args.seed + 1)
    calib = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    env = {} if layout is None else {"CHESS_VISION_INT8_LAYOUT": layout}
    t0 = time.perf_counter()
    # the Predictor decodes its calibration files; here they are boards in
    # memory, named by index
    with mock.patch.object(Predictor, "_decode",
                           lambda self, path: calib[int(path)]), \
            mock.patch.dict(os.environ, env):
        if layout is None:
            os.environ.pop("CHESS_VISION_INT8_LAYOUT", None)
        predictor = Predictor((cfg, random_jax_params(cfg, args.seed)),
                              batch_size=BATCH, device="cuda", quant="int8",
                              calib_paths=[str(i) for i in range(len(calib))])
    predictor.predict_array(
        rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8))  # warm-up
    torch.cuda.synchronize()
    return predictor, time.perf_counter() - t0


def check_int8_path(tag: str, predictor, args, boards, kernels: dict,
                    count_into: tuple) -> list:
    """Drive ``predict_array`` on ``boards`` with the counts set to 0 just
    before and read just after; require the layout's launch counts, agreement
    with the same Predictor on the plain versions on the card, and every
    kernel call of one batch against its plain version. The counts of the
    kernels named in ``count_into`` go into the kernels line. Returns the
    FENs."""
    from chess_vision_tpu_torch import fen_to_labels
    from chess_vision_tpu_torch.config import get_data_config

    depth = predictor.cfg["model"]["depth"]
    layout = predictor.layout
    batches = math.ceil(args.boards / BATCH)
    reset_counts()
    fens = predictor.predict_array(boards)
    launches = int8_counts()
    want = int8_want(layout, depth, batches)
    print(f"{tag} ViT-B/16 {SIZE}px int8 full width, layout {layout}, "
          f"{args.boards} boards in {batches} batches of {BATCH}: launches "
          f"{launches}", flush=True)
    require(launches == want, f"{tag} launch counts {launches}, want {want}")
    for name in count_into:
        kernels[name]["launches"] = launches[name]

    with plain_int8_ops():
        fens_plain = predictor.predict_array(boards)
    require(int8_counts() == want, "the plain-ops run launched a kernel")
    data_cfg = get_data_config(predictor.cfg["model"]["name"])
    mean, std = data_cfg["mean"], data_cfg["std"]
    logits_k = int8_logits(predictor, boards, mean, std)
    with plain_int8_ops():
        logits_p = int8_logits(predictor, boards, mean, std)
    sq_k, sq_p = logits_k["squares"], logits_p["squares"]
    require(sq_k.shape == (args.boards, 64 * 13) and np.isfinite(sq_k).all(),
            f"int8 logits: shape {sq_k.shape}, finite {np.isfinite(sq_k).all()}")
    sq_err = float(np.abs(sq_k - sq_p).max())
    require(len(fens) == len(fens_plain) == args.boards, "FEN count")
    ids_k = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    ids_p = sq_p.reshape(-1, 64, 13).argmax(-1)
    top2 = np.sort(sq_p.reshape(-1, 64, 13), axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 2 * INT8_SQUARES_ATOL
    mismatch = int((ids_k != ids_p)[confident].sum())
    turn_k = np.array([f.split()[1] == "b" for f in fens])
    turn_conf = np.abs(logits_p["turn"][:, 0]) > 2 * INT8_SQUARES_ATOL
    turn_mismatch = int((turn_k != (logits_p["turn"][:, 0] > 0))[turn_conf].sum())
    same = sum(a == b for a, b in zip(fens, fens_plain))
    print(f"{tag} squares logits kernel vs plain: max |diff| {sq_err} (atol "
          f"{INT8_SQUARES_ATOL}); {int(confident.sum())} of {confident.size} "
          f"squares have top-2 margin > {2 * INT8_SQUARES_ATOL}, {mismatch} "
          f"differ; turn mismatches on confident boards {turn_mismatch}; "
          f"{same}/{args.boards} FEN strings identical", flush=True)
    require(sq_err <= INT8_SQUARES_ATOL, f"int8 squares logits differ by {sq_err}")
    require(mismatch == 0 and turn_mismatch == 0,
            "int8 FENs differ on confident squares or turns")

    # each kernel call of one batch against its plain version on the same
    # inputs, at the path's own activations (launches here are not counted)
    worst = path_op_checks(predictor, boards[:BATCH], mean, std)
    print(f"{tag} each kernel call of one batch vs its plain version on "
          f"the same inputs (worst per op): {worst}", flush=True)
    calls = {name: count // batches for name, count in want.items()
             if count and name != "preprocess_u8"}
    require({k: w["calls"] for k, w in worst.items()} == calls,
            f"checked calls {worst}, want {calls}")
    require_path_ops(worst, tag)
    return fens


def int8_path_phase(args, cfg, boards, fens_bf16, predictor_bf16, kernels,
                    kind, smi) -> dict:
    """Phase 9: the int8 serving path through ``Predictor(quant="int8")``,
    the default block layout. Returns what the layout phases reuse: the
    Predictor, its shifts and its FENs."""
    from chess_vision_tpu_torch import fen_to_labels

    depth = cfg["model"]["depth"]
    predictor, setup_s = build_int8_predictor(args, cfg)
    shifts = predictor.attn_shifts
    require(len(shifts) == depth, f"{len(shifts)} calibrated shifts")
    require(predictor.layout == "block", f"layout {predictor.layout}")
    print(f"[9 int8] set-up {setup_s:.1f} s, gelu {predictor.gelu}, calibrated "
          f"shifts {[None if s is None else round(s, 3) for s in shifts]}",
          flush=True)
    fens = check_int8_path(
        "[9 int8]", predictor, args, boards, kernels,
        ("fused_rowquant", "fused_qkv_attention_quant",
         "int8_matmul_scale_bias", "int8_matmul_gelu_quant",
         "int8_matmul_res_ln_quant", "int8_matmul_res"))
    ids_k = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    ids_bf16 = np.stack([fen_to_labels(f.split()[0]) for f in fens_bf16])
    print(f"[9 int8] int8 vs bf16 (random weights, near-tied logits; not "
          f"gated): square agreement {(ids_k == ids_bf16).mean():.4f}, "
          f"{sum(a == b for a, b in zip(fens, fens_bf16))}/{args.boards} FEN "
          f"strings identical", flush=True)

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {"int8 kernel": [], "int8 plain": [], "bf16 kernel": []}
    for which in ("int8 kernel", "int8 plain", "bf16 kernel", "bf16 kernel",
                  "int8 plain", "int8 kernel"):
        pred = predictor_bf16 if which == "bf16 kernel" else predictor
        with plain_int8_ops() if which == "int8 plain" else nullcontext():
            t0 = time.perf_counter()
            pred.predict_array(bench)
            rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"[9 int8] predict_array boards/s at batch {BATCH} ({len(bench)} "
          f"boards per run; in the order int8 kernel, int8 plain, bf16 kernel, "
          f"bf16 kernel, int8 plain, int8 kernel): {rates}; {kind}, {smi}",
          flush=True)
    if args.profile_int8:
        bench = np.concatenate(
            [boards] * math.ceil(args.profile_int8 / args.boards))
        profile_int8_batches("[9 int8]", predictor, bench[:args.profile_int8],
                             BATCH / rates["int8 kernel"][-1] * 1e3)
    return {"predictor": predictor, "shifts": shifts, "fens": fens}


def profile_int8_batches(tag: str, predictor, bench, batch_ms: float) -> None:
    """``torch.profiler`` over ``predict_array`` of an int8 Predictor (any
    layout): kernels by device time, and the device's idle share of an
    unprofiled batch of ``batch_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = math.ceil(len(bench) / BATCH)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.predict_array(bench)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / batches
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3 / batches
    print(f"{tag} profile of {len(bench)} boards in {batches} batches: device "
          f"{device_ms:.2f} ms per batch; a batch takes {batch_ms:.2f} ms "
          f"unprofiled (idle share {1 - device_ms / batch_ms:.3f}) and "
          f"{wall_ms:.1f} ms under the profiler", flush=True)
    # the row pass runs once a batch (the first LayerNorm): K9 folds its own
    # into the cluster kernel, one launch a call
    per_batch = {name: sum(e.count for e in events
                           if e.device_type == DeviceType.CUDA and name in e.key)
                 / batches for name in ("rowquant_kernel", "int8_res_kernel")}
    print(f"{tag} kernels per batch in the profile: {per_batch}", flush=True)
    require(per_batch["rowquant_kernel"] == 1,
            f"{tag} {per_batch['rowquant_kernel']} row passes a batch")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60), flush=True)


def layout_path_phase(number: int, layout: str, args, cfg, boards, int8: dict,
                      kernels: dict):
    """Phases 14 and 15: the int8 serving path under
    CHESS_VISION_INT8_LAYOUT=flat or fused. Returns the Predictor."""
    tag = f"[{number} {layout}]"
    predictor, setup_s = build_int8_predictor(args, cfg, layout)
    require(predictor.layout == layout, f"{tag} layout {predictor.layout}")
    require(predictor.attn_shifts == int8["shifts"],
            f"{tag} calibrated shifts {predictor.attn_shifts} differ from "
            f"phase 9's {int8['shifts']}")
    print(f"{tag} set-up {setup_s:.1f} s, the shifts of phase 9", flush=True)
    own = {"flat": "fused_qkv_attention_quant_flat",
           "fused": "fused_vit_block"}[layout]
    fens = check_int8_path(tag, predictor, args, boards, kernels, (own,))
    same = sum(a == b for a, b in zip(fens, int8["fens"]))
    print(f"{tag} FEN strings identical to the block layout's: {same}/"
          f"{args.boards}", flush=True)
    return predictor


def layout_bench(args, boards, predictors: dict, kind: str, smi: str) -> None:
    """boards/s of the three int8 layouts' kernel paths, in turns; with
    ``--profile-int8 N``, then a profile of N boards through the flat and the
    fused layout."""
    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {name: [] for name in predictors}
    order = [*predictors, *reversed(predictors)]
    for name in order:
        t0 = time.perf_counter()
        predictors[name].predict_array(bench)
        rates[name].append(len(bench) / (time.perf_counter() - t0))
    print(f"[15 fused] predict_array boards/s of the int8 layouts at batch "
          f"{BATCH} ({len(bench)} boards per run; in the order "
          f"{', '.join(order)}): {rates}; {kind}, {smi}", flush=True)
    if args.profile_int8:
        bench = np.concatenate(
            [boards] * math.ceil(args.profile_int8 / args.boards))
        for name in ("flat", "fused"):
            profile_int8_batches(f"[15 {name}]", predictors[name],
                                 bench[:args.profile_int8],
                                 BATCH / rates[name][-1] * 1e3)


def layout_kernel_phases(args, dev, int8: dict, kernels: dict) -> None:
    """Phases 12 and 13: K5 and K14 at the layouts' shapes vs their plain
    versions on the same inputs, timed with CUDA events."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.ops import rowquant as rq

    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    N = SIZE // 16 * SIZE // 16 + 1
    NP = -(-N // 32) * 32

    # 12. K5
    for B, np_, n, H, shift in ((BATCH, NP, N, 12, None),
                                (BATCH, NP, N, 12, "fixed"),
                                (3, 32, 27, 2, "fixed")):
        D = H * 64
        qkv = torch.randn((B, np_, 3 * D), device=dev,
                          generator=gen).to(torch.bfloat16)
        if shift == "fixed":  # as calibrate_attn_shifts sets it
            q, k = qkv[:8, :n].float().reshape(min(B, 8), n, 3, H, 64)[:, :, :2].unbind(2)
            shift = torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() / 8 - 40
        flat = qkv.reshape(B * np_, 3 * D)
        real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
        run = lambda: attn_ops.fused_qkv_attention_quant_flat(  # noqa: E731
            flat, B, n, H, shift)
        oq, os_ = run()
        rq_, rs = attn_ops.reference_attention_quant_flat(flat, B, n, H, shift)
        kq, ks = attn_ops.fused_qkv_attention_quant(qkv[:, :n].contiguous(), H,
                                                    shift)
        loud = qkv.clone()
        loud[:, n:, D:] = 1e4  # the padded keys and values
        lq, ls = attn_ops.fused_qkv_attention_quant_flat(
            loud.reshape(B * np_, 3 * D), B, n, H, shift)
        torch.cuda.synchronize()
        err = real(oq.float() * os_ - rq_.float() * rs).abs().max().item()
        k4_diff = int((real(oq) != kq).sum()) + int((real(os_) != ks).sum())
        loud_diff = (int((real(lq) != real(oq)).sum())
                     + int((real(ls) != real(os_)).sum()))
        finite = bool(torch.isfinite(os_).all())  # padded query rows too
        del loud, lq, ls, kq, ks
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention_quant_flat(
            flat, B, n, H, shift), 5)
        entry = kernel_entry(
            "fused_qkv_attention_quant_flat", "attention_quant.cu",
            "chess_vision_tpu/ops/attention.py:772", err, ms, plain_ms,
            nbytes=2 * qkv.numel() + B * np_ * D + 4 * B * np_,
            ops=4 * B * H * np_ * n * 64, op_type="bf16")
        print(f"[12 K5] flat attention quant ({B * np_}, {3 * D}) images {B} "
              f"n_real {n} H={H} shift={shift}: real rows dequantized max "
              f"|diff| {err} (atol {ATTN_ATOL}); {k4_diff} codes and scales "
              f"differ from K4 on the unpadded values; {loud_diff} differ with "
              f"the padded keys at 1e4; scales finite {finite}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})", flush=True)
        require(finite and err <= ATTN_ATOL,
                f"K5 at {tuple(flat.shape)}, shift {shift}: max |diff| {err}")
        require(k4_diff == 0, f"K5's real rows differ from K4 in {k4_diff}")
        require(loud_diff == 0, f"padded keys reached {loud_diff} real values")
        if B == BATCH and shift is not None:
            kernels["fused_qkv_attention_quant_flat"] = entry
        del qkv, flat, oq, os_, rq_, rs

    # 12. K11-K13: the flat layout's GEMMs at its own rows (BATCH images of NP)
    print(f"  [12 K11-K13] {res_route_line(768)}", flush=True)
    for epi, K, O, replaces in (
            ("gelu_quant", 768, 3072, "chess_vision_tpu/ops/int8_matmul.py:395"),
            ("res_ln_quant", 768, 768, "chess_vision_tpu/ops/int8_matmul.py:426"),
            ("res_ln_quant", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:426"),
            ("res", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:465")):
        ops = operands_at(dev, gen, BATCH * NP, K, O)
        gemm_case(f"[12 K11-K13] flat {epi} ({BATCH * NP}, {K}) -> {O}", dev, gen,
                  ops, epi, replaces)
        del ops

    # 13. K14: block 0 of the served model at the path's shape, and a small
    # block of random int8 weights
    def small_block(D, O1):
        ri = lambda *shape: torch.randint(  # noqa: E731
            -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
        dense = lambda k, o: {  # noqa: E731
            "wq": ri(o, k),
            "scale": torch.rand(o, device=dev, generator=gen) * 4e-4 + 2e-4,
            "bias": torch.randn(o, device=dev, generator=gen) * 0.1}
        norm = lambda: {  # noqa: E731
            "scale": torch.rand(D, device=dev, generator=gen) + 0.5,
            "bias": torch.randn(D, device=dev, generator=gen) * 0.1}
        return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
                "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}

    blocks = int8["predictor"].pack["blocks"]
    # layer 0's calibrated shift; 0.0 (the random model's logits stay within
    # a few units) should calibration have left that layer to the row max
    shift0 = int8["shifts"][0] if int8["shifts"][0] is not None else 0.0
    cases = ((BATCH, N, 12, blocks[0], blocks[1]["norm1"], shift0),
             (3, 17, 2, small_block(128, 256), small_block(128, 256)["norm1"],
              1.0))
    for B, n, H, q, nxt, shift in cases:
        D = H * 64
        O1 = q["fc1"]["wq"].shape[0]
        x = (torch.randn((B, n, D), device=dev, generator=gen) * 0.5).bfloat16()
        xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"],
                                   q["norm1"]["bias"])
        run = lambda: fb.fused_vit_block(xq, xs, x, q, nxt, H, shift)  # noqa: E731
        split = lambda: quant.block_int8(x, xq, xs, q, nxt, H, shift)  # noqa: E731
        out, again, chain = run(), run(), split()
        ref = fb.fused_vit_block_plain(xq, xs, x, q, nxt, H, shift)
        bad = block_plain_unrounded_residual(xq, xs, x, q, nxt, H, shift)
        torch.cuda.synchronize()
        same = all(bool((a == b).all()) for a, b in zip(out, again))
        as_chain = all(bool((a == b).all()) for a, b in zip(out, chain))
        diff, planted = block_diff(out, ref), block_diff(out, bad)
        del again, chain, ref, bad
        times = {"fused": [], "split": []}
        for which in ("fused", "split", "split", "fused"):
            times[which].append(cuda_ms(run if which == "fused" else split, 10))
        ms = min(times["fused"])
        plain_ms = cuda_ms(lambda: fb.fused_vit_block_plain(
            xq, xs, x, q, nxt, H, shift), 3)
        stage_ns = torch.zeros(len(fb.STAGES) + 1, dtype=torch.int64, device=dev)
        fb.fused_vit_block(xq, xs, x, q, nxt, H, shift, stage_ns=stage_ns)
        torch.cuda.synchronize()
        stages = dict(zip(fb.STAGES, (stage_ns.diff().cpu() / 1e6).tolist()))
        print(f"[13 K14] stages of one launch, ms by the card's clock (the last "
              f"is block 0's share): {stages}", flush=True)
        M = B * n
        entry = kernel_entry(
            "fused_vit_block", "fused_block.cu",
            "chess_vision_tpu/ops/fused_block.py:202", diff["deq"], ms, plain_ms,
            # in: int8 x + row scales, bf16 residual, the four int8 weights
            # with column scales and biases, two LNs; out: bf16 x', int8
            # codes + row scales
            nbytes=(M * D + 4 * M + 2 * M * D + D * (4 * D + 2 * O1)
                    + 8 * (4 * D + O1 + D) + 16 * D + 2 * M * D + M * D + 4 * M),
            ops={"int8": 2 * M * D * (4 * D + 2 * O1),
                 "bf16": 4 * B * H * n * n * 64})
        print(f"[13 K14] whole block ({B}, {n}, {D}) H={H} O1={O1} shift="
              f"{shift}: two launches bit-identical {same}; bit-identical to "
              f"the split chain {as_chain}; vs plain {diff} (bounds: shares "
              f"< {BLOCK_SHARE}, levels <= {BLOCK_LEVELS}, scales rtol "
              f"{BLOCK_SCALE_RTOL}); planted fault (residual not rounded "
              f"before the LN) {planted}; kernel ms {times['fused']}, split "
              f"chain of 5 launches ms {times['split']} (in the order fused, "
              f"split, split, fused), plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})", flush=True)
        require(same, "K14 is not deterministic")
        require(as_chain, "K14 differs from the chain of split kernels")
        require(block_ok(diff), f"K14 at {(B, n, D)} vs plain: {diff}")
        require(not block_ok(planted), f"the planted fault passes: {planted}")
        if B == BATCH:
            kernels["fused_vit_block"] = entry
        del x, xq, xs, out
    torch.cuda.empty_cache()


def block_plain_unrounded_residual(xq, xs, res, q, next_ln, num_heads, shift):
    """``fused_vit_block_plain`` with a planted fault: LN2 reads the f32
    residual sum instead of its bf16 rounding."""
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    qkv = mm.int8_matmul_scale_bias_plain(
        xq, xs, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    aq, as_ = attn_ops.reference_attention_quant(qkv, num_heads, shift)
    x1 = res.float() + mm._rescaled(aq, as_, q["proj"]["wq"],
                                    q["proj"]["scale"], q["proj"]["bias"])
    hq, hs = rq.rowquant_plain(x1, "ln", q["norm2"]["scale"],
                               q["norm2"]["bias"])  # the fault: x1 is f32
    gq, gs = mm.int8_matmul_gelu_quant_plain(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], "sigmoid")
    return mm.int8_matmul_res_ln_quant_plain(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"],
        x1.to(res.dtype), next_ln["scale"], next_ln["bias"])


def variant_sweep_phase(args, dev, kernels: dict) -> None:
    """Phase 16: the attention-variant sweep and each variant's kernel vs
    its plain version."""
    import torch

    from chess_vision_tpu_torch.experiments import attn_variants as av
    from chess_vision_tpu_torch.ops import rowquant as rq

    reset_counts()
    times = av.sweep(BATCH)
    launches = dict(av.LAUNCHES)
    row_passes = rq.LAUNCHES
    print(f"[16 K15] sweep at batch {BATCH}: launches {launches}, row-quant "
          f"launches {row_passes}", flush=True)
    require(list(times) == list(av.VARIANTS), f"sweep ran {list(times)}")
    require(all(count == 17 for count in launches.values()),
            f"sweep launch counts {launches}, want 1 + 16 each")
    require(row_passes == 0, f"the sweep launched the row quant {row_passes} "
            "times")

    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    N, H, Dh = SIZE // 16 * SIZE // 16 + 1, 12, 64
    D = H * Dh
    qkv = torch.randn((BATCH, N, 3 * D), device=dev,
                      generator=gen).to(torch.bfloat16)
    for name in av.VARIANTS:
        kernel = av.make_variant(name, H, N, D)
        plain = av.variant_plain(name, H, N, D)
        (oq, os_), (rq_, rs) = kernel(qkv), plain(qkv)
        two = av.make_variant(name, H, N, D, bb=2)(qkv)
        torch.cuda.synchronize()
        err = (oq.float() * os_ - rq_.float() * rs).abs().max().item()
        flips = (oq != rq_).float().mean().item()
        bb_same = bool((two[0] == oq).all() and (two[1] == os_).all())
        finite = bool(torch.isfinite(os_).all())
        del two, rq_, rs
        ms = cuda_ms(lambda: kernel(qkv), 20)
        plain_ms = cuda_ms(lambda: plain(qkv), 3)
        device_kernels = profiled_kernels(lambda: kernel(qkv))
        atol = VARIANT_ATOL.get(name, ATTN_ATOL)
        entry = kernels[f"attn_variant_{name}"] = kernel_entry(
            f"attn_variant_{name}", "attention_variants.cu",
            "experiments/attn_variants.py:43", err, ms, plain_ms,
            nbytes=2 * qkv.numel() + BATCH * N * D + 4 * BATCH * N,
            ops=4 * BATCH * H * N * N * Dh, op_type="bf16")
        entry["launches"] = launches[name]
        print(f"[16 K15] variant {name} {tuple(qkv.shape)}: dequantized max "
              f"|diff| {err} (atol {atol}), {flips:.2e} of codes differ, bb=2 "
              f"bit-identical {bb_same}; kernel {ms:.4f} ms (earlier design "
              f"{K15_EARLIER_MS[name]:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); sweep "
              f"{times[name]:.4f} ms/batch; device kernels of one call "
              f"{device_kernels}; "
              f"{ptxas_counts('attention_variant_kernel', Dh, av.VARIANTS[name])}",
              flush=True)
        require(finite and err <= atol, f"K15 {name}: max |diff| {err}")
        require(bb_same, f"K15 {name}: bb=2 differs from bb=1")
        require(len(device_kernels) == 1
                and "attention_variant_kernel" in device_kernels[0],
                f"K15 {name}: one call ran the device kernels {device_kernels}")
        del oq, os_
    del qkv
    torch.cuda.empty_cache()


@contextmanager
def plain_int8_ops():
    """Route the int8 forward's kernels and the preprocess through their
    plain PyTorch versions, on the card."""
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    patches = [(rq, "fused_rowquant", rq.rowquant_plain),
               (attn_ops, "fused_qkv_attention_quant",
                attn_ops.reference_attention_quant),
               (attn_ops, "fused_qkv_attention_quant_flat",
                attn_ops.reference_attention_quant_flat),
               (fb, "fused_vit_block", fb.fused_vit_block_plain),
               (pre_ops, "preprocess_u8", pre_ops.preprocess_u8_plain)]
    patches += [(mm, f"int8_matmul_{k}", getattr(mm, f"int8_matmul_{k}_plain"))
                for k in mm.LAUNCHES]
    with ExitStack() as stack:
        for module, name, plain in patches:
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def int8_logits(predictor, boards, mean, std) -> dict[str, np.ndarray]:
    import torch

    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import quant

    outs = []
    with torch.inference_mode():
        for start in range(0, len(boards), BATCH):
            u8 = torch.from_numpy(boards[start:start + BATCH]).to("cuda")
            x = pre_ops.preprocess_u8(u8, mean, std, torch.bfloat16)
            out = quant.chessvit_int8_apply(
                predictor.pack, x, predictor.attn_shifts, gelu=predictor.gelu,
                num_heads=predictor.cfg["model"]["num_heads"],
                layout=predictor.layout)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@contextmanager
def plain_ops(attn_ops, pre_ops):
    """Route the model's attention and the Predictor's preprocess through the
    plain PyTorch versions, on the card."""
    with mock.patch.object(attn_ops, "fused_qkv_attention",
                           attn_ops.reference_attention), \
            mock.patch.object(pre_ops, "preprocess_u8",
                              pre_ops.preprocess_u8_plain):
        yield


def forward_logits(predictor, boards, mean, std) -> dict[str, np.ndarray]:
    import torch

    from chess_vision_tpu_torch.ops import preprocess as pre_ops

    outs = []
    with torch.inference_mode():
        for start in range(0, len(boards), BATCH):
            u8 = torch.from_numpy(boards[start:start + BATCH]).to("cuda")
            x = pre_ops.preprocess_u8(u8, mean, std, predictor.model.dtype)
            outs.append({k: v.cpu().numpy()
                         for k, v in predictor.model(x).items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

def sdpa_ms(qkv, g, H: int) -> tuple[float, float]:
    """The library yardstick of K2 and K3, which the port never calls:
    ``scaled_dot_product_attention`` forward, and its backward alone, on
    contiguous (B, H, N, Dh) copies of the same q, k, v and cotangent (the
    permute copies that route would also need are not counted)."""
    import torch
    import torch.nn.functional as F

    B, N, C3 = qkv.shape
    Dh = C3 // 3 // H
    q, k, v = (t.permute(0, 2, 1, 3).contiguous().requires_grad_()
               for t in qkv.reshape(B, N, 3, H, Dh).unbind(2))
    go = g.reshape(B, N, H, Dh).permute(0, 2, 1, 3).contiguous()
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    out = F.scaled_dot_product_attention(q, k, v)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), go,
                                              retain_graph=True), 20)
    return fwd, bwd


def attention_bwd_phase(args, dev, kernels: dict) -> None:
    """Phase 10: K3 vs ``reference_attention_bwd``, and the library
    yardsticks of K2 and K3."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    N = SIZE // 16 * SIZE // 16 + 1
    # 289 and 577 tokens (a 384 px ViT) take the long route
    odd = [(2, n, 2, Dh) for n in (17, 64, 65, 257, 264, 289, 577)
           for Dh in (16, 32, 64)]
    long_n = (384 // 16) ** 2 + 1
    for B, n, H, Dh in ((BATCH, N, 12, 64), (TRAIN_BATCH, N, 12, 64),
                        (3, 17, 1, 32), *odd, (TRAIN_BATCH, long_n, 12, 64)):
        D = H * Dh
        qkv = torch.randn((B, n, 3 * D), device=dev, generator=gen).bfloat16()
        g = torch.randn((B, n, D), device=dev, generator=gen).bfloat16()
        out = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        again = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        ref = attn_ops.reference_attention_bwd(qkv, g, H)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().reshape(B, n, 3, D)
        errs = {name: diff[:, :, i].max().item()
                for i, name in enumerate(("dq", "dk", "dv"))}
        finite = bool(torch.isfinite(out).all())
        same = bool((out == again).all())
        # planted fault: dK made from the unscaled dS
        bad_dk = ref[..., D:2 * D].float() * math.sqrt(Dh)
        planted = (out[..., D:2 * D].float() - bad_dk).abs().max().item()
        del diff, bad_dk, again
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, H), 20)
        plain_ms = cuda_ms(
            lambda: attn_ops.reference_attention_bwd(qkv, g, H), 3)
        route = attn_ops.bwd_route(n)
        work = k3_work(n, Dh) if route == "short" else "the two-kernel long route"
        print(f"[10 K3] attention backward {tuple(qkv.shape)} H={H}: max |diff| "
              f"{errs} (atol {K3_ATOL}), planted unscaled dK {planted}, two "
              f"launches bit-identical {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; {work}", flush=True)
        require(finite and max(errs.values()) <= K3_ATOL,
                f"K3 at {tuple(qkv.shape)}: {errs}, finite {finite}")
        require(planted > K3_ATOL, f"the planted fault passes: {planted}")
        require(same, "K3 is not deterministic")
        if B >= TRAIN_BATCH:
            fwd_ms, bwd_ms = sdpa_ms(qkv, g, H)
            print(f"[10 K3] scaled_dot_product_attention on the same values: "
                  f"forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms",
                  flush=True)
        if B == BATCH or n == long_n:
            if B == BATCH:
                kernels["fused_qkv_attention"]["library_ms"] = fwd_ms
            name = ("fused_qkv_attention_bwd" if route == "short"
                    else "fused_qkv_attention_bwd_long")
            kernels[name] = kernel_entry(
                name, "attention_bwd.cu" if route == "short"
                else "attention_bwd_long.cu",
                "chess_vision_tpu/ops/attention.py:623", max(errs.values()),
                ms, plain_ms, nbytes=2 * (2 * qkv.numel() + g.numel()),
                ops=10 * B * H * n * n * Dh, op_type="bf16", library_ms=bwd_ms)
        del qkv, g, out, ref
    torch.cuda.empty_cache()


def k3_work(n: int, head_dim: int) -> str:
    """What K3 executes per (image, head) at n tokens: its 7 products (S and
    dP in both sweeps, dQ, dK, dV) over 16-row and 16-key groups, beside the 5
    products on n x n the function needs; ptxas's registers for this head dim
    (from this process's build, if it built) and the block's shared memory."""
    import re

    from chess_vision_tpu_torch.ops import _build

    padded = -(-n // 16) * 16
    done = 7 * 2 * padded * padded * head_dim
    needed = 5 * 2 * n * n * head_dim
    smem = 2 * padded * (4 * (head_dim + 8) + 2 * 40)
    found = re.search(
        rf"attention_bwd_kernelILi{head_dim}E.*?Used (\d+) registers",
        _build.build_log, re.S)
    regs = f"{found.group(1)} registers" if found else "registers not in this build's log"
    return (f"7 products on {padded} x {padded}: {done / 1e6:.2f} MFLOP per head "
            f"for {needed / 1e6:.2f} needed ({done / needed:.2f}x); {regs}, "
            f"{smem} bytes of shared memory per block")


def ptxas_counts(kernel: str, head_dim: int, variant: int | None = None) -> str:
    """ptxas's registers and spills of one instantiation of a kernel (K15's
    of one variant), from this process's build (empty when an up-to-date
    library was reused)."""
    import re

    from chess_vision_tpu_torch.ops import _build

    args = f"ILi{head_dim}E" if variant is None else f"ILi{head_dim}ELi{variant}E"
    found = re.search(
        rf"Compiling entry function '[^']*{kernel}{args}[^']*'.*?"
        rf"(\d+) bytes spill stores.*?Used (\d+) registers", _build.build_log,
        re.S)
    if not found:
        return "registers not in this build's log"
    return f"{found.group(2)} registers, {found.group(1)} bytes spilled"


def profiled_kernels(fn) -> list[str]:
    """The names of the device kernels one call of fn runs, by
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memset" not in e.name.lower() and "memcpy" not in e.name.lower()]


def flash_work(kernel: str, n: int, head_dim: int, extra_smem: int = 0) -> str:
    """What the forward loop (csrc/attention_loop.cuh) executes at n tokens:
    16-row and 16-key edges, row chunks of 3 warps (96 rows), a 2-stage K/V
    ring; ptxas's counts and the block's shared memory (the ring and the Q
    rows, plus ``extra_smem`` bytes of the kernel's own)."""
    padded = -(-n // 16) * 16
    blocks = -(-n // 16)
    chunks = -(-blocks // 6)
    smem = 2 * (2 * 2 * 64 + 96) * (head_dim + 8) + extra_smem
    return (f"{padded} x {padded} scores per head ({padded * padded / n / n:.2f}x"
            f" the needed), {chunks} row chunks per head; "
            f"{ptxas_counts(kernel, head_dim)}, {smem} bytes of shared memory "
            f"per block")


class MemoryCorpus:
    """An in-memory dataset with the interface of ``data.ChessDataset``:
    random uint8 boards, labels from random legal-looking FENs."""

    def __init__(self, count: int, seed: int):
        from chess_vision_tpu_torch.fen import parse_full_fen

        rng = np.random.default_rng(seed)
        self.boards = rng.integers(0, 256, (count, SIZE, SIZE, 3), dtype=np.uint8)
        self.samples = [{"filename": f"{i:06d}.png", "fen": random_fen(rng),
                         "legal": "1"} for i in range(count)]
        self._parse = parse_full_fen

    def __len__(self) -> int:
        return len(self.samples)

    def labels_for(self, idx: int) -> dict:
        labels = self._parse(self.samples[idx]["fen"])
        labels["legal"] = np.ones(1, np.float32)
        return labels

    def load_image(self, idx: int) -> np.ndarray:
        return self.boards[idx]

    def load_planes(self, idx: int):
        from chess_vision_tpu_torch.ops.preprocess import rgb_to_ycbcr420

        return rgb_to_ycbcr420(self.boards[idx])


def random_fen(rng) -> str:
    """Both kings, up to 14 other pieces on random squares, a side to move
    and castling rights."""
    squares = ["."] * 64
    where = rng.permutation(64)
    pieces = ["K", "k"] + list(rng.choice(list("PPPPNBRQppppnbrq"),
                                          size=int(rng.integers(2, 15))))
    for sq, piece in zip(where, pieces):
        squares[sq] = piece
    rows = []
    for r in range(8):
        row, gap = "", 0
        for c in squares[8 * r:8 * r + 8]:
            if c == ".":
                gap += 1
                continue
            row += (str(gap) if gap else "") + c
            gap = 0
        rows.append(row + (str(gap) if gap else ""))
    rights = "".join(c for c in "KQkq" if rng.random() < 0.5) or "-"
    return f"{'/'.join(rows)} {'wb'[int(rng.integers(2))]} {rights} - 0 1"


def train_config(save_dir: str, **model_overrides) -> dict:
    """The values of ``configs/vit.yaml`` written out (no pretrained weights,
    no OOD set), for the in-memory corpus: 256 train boards, 64 held out."""
    model = {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
             "pretrained": False, "freeze_backbone": False, "input_size": SIZE,
             "head_dropout": 0.1, "drop_path_rate": 0.1, "embed_dim": 768,
             "depth": 12, "num_heads": 12, "mlp_ratio": 4.0}
    model.update(model_overrides)
    return {
        "data": {"val_split": 0.2, "num_workers": 4, "max_samples": None},
        "model": model,
        "training": {"epochs": 2, "batch_size": TRAIN_BATCH, "lr": 1.0e-4,
                     "weight_decay": 0.01, "grad_clip_norm": 1.0,
                     "mixed_precision": True, "label_smoothing": 0.1,
                     "use_class_weights": True, "turn_loss_weight": 1.0,
                     "castling_loss_weight": 1.0},
        "scheduler": {"type": "cosine", "warmup_epochs": 1},
        "checkpointing": {"save_dir": save_dir, "save_best": True,
                          "early_stopping_patience": 3},
        "logging": {"tensorboard_dir": save_dir + "/runs"},
    }


@contextmanager
def plain_attention():
    """Route the model's attention, forward and backward, through the plain
    PyTorch versions on the card."""
    from chess_vision_tpu_torch.ops import attention as attn_ops

    with mock.patch.object(attn_ops, "fused_qkv_attention_fwd",
                           attn_ops.reference_attention), \
            mock.patch.object(attn_ops, "fused_qkv_attention_bwd",
                              attn_ops.reference_attention_bwd):
        yield


def attention_counts() -> tuple[int, int]:
    from chess_vision_tpu_torch.ops import attention as attn_ops

    return attn_ops.LAUNCHES, attn_ops.BWD_LAUNCHES


def make_trainer(cfg: dict, corpus, seed: int, steps_per_epoch: int = 4):
    """A fresh model, train state and steps from ``cfg``, with the pieces the
    trainer's ``train`` uses, and device batches of the corpus."""
    import torch

    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.train.loop import BatchStager, make_steps
    from chess_vision_tpu_torch.train.state import (
        compute_class_weights,
        create_train_state,
    )

    dev = torch.device("cuda")
    model = init_weights(build_model(cfg), seed=seed).to(dev)
    state = create_train_state(cfg, model, steps_per_epoch)
    data_cfg = get_data_config(cfg["model"]["name"])
    train_step, eval_step = make_steps(
        state, cfg, compute_class_weights(corpus.samples), data_cfg["mean"],
        data_cfg["std"], seed=seed)
    loader = BatchLoader(corpus, np.arange(len(corpus)), TRAIN_BATCH,
                         num_workers=4, drop_remainder=True)
    stager = BatchStager(dev, slots=len(loader))
    batches = [stager(b) for b in loader]
    return state, train_step, eval_step, batches


def train_path_phase(args, kernels: dict, kind: str, smi: str) -> None:
    """Phase 11: the training path at full width."""
    import copy
    import shutil
    import tempfile

    import torch

    from chess_vision_tpu_torch.augment import draw_params
    from chess_vision_tpu_torch.models import resolve_remat
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.train.__main__ import train
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    dev = torch.device("cuda")
    depth = 12
    corpus = MemoryCorpus(320, args.seed)
    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    print(f"[11 train] resolve_remat(batch {TRAIN_BATCH}) on {total_gib:.1f} GiB "
          f"-> {resolve_remat(TRAIN_BATCH, dev)}; it turns to full remat at "
          f"batch {next(b for b in range(64, 1 << 16, 64) if resolve_remat(b, dev))}",
          flush=True)

    # the main path: the function the CLI calls, 2 epochs of 4 steps
    save_dir = tempfile.mkdtemp(prefix="cvt_smoke_")
    per_step = []

    def on_step(step_kind, sums):
        per_step.append((step_kind, *attention_counts(),
                         sums.get("step_loss", sums["loss_sum"])))
        attn_ops.LAUNCHES = attn_ops.BWD_LAUNCHES = 0

    try:
        cfg = train_config(save_dir)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(cfg, corpus, seed=args.seed, device="cuda",
                       on_step=on_step)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ckpt = load_checkpoint(save_dir + "/latest.ckpt")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    history = result["history"]
    losses = torch.stack([s[3] for s in per_step if s[0] == "train"]).tolist()
    launches = {"train": sorted({s[1:3] for s in per_step if s[0] == "train"}),
                "eval": sorted({s[1:3] for s in per_step if s[0] == "eval"})}
    n_train = sum(s[0] == "train" for s in per_step)
    n_eval = sum(s[0] == "eval" for s in per_step)
    print(f"[11 train] ViT-B/16 {SIZE}px bf16 full width, batch {TRAIN_BATCH}, "
          f"remat {cfg['model']['remat']}: {n_train} train steps and {n_eval} "
          f"eval steps in {train_s:.1f} s; (K2, K3) launches per step "
          f"{launches}; step losses {[round(x, 4) for x in losses]}; epoch "
          f"train losses {[h['train']['loss'] for h in history]}, val "
          f"{[h['val']['loss'] for h in history]}; train img/s by epoch "
          f"{[round(h['train_img_per_s'], 1) for h in history]} (loader and "
          f"first-step warm-up included); peak device memory {peak_gib:.2f} "
          f"GiB", flush=True)
    require(n_train == 8 and n_eval == 2, f"{n_train} train, {n_eval} eval steps")
    require(launches == {"train": [(depth, depth)], "eval": [(depth, 0)]},
            f"attention launches per step {launches}")
    require(all(math.isfinite(x) for x in losses), f"step losses {losses}")
    require(all(math.isfinite(h["val"]["loss"]) for h in history), "val loss")
    require(history[-1]["train"]["loss"] < history[0]["train"]["loss"],
            "the mean train loss did not fall")
    kernels["fused_qkv_attention"]["train_launches"] = depth * (n_train + n_eval)
    kernels["fused_qkv_attention_bwd"]["launches"] = depth * n_train
    require(ckpt["step"] == n_train and ckpt["epoch"] == 1
            and ckpt["params"]["backbone"]["block11"]["mlp"]["fc1"]["kernel"].shape
            == (768, 3072)
            and ckpt["opt_state"]["1"]["0"]["mu"]["type_head"]["kernel"].shape
            == (768, 7), "the checkpoint read back")
    print(f"[11 train] latest.ckpt written with msgpack and read back: step "
          f"{ckpt['step']}, epoch {ckpt['epoch']}", flush=True)
    del result, ckpt

    # one remat step: the forward of every block runs again in the backward
    state, train_step, _, batches = make_trainer(
        train_config("", remat=True), corpus, args.seed)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    train_step(batches[0])
    torch.cuda.synchronize()
    remat_counts = attention_counts()
    remat_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[11 train] one step with remat: (K2, K3) launches {remat_counts}, "
          f"peak device memory {remat_peak:.2f} GiB", flush=True)
    require(remat_counts == (2 * depth, depth), f"remat launches {remat_counts}")
    del state, train_step, batches
    torch.cuda.empty_cache()

    # kernel path vs plain path: one step from the same state, dropout and
    # drop path off, the same augmentation draws
    quiet = train_config("", head_dropout=0.0, drop_path_rate=0.0, remat=False)
    quiet["scheduler"]["warmup_epochs"] = 0  # lr(0) is the base rate
    state_k, step_k, _, batches = make_trainer(quiet, corpus, args.seed)
    state_p, step_p, _, _ = make_trainer(quiet, corpus, args.seed)
    before = {n: p.detach().clone() for n, p in state_k.model.named_parameters()}
    aug = draw_params(TRAIN_BATCH, torch.Generator(device=dev).manual_seed(args.seed))
    grads_k, loss_k = step_with_grads(state_k, step_k, batches[0], aug)
    with plain_attention():
        counts = attention_counts()
        grads_p, loss_p = step_with_grads(state_p, step_p, batches[0], aug)
        require(attention_counts() == counts, "the plain step launched a kernel")
    rel = {n: ((grads_k[n] - grads_p[n]).abs().max()
               / grads_p[n].abs().max().clamp_min(1e-30)).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    moved = sum(bool((p != before[n]).any())
                for n, p in state_k.model.named_parameters())
    print(f"[11 train] one step, kernels vs plain attention on the card: loss "
          f"{loss_k} vs {loss_p} (atol {TRAIN_LOSS_ATOL}); per-tensor max "
          f"|grad diff| / max |grad|: worst {rel[worst]:.4f} at {worst}, "
          f"median {float(np.median(list(rel.values()))):.4f} (bound "
          f"{TRAIN_GRAD_RTOL}); {moved} of {len(before)} parameter tensors "
          f"changed", flush=True)
    require(math.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
            f"losses {loss_k} vs {loss_p}")
    require(all(torch.isfinite(g).all() for g in grads_k.values()),
            "a kernel-path gradient is not finite")
    require(rel[worst] <= TRAIN_GRAD_RTOL, f"gradient of {worst}: {rel[worst]}")
    require(moved == len(before), f"only {moved} of {len(before)} tensors changed")
    del grads_k, grads_p, before, state_k, state_p, step_k, step_p
    torch.cuda.empty_cache()

    # throughput of the step alone (batches already on the card), and peak
    # memory without remat
    def steps_per_s(step, n=6):
        step(batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    noisy = train_config("", remat=False)
    state_k, step_k, _, _ = make_trainer(noisy, corpus, args.seed)
    rates = {"kernel": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    rates["kernel"].append(steps_per_s(step_k) * TRAIN_BATCH)
    noremat_peak = torch.cuda.max_memory_allocated() / 2**30
    with plain_attention():  # the same state: only the ops differ
        rates["plain"].append(steps_per_s(step_k) * TRAIN_BATCH)
        rates["plain"].append(steps_per_s(step_k) * TRAIN_BATCH)
    rates["kernel"].append(steps_per_s(step_k) * TRAIN_BATCH)
    print(f"[11 train] train step img/s at batch {TRAIN_BATCH}, dropout and "
          f"drop path on, no remat, 6 steps per run on batches already on the "
          f"card (kernel, plain, plain, kernel): kernel {rates['kernel']}, "
          f"plain {rates['plain']}; peak device memory of the kernel path "
          f"{noremat_peak:.2f} GiB (remat: {remat_peak:.2f}); {kind}, {smi}",
          flush=True)
    if args.profile_train:
        profile_train_steps(step_k, batches, args.profile_train,
                            TRAIN_BATCH / rates["kernel"][-1] * 1e3)


def step_with_grads(state, train_step, batch, aug):
    """One train step; returns the gradients it applied and its loss."""
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in zip(state.names, state.params)})
        return apply()

    state.apply_gradients = capture
    try:
        sums = train_step(batch, aug)
    finally:
        del state.apply_gradients  # the class's method again, no cycle
    return grads, sums["step_loss"].item()


def profile_train_steps(train_step, batches, steps: int, step_ms: float) -> None:
    """``torch.profiler`` over warm train steps: kernels by device time, and
    the device's idle share of an unprofiled step of ``step_ms``; the
    augmentation alone, by CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chess_vision_tpu_torch.augment import draw_params, preprocess_train_batch

    aug = draw_params(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(0))
    half = (0.5, 0.5, 0.5)
    aug_ms = cuda_ms(
        lambda: preprocess_train_batch(batches[0], aug, half, half), 5)
    train_step(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3 / steps
    print(f"[11 train] profile of {steps} train steps: device {device_ms:.2f} ms "
          f"per step; a step takes {step_ms:.2f} ms unprofiled (idle share "
          f"{1 - device_ms / step_ms:.3f}) and {wall_ms:.1f} ms under the "
          f"profiler; augmentation + normalize alone {aug_ms:.3f} ms",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=45,
                       max_name_column_width=60), flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase's failure: report it, exit non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        sys.exit(1)
