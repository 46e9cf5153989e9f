#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chess_vision_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0] [--boards 300] [--bench-boards 1024]

Phases, one line each; any failure exits non-zero before the last line:
  1. device  card name, ``nvidia-smi`` name and power limit; TF32 off.
  2. build   nvcc builds ``chess_vision_tpu_torch/csrc/*.cu`` for sm_90a.
  3. K1      preprocess kernel vs its plain version, (256,256,256,3) u8 -> bf16,
             at most 1 bf16 ulp apart.
  4. K2      attention kernel vs ``reference_attention`` at (256,257,2304) bf16
             with 12 heads and at (3,17,96) with 1 head, atol 2e-2.
  5. path    ViT-B/16 at 256 px, full width (embed 768, depth 12, 12 heads),
             bf16, weights drawn from --seed in the JAX layout and carried
             through the weight bridge; ``Predictor.predict_array`` on --boards
             random boards (a padded tail batch) must launch K1 once and K2 12
             times per batch, and agree with the same Predictor running the
             plain ops on the card; boards/s of both at batch 256.
  6. report  the kernels JSON line, the nvidia-smi line, then
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from unittest import mock

import numpy as np

# logits of the kernel path vs the plain path on the card: bf16 rounds at
# other points in the two attentions (the kernel's probabilities are unrounded
# f32 in its row sums), and the differences pass through 12 bf16 blocks; about
# ten bf16 ulps at the random model's logit scale (~0.5)
SQUARES_ATOL = 5e-2
ATTN_ATOL = 2e-2  # the JAX package's bound for its own kernel
BATCH = 256
SIZE = 256


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
    kernels["preprocess_u8"] = {
        "name": "preprocess_u8", "route": "cuda",
        "source": "chess_vision_tpu_torch/csrc/preprocess.cu",
        "replaces": "chess_vision_tpu/ops/preprocess.py:43",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # 4. K2
    for B, N, H, Dh in ((BATCH, SIZE // 16 * SIZE // 16 + 1, 12, 64),
                        (3, 17, 1, 32)):
        qkv = torch.randn((B, N, 3 * H * Dh), device=dev,
                          generator=gen).to(torch.bfloat16)
        out_k = attn_ops.fused_qkv_attention(qkv, H)
        out_p = attn_ops.reference_attention(qkv, H)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        finite = bool(torch.isfinite(out_k).all())
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention(qkv, H), 20)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, H), 5)
        print(f"[4 K2] attention {tuple(qkv.shape)} H={H}: max |diff| {err}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        require(finite and err <= ATTN_ATOL,
                f"K2 at {tuple(qkv.shape)}: max |diff| {err}, finite {finite}")
        if B == BATCH:
            kernels["fused_qkv_attention"] = {
                "name": "fused_qkv_attention", "route": "cuda",
                "source": "chess_vision_tpu_torch/csrc/attention.cu",
                "replaces": "chess_vision_tpu/ops/attention.py:90",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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

    # 6. report
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase's failure: report it, exit non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        sys.exit(1)
