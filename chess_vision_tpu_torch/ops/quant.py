"""Int8 (W8A8 dynamic) ChessViT serving: pack, forward and calibration.

Counterpart of ``chess_vision_tpu/ops/quant.py`` and its three kernel
layouts, which ``chessvit_int8_apply`` takes as ``layout`` (the JAX package
reads ``CHESS_VISION_INT8_LAYOUT``; here the Predictor reads it, once).
The four large products of each block (qkv, proj, fc1, fc2) run as
int8 x int8 -> int32 with per-output-channel weight scales (quantized once,
``quantize_chessvit``) and per-token activation scales (quantized where the
previous op ends); the residual stream stays bf16; the patch embed and, after
the final LayerNorm in f32, the pool and heads stay bf16 / f32.

``"block"``, the default. Per block (``block_int8``, the JAX ``_block_tpu``):

    qkv = bf16(xq @ wq_qkv)              ops/int8_matmul  scale_bias
    aq, as = attention + requant         ops/attention    fused_qkv_attention_quant
    x, hq, hs = x + proj, LN2, requant   ops/int8_matmul  res_ln_quant
    gq, gs = GELU(fc1), requant          ops/int8_matmul  gelu_quant
    x, xq, xs = x + fc2, next LN1, requant  (last block: x + fc2)

with block 0's LN1 quantized by ``ops/rowquant.fused_rowquant``.

``"flat"`` (``block_int8_flat``, the JAX ``_block_tpu_flat``): the token axis
padded to a multiple of 32 rows and every tensor a flat (B * NP, D) stream;
the same ops on rows, with the attention of
``ops/attention.fused_qkv_attention_quant_flat`` (K5), which masks the
padded keys.

``"fused"``: every block but the last is ONE kernel launch
(``ops/fused_block.fused_vit_block``, K14); the last block, which has no
next LayerNorm to quantize for, runs as ``block_int8``.

Each op launches its CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.

``calibrate_attn_shifts`` measures per-layer fixed softmax shifts on the XLA
form of the block (``_block``), as the JAX package does; its attention runs
as ``fused_qkv_attention`` (the K2 kernel on a CUDA tensor).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from chess_vision_tpu_torch.convert.jax_params import HEADS, int8_pack_from_jax
from chess_vision_tpu_torch.models.common import combine_type_color
from chess_vision_tpu_torch.models.layers import adaptive_avg_pool_nhwc
from chess_vision_tpu_torch.ops import attention as attn_ops
from chess_vision_tpu_torch.ops import fused_block as fused_ops
from chess_vision_tpu_torch.ops import int8_matmul as int8_ops
from chess_vision_tpu_torch.ops import rowquant as rowquant_ops


LAYOUTS = ("block", "flat", "fused")
# The JAX package's other two values of CHESS_VISION_INT8_LAYOUT.
_TPU_ONLY_LAYOUTS = ("xla", "hybrid")
_FLAT_ROWS = 32  # the flat layout pads each image to a multiple of this


def int8_layout() -> str:
    """``CHESS_VISION_INT8_LAYOUT``, the kernel layout of the int8 forward as
    the JAX package selects it: "block" (default), "flat" or "fused". Read
    by the caller once (the Predictor, when it is built) and passed down."""
    return check_layout(os.environ.get("CHESS_VISION_INT8_LAYOUT", "block"))


def check_layout(layout: str) -> str:
    if layout in _TPU_ONLY_LAYOUTS:
        raise ValueError(
            f"int8 layout {layout!r} is not ported: in the JAX package it is "
            "a workaround for a TPU compile helper that rejects the kernel "
            f"programs, and serves no purpose here; use one of {list(LAYOUTS)}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown int8 layout {layout!r}; expected one of "
                         f"{list(LAYOUTS)}")
    return layout


def approx_gelu() -> str:
    """``CHESS_VISION_GELU``, the int8 path's fc1 GELU as the JAX package
    selects it: "sigmoid" (default), "hard" or "erf". Read by the caller
    once (the Predictor, when it is built) and passed down from there."""
    mode = os.environ.get("CHESS_VISION_GELU", "sigmoid")
    if mode not in int8_ops.GELUS:
        raise ValueError(f"CHESS_VISION_GELU={mode!r}; expected one of "
                         f"{list(int8_ops.GELUS)}")
    return mode


def _quant_weight(w) -> tuple[np.ndarray, np.ndarray]:
    """(in, out) f32 -> int8 weights + (out,) f32 per-output-channel scales."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.maximum(scale, 1e-8)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale.astype(np.float32)


def _arrays(tree: dict) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def quantize_chessvit(params: dict, calib=None, num_heads: int = 12,
                      gelu: str = "sigmoid") -> dict:
    """ChessViT params (JAX layout, numpy arrays) -> the int8 pack, in the
    JAX package's format (numpy; ``wq`` is (in, out)).

    calib: optional (B, S, S, 3) normalized images, a tensor (calibration
    runs on its device) or an array; then ``pack["attn_shifts"]`` holds the
    per-layer shifts of ``calibrate_attn_shifts``. Turn the pack into the
    port's tensors with ``convert.jax_params.int8_pack_from_jax``."""
    bb = params["backbone"]
    pack = {
        "patch_embed": _arrays(bb["patch_embed"]),
        "cls_token": np.asarray(bb["cls_token"]),
        "pos_embed": np.asarray(bb["pos_embed"]),
        "norm": _arrays(bb["norm"]),
        "blocks": [],
        "heads": {name: _arrays(params[name]) for name in HEADS},
    }
    i = 0
    while f"block{i}" in bb:
        blk = bb[f"block{i}"]
        q = {"norm1": _arrays(blk["norm1"]), "norm2": _arrays(blk["norm2"])}
        for name, sub in (("qkv", blk["attn"]["qkv"]),
                          ("proj", blk["attn"]["proj"]),
                          ("fc1", blk["mlp"]["fc1"]),
                          ("fc2", blk["mlp"]["fc2"])):
            wq, ws = _quant_weight(sub["kernel"])
            q[name] = {"wq": wq, "scale": ws,
                       "bias": np.asarray(sub["bias"], np.float32)}
        pack["blocks"].append(q)
        i += 1
    if calib is not None:
        calib = torch.as_tensor(calib)
        pack["attn_shifts"] = calibrate_attn_shifts(
            int8_pack_from_jax(pack, calib.device), calib, num_heads, gelu=gelu)
    return pack


def _layernorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    return rowquant_ops.layernorm_f32(x, p["scale"], p["bias"], eps)


def quant_dense(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Per-token dynamic quant of x, int8 product with wq (O, K), f32 out."""
    xf = x.float()
    x_scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    xq = torch.round(xf / x_scale).clamp(-127, 127).to(torch.int8)
    K = xq.shape[-1]
    acc = int8_ops.int8_mm(xq.reshape(-1, K), wq).reshape(*xq.shape[:-1], -1)
    return acc.float() * x_scale * w_scale + bias


def _gelu_xla(h: torch.Tensor, gelu: str) -> torch.Tensor:
    if gelu == "sigmoid":
        return h * torch.sigmoid(1.702 * h)
    if gelu == "hard":
        return h * torch.clamp(0.4255 * h + 0.5, 0.0, 1.0)
    return F.gelu(h)


def _block(x: torch.Tensor, q: dict, num_heads: int = 12,
           gelu: str = "sigmoid") -> torch.Tensor:
    """The JAX package's XLA-form int8 block (the math
    ``calibrate_attn_shifts`` measures). Its attention is
    ``fused_qkv_attention``: the K2 kernel on a CUDA tensor."""
    h = _layernorm(x, q["norm1"])
    qkv = quant_dense(h, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    att = attn_ops.fused_qkv_attention(qkv.to(torch.bfloat16), num_heads)
    x = x + quant_dense(att, q["proj"]["wq"], q["proj"]["scale"],
                        q["proj"]["bias"]).to(torch.bfloat16)
    h = _layernorm(x, q["norm2"])
    h = quant_dense(h, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"])
    h = _gelu_xla(h, gelu)
    return x + quant_dense(h, q["fc2"]["wq"], q["fc2"]["scale"],
                           q["fc2"]["bias"]).to(torch.bfloat16)


def _embed(pack: dict, images: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Patch embed + cls + pos in bf16: (B, S, S, 3) -> ((B, N, D), grid G).

    The 16x16 stride-16 convolution as the per-patch product it equals,
    rounded to bf16 before the bias is added, as the JAX convolution is."""
    pe = pack["patch_embed"]
    P = pe["patch_size"]
    x = images.to(torch.bfloat16)
    B, H, W, C = x.shape
    G = H // P
    patches = x.reshape(B, G, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, G * (W // P), P * P * C)
    x = F.linear(patches, pe["weight"].to(torch.bfloat16))
    x = x + pe["bias"].to(torch.bfloat16)
    D = x.shape[-1]
    cls = pack["cls_token"].to(torch.bfloat16).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + pack["pos_embed"].to(torch.bfloat16)
    return x, G


@torch.inference_mode()
def calibrate_attn_shifts(pack: dict, images, num_heads: int = 12,
                          margin: float = 40.0, guard: float = 80.0,
                          gelu: str = "sigmoid") -> list:
    """Per-layer fixed softmax shifts for the quantizing attention.

    Runs the XLA form of the int8 blocks (``_block``) on the calibration
    images (normalized, (B, S, S, 3)) and records per layer the largest
    attention logit smax and the smallest per-row logit max rmin:
    shift = smax - margin, kept only where rmin >= shift - guard (every row
    keeps a normalizer far above the flush line); else None, the exact row
    max. ``pack`` holds the port's tensors (``int8_pack_from_jax``)."""
    x, _ = _embed(pack, torch.as_tensor(images).to(pack["pos_embed"].device))
    shifts: list = []
    for q in pack["blocks"]:
        h = _layernorm(x, q["norm1"])
        qkv = quant_dense(h, q["qkv"]["wq"], q["qkv"]["scale"],
                          q["qkv"]["bias"])
        B, N, C3 = qkv.shape
        head_dim = C3 // 3 // num_heads
        parts = qkv.reshape(B, N, 3, num_heads, head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", parts[:, :, 0],
                              parts[:, :, 1]) * (1.0 / math.sqrt(head_dim))
        smax = scores.max().item()
        rmin = scores.amax(dim=-1).min().item()
        shift = smax - margin
        shifts.append(shift if rmin >= shift - guard else None)
        x = _block(x, q, num_heads, gelu)
    return shifts


def block_int8(x, xq, xs, q: dict, next_ln: dict | None, num_heads: int = 12,
               softmax_shift: float | None = None, gelu: str = "sigmoid"):
    """One ViT block on the int8 serving path (the JAX ``_block_tpu``).

    x: (B, N, D) bf16 residual stream; xq/xs: this block's LN1 output, already
    quantized. Returns (x', xq', xs') with xq'/xs' quantizing next_ln(x'),
    or (x', None, None) when next_ln is None (the last block)."""
    qkv = int8_ops.int8_matmul_scale_bias(
        xq, xs, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    aq, as_ = attn_ops.fused_qkv_attention_quant(qkv, num_heads, softmax_shift)
    x, hq, hs = int8_ops.int8_matmul_res_ln_quant(
        aq, as_, q["proj"]["wq"], q["proj"]["scale"], q["proj"]["bias"],
        x, q["norm2"]["scale"], q["norm2"]["bias"])
    gq, gs = int8_ops.int8_matmul_gelu_quant(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], gelu=gelu)
    if next_ln is None:
        x = int8_ops.int8_matmul_res(
            gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"], x)
        return x, None, None
    return int8_ops.int8_matmul_res_ln_quant(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"],
        x, next_ln["scale"], next_ln["bias"])


def block_int8_flat(x, xq, xs, q: dict, next_ln: dict | None, images: int,
                    n_real: int, num_heads: int = 12,
                    softmax_shift: float | None = None, gelu: str = "sigmoid"):
    """One ViT block on the flat int8 layout (the JAX ``_block_tpu_flat``).

    As ``block_int8`` with every tensor a flat stream: x (M, D) bf16,
    xq (M, D) int8, xs (M, 1) f32, M = images * NP rows of which the first
    n_real of each image are tokens. The GEMMs and row passes are row-local;
    only the attention knows of images, and masks the padded keys. A padded
    row carries values of its own through the block; nothing reads them."""
    qkv = int8_ops.int8_matmul_scale_bias(
        xq, xs, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    aq, as_ = attn_ops.fused_qkv_attention_quant_flat(
        qkv, images, n_real, num_heads, softmax_shift)
    x, hq, hs = int8_ops.int8_matmul_res_ln_quant(
        aq, as_, q["proj"]["wq"], q["proj"]["scale"], q["proj"]["bias"],
        x, q["norm2"]["scale"], q["norm2"]["bias"])
    gq, gs = int8_ops.int8_matmul_gelu_quant(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], gelu=gelu)
    if next_ln is None:
        x = int8_ops.int8_matmul_res(
            gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"], x)
        return x, None, None
    return int8_ops.int8_matmul_res_ln_quant(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"],
        x, next_ln["scale"], next_ln["bias"])


def _blocks_flat(x, blocks, shifts, num_heads, gelu):
    """The block stack on the flat layout: (B, N, D) -> (B, N, D)."""
    B, N, D = x.shape
    NP = -(-N // _FLAT_ROWS) * _FLAT_ROWS
    x = F.pad(x, (0, 0, 0, NP - N)).reshape(B * NP, D)
    xq, xs = rowquant_ops.fused_rowquant(
        x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
    for i, q in enumerate(blocks):
        nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
        x, xq, xs = block_int8_flat(x, xq, xs, q, nxt, B, N, num_heads,
                                    shifts[i], gelu)
    return x.reshape(B, NP, D)[:, :N]


def _blocks_fused(x, blocks, shifts, num_heads, gelu):
    """The block stack on the fused layout: one launch per block for all but
    the last, which has no next LayerNorm and runs on the split kernels."""
    xq, xs = rowquant_ops.fused_rowquant(
        x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
    if len(blocks) > 1:
        x, xq, xs = fused_ops.fused_vit_stack(
            xq, xs, x, blocks[:-1], [b["norm1"] for b in blocks[1:]],
            shifts[:-1], num_heads, gelu=gelu)
    x, _, _ = block_int8(x, xq, xs, blocks[-1], None, num_heads, shifts[-1],
                         gelu)
    return x


def chessvit_int8_apply(pack: dict, images: torch.Tensor, attn_shifts=None,
                        gelu: str = "sigmoid", num_heads: int = 12,
                        layout: str = "block") -> dict:
    """images: (B, S, S, 3) normalized -> {"squares" (B, 832), "turn" (B, 1),
    "castling" (B, 4)}, f32, as ``ChessViT.forward``.

    pack: the port's tensors (``int8_pack_from_jax``); attn_shifts: per-layer
    calibrated softmax shifts (floats or None); gelu: the fc1 GELU
    ("sigmoid", "hard" or "erf"); layout: "block", "flat" or "fused" (see
    the module docstring)."""
    check_layout(layout)
    x, G = _embed(pack, images)
    B, _, D = x.shape
    blocks = pack["blocks"]
    shifts = attn_shifts or [None] * len(blocks)
    if layout == "flat":
        x = _blocks_flat(x, blocks, shifts, num_heads, gelu)
    elif layout == "fused":
        x = _blocks_fused(x, blocks, shifts, num_heads, gelu)
    else:
        xq, xs = rowquant_ops.fused_rowquant(
            x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
        for i, q in enumerate(blocks):
            nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
            x, xq, xs = block_int8(x, xq, xs, q, nxt, num_heads, shifts[i],
                                   gelu)

    # final LayerNorm, pool and heads in f32 (not cast back to bf16)
    x = _layernorm(x, pack["norm"])
    cls_token = x[:, 0]
    pooled = adaptive_avg_pool_nhwc(x[:, 1:].reshape(B, G, G, D), (8, 8))
    heads = pack["heads"]

    def dense(t, p):
        return t @ p["kernel"].float() + p["bias"]

    squares = combine_type_color(dense(pooled, heads["type_head"]),
                                 dense(pooled, heads["color_head"]))
    return {
        "squares": squares.reshape(B, -1).float(),
        "turn": dense(cls_token, heads["turn_head"]).float(),
        "castling": dense(cls_token, heads["castling_head"]).float(),
    }
