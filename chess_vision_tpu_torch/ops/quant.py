"""Int8 (W8A8 dynamic) ChessViT serving: pack, forward and calibration.

Counterpart of ``chess_vision_tpu/ops/quant.py`` and its five kernel
layouts, which ``chessvit_int8_apply`` takes as ``layout`` (the JAX package
reads ``CHESS_VISION_INT8_LAYOUT``; here the Predictor reads it, once), and
its serving modes, which it takes as ``modes`` (``Int8Modes``: the JAX
package reads ``CHESS_VISION_ATTN_SOFTMAX``, ``CHESS_VISION_ATTN_QK``,
``CHESS_VISION_ATTN_EXP`` and ``CHESS_VISION_EPILOGUE`` where each kernel is
traced; here the Predictor reads them once, ``int8_modes``).
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
(``ops/fused_block.fused_vit_block``, K14, with the calibrated or the bound
shift, as the JAX kernel); the last block, which has no next LayerNorm to
quantize for, runs as ``block_int8``. As in the JAX package, the layout falls
back to ``"block"`` under the int8 attention legs or the "max" shift.

``"hybrid"`` (``_block_hybrid``): every product ``bf16(y)`` alone
(``int8_matmul_scale_bias``, the JAX ``quant_dense_q``), the residual added
in bf16, the attention ``fused_qkv_attention`` (K2) on the bf16 qkv, and each
dynamic quantization one ``fused_rowquant`` (K7: LayerNorm, none, and the
fc1 GELU's form).

``"xla"``: the XLA-form block ``_block``, whose attention is K2 and whose
quantizations are plain PyTorch (its products ``torch._int_mm``, as the JAX
layout's are XLA's).

The modes (``Int8Modes``), each changing what the JAX kernels compute:
``softmax`` the quantizing attention's shift where no calibrated one is
given ("bound", the default, "fixed" or "max"); ``attn_qk`` its int8 legs
("bf16", "int8": QK^T in int8, "int8pv": P V too); ``attn_exp`` ("bf16":
s - shift rounded to bf16 before the exp); ``epilogue`` K8's ("bf16": the
GELU in bf16). The flat layout's GELU kernel (K11) has no bf16 epilogue, and
K14 none of the attention modes, as in the JAX package; the hybrid and xla
layouts take none of them.

Each op launches its CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.

``calibrate_attn_shifts`` measures per-layer fixed softmax shifts on the XLA
form of the block (``_block``), as the JAX package does; its attention runs
as ``fused_qkv_attention`` (the K2 kernel on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
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


LAYOUTS = ("block", "flat", "fused", "hybrid", "xla")
_FLAT_ROWS = 32  # the flat layout pads each image to a multiple of this


def int8_layout() -> str:
    """``CHESS_VISION_INT8_LAYOUT``, the kernel layout of the int8 forward as
    the JAX package selects it: "block" (default), "flat", "fused", "hybrid"
    or "xla". Read by the caller once (the Predictor, when it is built) and
    passed down."""
    return check_layout(os.environ.get("CHESS_VISION_INT8_LAYOUT", "block"))


def check_layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown int8 layout {layout!r}; expected one of "
                         f"{list(LAYOUTS)}")
    return layout


SOFTMAX_SHIFTS = tuple(attn_ops.SHIFT_MODES)
ATTN_QKS = ("bf16", "int8", "int8pv")
ATTN_EXPS = ("f32", "bf16")
EPILOGUES = ("f32", "bf16")
# Int8Modes' fields: the variable each is read from, and its values
_MODE_VARS = {"softmax": ("CHESS_VISION_ATTN_SOFTMAX", SOFTMAX_SHIFTS),
              "attn_qk": ("CHESS_VISION_ATTN_QK", ATTN_QKS),
              "attn_exp": ("CHESS_VISION_ATTN_EXP", ATTN_EXPS),
              "epilogue": ("CHESS_VISION_EPILOGUE", EPILOGUES)}


@dataclasses.dataclass(frozen=True)
class Int8Modes:
    """The int8 path's serving modes (module docstring); the defaults are
    the JAX package's."""
    softmax: str = "bound"
    attn_qk: str = "bf16"
    attn_exp: str = "f32"
    epilogue: str = "f32"

    def __post_init__(self):
        for field, (var, choices) in _MODE_VARS.items():
            value = getattr(self, field)
            if value not in choices:
                raise ValueError(f"{field} ({var}) {value!r}; expected one "
                                 f"of {list(choices)}")

    def attention(self) -> tuple:
        """The quantizing attention's arguments after ``softmax_shift``
        (``ops/attention.py``): shift_mode, qk_int8, pv_int8, exp_bf16."""
        return (self.softmax, self.attn_qk in ("int8", "int8pv"),
                self.attn_qk == "int8pv", self.attn_exp == "bf16")

    def fused_ok(self) -> bool:
        """Whether the fused layout runs as such; the JAX package falls back
        to the block layout under the int8 legs or the "max" shift."""
        return self.attn_qk == "bf16" and self.softmax != "max"


def int8_modes() -> Int8Modes:
    """The four mode variables (``_MODE_VARS``: ``CHESS_VISION_ATTN_SOFTMAX``
    "bound", the default, "fixed" or "max"; ``CHESS_VISION_ATTN_QK`` "bf16",
    "int8" or "int8pv"; ``CHESS_VISION_ATTN_EXP`` and ``CHESS_VISION_EPILOGUE``
    "f32" or "bf16"), read once by the caller (the Predictor, when it is
    built); an unknown value raises, naming its variable."""
    return Int8Modes(**{field: os.environ[var]
                        for field, (var, _) in _MODE_VARS.items()
                        if var in os.environ})


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


_GELU_ROWQUANT = {"sigmoid": "gelu_sigmoid", "hard": "gelu_hard",
                  "erf": "gelu"}  # the JAX _gelu_rowquant_mode


def quant_dense_q(xq, xs, p: dict) -> torch.Tensor:
    """The JAX ``quant_dense_q``: pre-quantized rows, int8 product, bf16(y)."""
    return int8_ops.int8_matmul_scale_bias(xq, xs, p["wq"], p["scale"],
                                           p["bias"])


def _block_hybrid(x: torch.Tensor, q: dict, num_heads: int = 12,
                  gelu: str = "sigmoid") -> torch.Tensor:
    """One ViT block on the hybrid layout (the JAX ``_block_hybrid``): each
    dynamic quantization one ``fused_rowquant`` (K7), each product
    ``quant_dense_q``, the attention K2 on the bf16 qkv, the residual added
    in bf16. (The JAX ``_hybrid_stack`` scans this over stacked weights; its
    tests show the scan bit-equal to the loop the caller runs.)"""
    xq, xs = rowquant_ops.fused_rowquant(x, "ln", q["norm1"]["scale"],
                                         q["norm1"]["bias"])
    qkv = quant_dense_q(xq, xs, q["qkv"])
    att = attn_ops.fused_qkv_attention(qkv, num_heads)
    aq, as_ = rowquant_ops.fused_rowquant(att, "none")
    x = x + quant_dense_q(aq, as_, q["proj"])
    hq, hs = rowquant_ops.fused_rowquant(x, "ln", q["norm2"]["scale"],
                                         q["norm2"]["bias"])
    h = quant_dense_q(hq, hs, q["fc1"])  # bf16, as the JAX layout's
    gq, gs = rowquant_ops.fused_rowquant(h, _GELU_ROWQUANT[gelu])
    return x + quant_dense_q(gq, gs, q["fc2"])


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
    keeps a normalizer far above the flush line); else None, where the layer
    keeps the mode's shift (the bound by default). ``pack`` holds the port's
    tensors (``int8_pack_from_jax``)."""
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


_DEFAULT_MODES = Int8Modes()


def block_int8(x, xq, xs, q: dict, next_ln: dict | None, num_heads: int = 12,
               softmax_shift: float | None = None, gelu: str = "sigmoid",
               modes: Int8Modes = _DEFAULT_MODES):
    """One ViT block on the int8 serving path (the JAX ``_block_tpu``).

    x: (B, N, D) bf16 residual stream; xq/xs: this block's LN1 output, already
    quantized. Returns (x', xq', xs') with xq'/xs' quantizing next_ln(x'),
    or (x', None, None) when next_ln is None (the last block)."""
    qkv = quant_dense_q(xq, xs, q["qkv"])
    aq, as_ = attn_ops.fused_qkv_attention_quant(qkv, num_heads, softmax_shift,
                                                 *modes.attention())
    x, hq, hs = int8_ops.int8_matmul_res_ln_quant(
        aq, as_, q["proj"]["wq"], q["proj"]["scale"], q["proj"]["bias"],
        x, q["norm2"]["scale"], q["norm2"]["bias"])
    gq, gs = int8_ops.int8_matmul_gelu_quant(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], gelu=gelu,
        bf16_epilogue=modes.epilogue == "bf16")
    if next_ln is None:
        x = int8_ops.int8_matmul_res(
            gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"], x)
        return x, None, None
    return int8_ops.int8_matmul_res_ln_quant(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"],
        x, next_ln["scale"], next_ln["bias"])


def block_int8_flat(x, xq, xs, q: dict, next_ln: dict | None, images: int,
                    n_real: int, num_heads: int = 12,
                    softmax_shift: float | None = None, gelu: str = "sigmoid",
                    modes: Int8Modes = _DEFAULT_MODES):
    """One ViT block on the flat int8 layout (the JAX ``_block_tpu_flat``).

    As ``block_int8`` with every tensor a flat stream: x (M, D) bf16,
    xq (M, D) int8, xs (M, 1) f32, M = images * NP rows of which the first
    n_real of each image are tokens. The GEMMs and row passes are row-local;
    only the attention knows of images, and masks the padded keys. A padded
    row carries values of its own through the block; nothing reads them.
    The GELU kernel takes no bf16 epilogue here (the JAX K11 has none)."""
    qkv = quant_dense_q(xq, xs, q["qkv"])
    aq, as_ = attn_ops.fused_qkv_attention_quant_flat(
        qkv, images, n_real, num_heads, softmax_shift, *modes.attention())
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


def _blocks_flat(x, blocks, shifts, num_heads, gelu, modes):
    """The block stack on the flat layout: (B, N, D) -> (B, N, D)."""
    B, N, D = x.shape
    NP = -(-N // _FLAT_ROWS) * _FLAT_ROWS
    x = F.pad(x, (0, 0, 0, NP - N)).reshape(B * NP, D)
    xq, xs = rowquant_ops.fused_rowquant(
        x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
    for i, q in enumerate(blocks):
        nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
        x, xq, xs = block_int8_flat(x, xq, xs, q, nxt, B, N, num_heads,
                                    shifts[i], gelu, modes)
    return x.reshape(B, NP, D)[:, :N]


def _blocks_fused(x, blocks, shifts, num_heads, gelu, modes):
    """The block stack on the fused layout: one launch per block for all but
    the last, which has no next LayerNorm and runs on the split kernels (with
    the modes, as the JAX ``_block_tpu`` there). K14 takes the calibrated
    shift or the bound, whatever ``modes.softmax`` says, as the JAX
    ``fused_vit_block`` does."""
    xq, xs = rowquant_ops.fused_rowquant(
        x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
    if len(blocks) > 1:
        x, xq, xs = fused_ops.fused_vit_stack(
            xq, xs, x, blocks[:-1], [b["norm1"] for b in blocks[1:]],
            shifts[:-1], num_heads, gelu=gelu)
    x, _, _ = block_int8(x, xq, xs, blocks[-1], None, num_heads, shifts[-1],
                         gelu, modes)
    return x


def chessvit_int8_apply(pack: dict, images: torch.Tensor, attn_shifts=None,
                        gelu: str = "sigmoid", num_heads: int = 12,
                        layout: str = "block",
                        modes: Int8Modes = _DEFAULT_MODES) -> dict:
    """images: (B, S, S, 3) normalized -> {"squares" (B, 832), "turn" (B, 1),
    "castling" (B, 4)}, f32, as ``ChessViT.forward``.

    pack: the port's tensors (``int8_pack_from_jax``); attn_shifts: per-layer
    calibrated softmax shifts (floats or None; the hybrid and xla layouts
    take none); gelu: the fc1 GELU ("sigmoid", "hard" or "erf"); layout:
    one of ``LAYOUTS``; modes: ``Int8Modes`` (see the module docstring)."""
    check_layout(layout)
    x, G = _embed(pack, images)
    B, _, D = x.shape
    blocks = pack["blocks"]
    shifts = attn_shifts or [None] * len(blocks)
    if layout == "fused" and not modes.fused_ok():
        layout = "block"
    if layout == "xla":
        for q in blocks:
            x = _block(x, q, num_heads, gelu)
    elif layout == "hybrid":
        for q in blocks:
            x = _block_hybrid(x, q, num_heads, gelu)
    elif layout == "flat":
        x = _blocks_flat(x, blocks, shifts, num_heads, gelu, modes)
    elif layout == "fused":
        x = _blocks_fused(x, blocks, shifts, num_heads, gelu, modes)
    else:
        xq, xs = rowquant_ops.fused_rowquant(
            x, "ln", blocks[0]["norm1"]["scale"], blocks[0]["norm1"]["bias"])
        for i, q in enumerate(blocks):
            nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
            x, xq, xs = block_int8(x, xq, xs, q, nxt, num_heads, shifts[i],
                                   gelu, modes)

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
