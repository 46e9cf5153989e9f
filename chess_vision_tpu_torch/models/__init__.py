"""Model dispatcher (``chess_vision_tpu/models/__init__.py``).

``build_model(cfg)`` builds ``cfg["model"]["arch"]``: "vit" (the default,
``ChessViT``), "cnn" (``ChessCNN``, ConvNeXtV2-Tiny) or "square"
(``ChessSquareCNN``, MobileNetV4 over per-square crops), from the JAX
package's config keys. ``normalize_remat`` / ``resolve_remat`` choose the
ViT trainer's rematerialization, ``init_weights`` draws a fresh model from a
seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from chess_vision_tpu_torch.config import as_bool
from chess_vision_tpu_torch.models.cnn import ChessCNN
from chess_vision_tpu_torch.models.layers import GRN, BatchNorm
from chess_vision_tpu_torch.models.square import ChessSquareCNN
from chess_vision_tpu_torch.models.vit import ChessViT

ARCHS = ("vit", "cnn", "square")

# Device memory model of ``resolve_remat`` for ViT-B/16 at 256 px in bf16,
# bytes. The state: f32 parameters, gradients and two AdamW moments of the
# 86 M-parameter model (1.28 GiB) and the per-use bf16 copies of the weights.
# Per-image activations kept for the backward pass: (peak - state) / 64 from
# ``torch.cuda.max_memory_allocated`` over train steps at batch 64, 6.60 GiB
# without remat (chip_smoke.py train phase; NVIDIA H100 80GB HBM3, 700.00 W).
STATE_BYTES = 1.5 * 2**30
NOREMAT_BYTES_PER_IMAGE = 86e6
HEADROOM_BYTES = 2.0 * 2**30  # cuBLAS workspaces, allocator fragmentation


def normalize_remat(value):
    """Normalize model.remat config values: ``--set model.remat=...`` arrives
    as a raw string. The spellings of true and false map onto the booleans;
    other strings ("auto", "attn_out") pass through in lower case."""
    if isinstance(value, str):
        v = value.lower()
        if v in ("true", "1", "yes", "full"):
            return True
        if v in ("false", "0", "no", "none"):
            return False
        return v
    return value


def resolve_remat(batch: int, device=None, device_bytes: float | None = None):
    """The auto remat policy for ViT-B training: no rematerialization when
    the activations of ``batch`` images fit in the device's memory beside the
    train state, else full remat (recomputing costs a second forward per
    block). ``device_bytes`` defaults to the total memory of ``device``
    (``torch.cuda.get_device_properties``); on the CPU, where there is
    nothing to fit, the answer is False. The JAX package's third choice,
    "attn_out", is not ported."""
    if device_bytes is None:
        device = torch.device("cpu" if device is None else device)
        if device.type != "cuda":
            return False
        device_bytes = float(torch.cuda.get_device_properties(device).total_memory)
    free = device_bytes - STATE_BYTES - HEADROOM_BYTES
    return not NOREMAT_BYTES_PER_IMAGE * batch <= free


def compute_dtype(cfg: dict) -> torch.dtype:
    """bf16 unless training.mixed_precision is false, as in the JAX package."""
    mixed = cfg.get("training", {}).get("mixed_precision", True)
    return torch.bfloat16 if mixed else torch.float32


def build_model(cfg: dict) -> nn.Module:
    """Build a chess recognition model from a full config dict. The model
    comes back in eval mode with PyTorch's default init; a trainer calls
    ``init_weights`` and ``.train()``. ``model.remat`` (ViT only) "auto"
    that no caller resolved means full remat, as in the JAX package."""
    model_cfg = cfg["model"]
    arch = model_cfg.get("arch", "vit")
    dtype = compute_dtype(cfg)
    if arch == "vit":
        remat = normalize_remat(model_cfg.get("remat", "auto"))
        return ChessViT(
            img_size=model_cfg.get("input_size") or 224,
            head_dropout=model_cfg.get("head_dropout", 0.0),
            drop_path_rate=model_cfg.get("drop_path_rate", 0.0),
            remat=True if remat == "auto" else remat,
            dtype=dtype,
            embed_dim=model_cfg.get("embed_dim", 768),
            depth=model_cfg.get("depth", 12),
            num_heads=model_cfg.get("num_heads", 12),
            mlp_ratio=model_cfg.get("mlp_ratio", 4.0),
        ).eval()
    if arch == "cnn":
        return ChessCNN(
            head_dropout=model_cfg.get("head_dropout", 0.0),
            drop_path_rate=model_cfg.get("drop_path_rate", 0.0),
            dtype=dtype,
        ).eval()
    if arch == "square":
        return ChessSquareCNN(
            square_overlap=model_cfg.get("square_overlap", 1.5),
            square_input_size=model_cfg.get("square_input_size", 64),
            head_dropout=model_cfg.get("head_dropout", 0.0),
            pin_backbone_bn=as_bool(model_cfg.get("pin_backbone_bn", True)),
            turn_color_stats=as_bool(model_cfg.get("turn_color_stats", False)),
            dtype=dtype,
        ).eval()
    raise ValueError(f"Unknown architecture: {arch!r} (expected one of {ARCHS})")


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


_TRUNC_STD = 0.87962566  # std of a unit normal truncated at +-2


def _trunc_normal_(tensor: torch.Tensor, std: float, gen: torch.Generator):
    """Normal truncated at two standard deviations and rescaled so that the
    result has standard deviation ``std`` (flax's ``truncated_normal``)."""
    scale = std / _TRUNC_STD
    nn.init.trunc_normal_(tensor, std=scale, a=-2 * scale, b=2 * scale,
                          generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize in place as the JAX package's ``init_variables`` does,
    drawn on the CPU from ``seed``: zero biases; unit LayerNorm scales; GRN
    zeros; BatchNorm scale 1, bias 0, running mean 0 and variance 1; the
    heads' and MobileNet's kernels LeCun-normal (flax's default: truncated
    normal of std 1/sqrt(fan in)); the ViT's and ConvNeXt's other kernels,
    the position embedding truncated-normal(0.02); the CLS token zero."""
    gen = torch.Generator().manual_seed(seed)
    lecun = isinstance(model, ChessSquareCNN)
    for name, module in model.named_modules():
        if isinstance(module, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, GRN):
            nn.init.zeros_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            weight = torch.empty(module.weight.shape)
            if name.startswith("backbone.") and not lecun:
                _trunc_normal_(weight, 0.02, gen)
            else:
                _trunc_normal_(weight, 1.0 / math.sqrt(weight[0].numel()), gen)
            module.weight.copy_(weight)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
    if isinstance(model, ChessViT):
        pos = torch.empty(model.backbone.pos_embed.shape)
        _trunc_normal_(pos, 0.02, gen)
        model.backbone.pos_embed.copy_(pos)
        nn.init.zeros_(model.backbone.cls_token)
    return model
