"""Model dispatcher (``chess_vision_tpu/models/__init__.py``).

``build_model(cfg)`` builds the ViT; the CNN and square archs are not ported
yet (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import torch

from chess_vision_tpu_torch.models.vit import ChessViT

ARCHS = ("vit", "cnn", "square")


def compute_dtype(cfg: dict) -> torch.dtype:
    """bf16 unless training.mixed_precision is false, as in the JAX package."""
    mixed = cfg.get("training", {}).get("mixed_precision", True)
    return torch.bfloat16 if mixed else torch.float32


def build_model(cfg: dict) -> ChessViT:
    """Build a chess recognition model from a full config dict (eval mode)."""
    model_cfg = cfg["model"]
    arch = model_cfg.get("arch", "vit")
    if arch == "vit":
        return ChessViT(
            img_size=model_cfg.get("input_size") or 224,
            head_dropout=model_cfg.get("head_dropout", 0.0),
            dtype=compute_dtype(cfg),
            embed_dim=model_cfg.get("embed_dim", 768),
            depth=model_cfg.get("depth", 12),
            num_heads=model_cfg.get("num_heads", 12),
            mlp_ratio=model_cfg.get("mlp_ratio", 4.0),
        ).eval()
    if arch in ("cnn", "square"):
        raise NotImplementedError(
            f"arch={arch!r} is not ported to PyTorch yet (ROADMAP Queue A "
            "item 10, CNN and square archs)")
    raise ValueError(f"Unknown architecture: {arch!r} (expected one of {ARCHS})")
