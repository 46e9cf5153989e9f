"""ViT-B/16 backbone (``chess_vision_tpu/models/vit_backbone.py``).

Parameter names are timm's (``patch_embed.proj``, ``blocks.{i}``, ``norm``),
so the state_dict maps one-to-one onto the JAX package's converter. Input is
NHWC, as in the JAX package. The patch embedding, a 16x16 stride-16
convolution, is written as the per-patch linear product it equals: a patch
reshape and one matrix product, with no cuDNN convolution (and so no TF32 in
f32).

Training: stochastic depth grows linearly with depth
(``drop_path_rate * i / (depth - 1)``), and ``remat=True`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, non-reentrant, the
dropout generator's state preserved), so only block inputs are kept: the
trade of FLOPs for device memory that the JAX package makes with
``nn.remat``. ``remat="attn_out"`` is the JAX package's saved-tensor policy
of that name: each block's input and its attention output (B, N, D) are kept,
everything else is recomputed (``TransformerBlock._forward_attn_out``). The
backward recomputes LayerNorm 1 and the qkv product for the attention
backward (K3) and the rest of the block, and never runs the attention
forward (K2) again: 12 K2 launches a ViT-B step, as without remat, against
24 with full remat. (A selective checkpoint policy over the whole block,
which named the attention as an operator to save, did the same but ran
every op of the block through a Python dispatch mode: 842 img/s at batch 64
on the H100, below full remat's 1,226.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chess_vision_tpu_torch.models.layers import (
    Dropout,
    LayerNorm,
    TransformerBlock,
)


class PatchEmbed(nn.Module):
    """Non-overlapping patch projection; ``proj`` holds the OIHW conv weight."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, (H/P)*(W/P), D), patches in row-major order."""
        B, H, W, C = x.shape
        P = self.patch_size
        patches = x.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(B, (H // P) * (W // P), P * P * C)
        # OIHW -> O x (kh, kw, c), the order of the flattened patch
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(patches, w.to(x.dtype), self.proj.bias.to(x.dtype))


REMAT_POLICIES = (False, True, "attn_out")


class ViTBackbone(nn.Module):
    def __init__(self, img_size: int = 256, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, norm_eps: float = 1e-6,
                 dropout: float = 0.0, drop_path_rate: float = 0.0,
                 remat: bool | str = False):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat={remat!r}; expected one of "
                             f"{REMAT_POLICIES}")
        self.remat = remat
        self.grid_size = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid_size * self.grid_size + 1, embed_dim))
        self.pos_drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_ratio, norm_eps,
                             dropout=dropout,
                             drop_path=drop_path_rate * i / max(depth - 1, 1))
            for i in range(depth))
        for block in self.blocks:  # a module call, so FSDP's hooks run
            block.remat_attn_out = remat == "attn_out"
        self.norm = LayerNorm(embed_dim, eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) normalized images -> (B, 1 + grid^2, embed_dim)."""
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype))
        remat = self.remat is True and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.norm(x)
