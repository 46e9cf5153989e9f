"""ChessViT: ViT-B/16 with spatial token heads pooled to the 8x8 chess grid
(``chess_vision_tpu/models/vit.py``).

The CLS token feeds the turn and castling heads; patch tokens are reshaped to
the patch grid, adaptively average-pooled to 8x8 and classified per square by
additive type(7)+color(3) heads -> (B, 832) joint logits. Heads are
``Sequential(Dropout, Linear)`` as in the reference model, so their keys read
``type_head.1.weight``. In train mode one dropout mask is drawn for the
pooled tokens (shared by the type and color heads) and one for the CLS token
(shared by turn and castling), as in the JAX model; in eval mode dropout is
the identity.
"""

from __future__ import annotations

import torch
from torch import nn

from chess_vision_tpu_torch.fen import NUM_PIECE_COLORS, NUM_PIECE_TYPES
from chess_vision_tpu_torch.models.common import combine_type_color, head
from chess_vision_tpu_torch.models.layers import (
    adaptive_avg_pool_nhwc,
    cast_weights,
    linear,
)
from chess_vision_tpu_torch.models.vit_backbone import ViTBackbone


class ChessViT(nn.Module):
    def __init__(self, img_size: int = 256, head_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, remat: bool | str = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ViTBackbone(img_size=img_size, embed_dim=embed_dim,
                                    depth=depth, num_heads=num_heads,
                                    mlp_ratio=mlp_ratio,
                                    drop_path_rate=drop_path_rate, remat=remat)
        self.type_head = head(embed_dim, NUM_PIECE_TYPES, head_dropout)
        self.color_head = head(embed_dim, NUM_PIECE_COLORS, head_dropout)
        self.turn_head = head(embed_dim, 1, head_dropout)
        self.castling_head = head(embed_dim, 4, head_dropout)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized images -> {"squares" (B, 832),
        "turn" (B, 1), "castling" (B, 4)}, all f32."""
        features = self.backbone(x.to(self.dtype))  # (B, 1 + G^2, D)
        B, _, D = features.shape
        G = self.backbone.grid_size
        cls_token = features[:, 0]
        pooled = adaptive_avg_pool_nhwc(features[:, 1:].reshape(B, G, G, D), (8, 8))
        pooled = self.type_head[0](pooled)
        cls_token = self.turn_head[0](cls_token)
        squares = combine_type_color(linear(pooled, self.type_head[1]),
                                     linear(pooled, self.color_head[1]))
        return {
            "squares": squares.reshape(B, -1).float(),
            "turn": linear(cls_token, self.turn_head[1]).float(),
            "castling": linear(cls_token, self.castling_head[1]).float(),
        }

    cast_weights = cast_weights
