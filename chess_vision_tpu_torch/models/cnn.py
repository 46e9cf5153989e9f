"""ChessCNN: stride-32 ConvNeXtV2-Tiny with per-square heads
(``chess_vision_tpu/models/cnn.py``).

256 px in -> the native 8x8 feature map (adaptively pooled to 8x8 at other
sizes); the per-square type and color heads are 1x1 convolutions, written as
Linear over the NHWC channels; turn and castling read the globally averaged
features. Heads are ``Sequential(Dropout, Linear)`` as in ``vit.py``: in
train mode one dropout mask is drawn for the 8x8 map (shared by the type and
color heads) and one for the pooled features (shared by turn and castling),
as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from chess_vision_tpu_torch.fen import NUM_PIECE_COLORS, NUM_PIECE_TYPES
from chess_vision_tpu_torch.models.common import combine_type_color, head
from chess_vision_tpu_torch.models.convnext import ConvNeXtV2Backbone
from chess_vision_tpu_torch.models.layers import (
    adaptive_avg_pool_nhwc,
    cast_weights,
    global_avg_pool_nhwc,
    linear,
)


class ChessCNN(nn.Module):
    def __init__(self, head_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ConvNeXtV2Backbone(drop_path_rate=drop_path_rate)
        C = self.backbone.num_features
        self.type_head = head(C, NUM_PIECE_TYPES, head_dropout)
        self.color_head = head(C, NUM_PIECE_COLORS, head_dropout)
        self.turn_head = head(C, 1, head_dropout)
        self.castling_head = head(C, 4, head_dropout)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized images -> {"squares" (B, 832),
        "turn" (B, 1), "castling" (B, 4)}, all f32."""
        features = self.backbone(x.to(self.dtype))  # (B, H/32, W/32, C)
        B = features.shape[0]
        spatial = self.type_head[0](adaptive_avg_pool_nhwc(features, (8, 8)))
        squares = combine_type_color(linear(spatial, self.type_head[1]),
                                     linear(spatial, self.color_head[1]))
        pooled = self.turn_head[0](global_avg_pool_nhwc(features))
        return {
            "squares": squares.reshape(B, -1).float(),
            "turn": linear(pooled, self.turn_head[1]).float(),
            "castling": linear(pooled, self.castling_head[1]).float(),
        }

    cast_weights = cast_weights
