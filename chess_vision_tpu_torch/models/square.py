"""ChessSquareCNN: a per-square MobileNetV4 classifier over overlapping crops
(``chess_vision_tpu/models/square.py``).

64 crops of 1.5 squares per board (``ops.square_crop.crop_squares``, in the
input's dtype), one shared MobileNetV4-small backbone with pinned BatchNorm
statistics unless ``pin_backbone_bn`` is off, per-square type and color heads
on the pooled features, and turn and castling from an MLP
(``global_head``: Dropout, Linear to 64, ReLU, Dropout) over the 64
squares' features concatenated, with the 64x3 crop means appended when
``turn_color_stats`` is on. In train mode dropout draws one mask for the
per-square features (shared by the type and color heads), one before the
MLP and one after it (shared by turn and castling), as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chess_vision_tpu_torch.fen import NUM_PIECE_COLORS, NUM_PIECE_TYPES
from chess_vision_tpu_torch.models.common import combine_type_color, head
from chess_vision_tpu_torch.models.layers import (
    Dropout,
    cast_weights,
    global_avg_pool_nhwc,
    linear,
)
from chess_vision_tpu_torch.models.mobilenet import MobileNetV4Backbone
from chess_vision_tpu_torch.ops.square_crop import crop_squares


class ChessSquareCNN(nn.Module):
    def __init__(self, square_overlap: float = 1.5, square_input_size: int = 64,
                 head_dropout: float = 0.0, pin_backbone_bn: bool = True,
                 turn_color_stats: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.square_overlap = square_overlap
        self.square_input_size = square_input_size
        self.turn_color_stats = turn_color_stats
        self.backbone = MobileNetV4Backbone(trainable_bn=not pin_backbone_bn,
                                            dtype=dtype)
        width = self.backbone.num_features
        self.type_head = head(width, NUM_PIECE_TYPES, head_dropout)
        self.color_head = head(width, NUM_PIECE_COLORS, head_dropout)
        extra = 64 * 3 if turn_color_stats else 0
        self.global_head = nn.Sequential(
            Dropout(head_dropout), nn.Linear(64 * width + extra, 64), nn.ReLU(),
            Dropout(head_dropout))
        self.turn_head = head(64, 1, 0.0)
        self.castling_head = head(64, 4, 0.0)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, H, 3) normalized images -> {"squares" (B, 832),
        "turn" (B, 1), "castling" (B, 4)}, all f32."""
        B = x.shape[0]
        crops = crop_squares(x, self.square_overlap, self.square_input_size)
        color_stats = crops.mean(dim=(2, 3)) if self.turn_color_stats else None
        crops = crops.reshape((B * 64,) + crops.shape[2:])
        features = global_avg_pool_nhwc(self.backbone(crops))  # (B*64, F)

        dropped = self.type_head[0](features)
        squares = combine_type_color(linear(dropped, self.type_head[1]),
                                     linear(dropped, self.color_head[1]))
        global_feat = features.reshape(B, -1)
        if color_stats is not None:
            global_feat = torch.cat(
                [global_feat, color_stats.reshape(B, -1).to(global_feat.dtype)],
                dim=-1)
        mlp = self.global_head
        global_feat = mlp[3](F.relu(linear(mlp[0](global_feat), mlp[1])))
        return {
            "squares": squares.reshape(B, -1).float(),
            "turn": linear(global_feat, self.turn_head[1]).float(),
            "castling": linear(global_feat, self.castling_head[1]).float(),
        }

    cast_weights = cast_weights
