"""Shared head math: additive type+color logit combination, and the heads'
``Sequential(Dropout, Linear)`` form (keys ``type_head.1.weight``).

joint[..., c] = type_logits[..., CLASS_TO_TYPE[c]] + color_logits[..., CLASS_TO_COLOR[c]]
(``chess_vision_tpu/models/common.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from chess_vision_tpu_torch.fen import CLASS_TO_COLOR, CLASS_TO_TYPE
from chess_vision_tpu_torch.models.layers import Dropout

_TYPE_INDEX = torch.tensor(CLASS_TO_TYPE)
_COLOR_INDEX = torch.tensor(CLASS_TO_COLOR)


def combine_type_color(type_logits: torch.Tensor,
                       color_logits: torch.Tensor) -> torch.Tensor:
    """(..., 7) type logits + (..., 3) color logits -> (..., 13) joint logits."""
    t = type_logits.index_select(-1, _TYPE_INDEX.to(type_logits.device))
    c = color_logits.index_select(-1, _COLOR_INDEX.to(color_logits.device))
    return t + c


def head(dim: int, out: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(Dropout(dropout), nn.Linear(dim, out))
