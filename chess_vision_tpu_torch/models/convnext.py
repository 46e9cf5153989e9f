"""ConvNeXtV2 backbone (``chess_vision_tpu/models/convnext.py``; the
structure of timm's convnextv2_tiny.fcmae_ft_in22k_in1k).

NHWC throughout. Each block: 7x7 depthwise convolution -> LayerNorm -> Linear
4x -> exact GELU -> GRN -> Linear -> residual (with drop path in training).
With a 256 px input the stride-32 trunk yields the 8x8 map of the chess grid.
The trailing ``head.norm`` is the LayerNorm of timm's classifier head, which
the reference applies to the spatial map.

Module names are timm's (``stem.0``/``stem.1``, ``stages.{s}.downsample``,
``stages.{s}.blocks.{j}.conv_dw``, ``.mlp.fc1``, ``.mlp.grn``, ``.mlp.fc2``,
``head.norm``), so the state_dict is what
``chess_vision_tpu/convert/timm_convert.py`` reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chess_vision_tpu_torch.models.layers import (
    GRN,
    DropPath,
    LayerNorm,
    conv2d,
    linear,
)


class GrnMlp(nn.Module):
    """Linear -> exact GELU -> GRN -> Linear, on the channel axis."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.grn = GRN(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.grn(F.gelu(linear(x, self.fc1))), self.fc2)


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, norm_eps: float = 1e-6):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=norm_eps)
        self.mlp = GrnMlp(dim, 4 * dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp(self.norm(conv2d(x, self.conv_dw)))
        return x + self.drop_path(h)


class ConvNeXtV2Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, dp_rates, first: bool,
                 norm_eps: float):
        super().__init__()
        if not first:  # LayerNorm, then a 2x2 stride-2 convolution
            self.downsample = nn.ModuleList([
                LayerNorm(in_dim, eps=norm_eps), nn.Conv2d(in_dim, dim, 2, 2)])
        self.blocks = nn.ModuleList(
            ConvNeXtV2Block(dim, rate, norm_eps) for rate in dp_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "downsample"):
            x = conv2d(self.downsample[0](x), self.downsample[1])
        for block in self.blocks:
            x = block(x)
        return x


class ConvNeXtV2Backbone(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0, norm_eps: float = 1e-6):
        super().__init__()
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.stem = nn.ModuleList([nn.Conv2d(3, dims[0], 4, 4),
                                   LayerNorm(dims[0], eps=norm_eps)])
        self.stages = nn.ModuleList()
        start = 0
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            self.stages.append(ConvNeXtV2Stage(
                dims[max(s - 1, 0)], dim, depth, rates[start:start + depth],
                s == 0, norm_eps))
            start += depth
        self.head = nn.ModuleDict({"norm": LayerNorm(dims[-1], eps=norm_eps)})
        self.num_features = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) -> (B, H/32, W/32, dims[-1]), the normed map."""
        x = self.stem[1](conv2d(x, self.stem[0]))
        for stage in self.stages:
            x = stage(x)
        return self.head["norm"](x)
