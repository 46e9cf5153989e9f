"""MobileNetV4-Conv-Small at 0.5 width (``chess_vision_tpu/models/mobilenet.py``;
the structure of timm's mobilenetv4_conv_small_050.e3000_r224_in1k).

ConvBN blocks and Universal Inverted Bottlenecks (optional leading depthwise
conv -> 1x1 expand -> optional mid depthwise conv -> 1x1 project), ReLU, no
squeeze-excite; channels of timm's conv_small scaled by 0.5 and rounded to
multiples of 8, so ``num_features`` is 480. NHWC throughout.

BatchNorm (``layers.BatchNorm``, flax's semantics) is pinned to its running
statistics unless the backbone is built with ``trainable_bn``; then
``module.train()`` normalizes with the batch's and updates the running ones.

Module names are timm's (``conv_stem``/``bn1``, ``blocks.{s}.{b}.conv`` and
``.bn1`` for a ConvBN block, ``blocks.{s}.{b}.dw_start.conv``/``.bn``,
``pw_exp``, ``dw_mid``, ``pw_proj``, ``conv_head``), so the state_dict is
what ``chess_vision_tpu/convert/timm_convert.py`` reads. ``conv_head`` (a
1x1 convolution with bias over the pooled features, timm's classifier
embedding) holds parameters that the square model never uses; they are kept
for the parameter count and the weight bridge, and its output is not
computed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chess_vision_tpu_torch.models.layers import BatchNorm, conv2d


def _round_channels(c: float, divisor: int = 8) -> int:
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:  # timm's make_divisible round-up guard
        new_c += divisor
    return new_c


class ConvBnAct(nn.Module):
    """Convolution (no bias, padding kernel // 2) -> BatchNorm -> optional
    ReLU. ``bn_name`` is timm's name of the norm: ``bn`` inside a UIB block,
    ``bn1`` in a ConvBN block."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, bn_name: str = "bn"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn_name = bn_name
        self.add_module(bn_name, BatchNorm(out_ch))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, self.bn_name)(conv2d(x, self.conv))
        return F.relu(x) if self.act else x


class UniversalInvertedResidual(nn.Module):
    """MobileNetV4 UIB block: dw_start (kernel a, no act) -> 1x1 expand
    (+act) -> dw_mid (kernel k, +act) -> 1x1 project (no act). The stride
    lives on dw_mid when present, else on dw_start; a residual when the
    stride is 1 and the width does not change."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float,
                 dw_start: int = 0, dw_mid: int = 0, stride: int = 1):
        super().__init__()
        mid = _round_channels(in_ch * expand_ratio)
        if dw_start:
            self.dw_start = ConvBnAct(in_ch, in_ch, dw_start,
                                      1 if dw_mid else stride, groups=in_ch,
                                      act=False)
        self.pw_exp = ConvBnAct(in_ch, mid, 1)
        if dw_mid:
            self.dw_mid = ConvBnAct(mid, mid, dw_mid, stride, groups=mid)
        self.pw_proj = ConvBnAct(mid, out_ch, 1, act=False)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "dw_start"):
            x = self.dw_start(x)
        x = self.pw_exp(x)
        if hasattr(self, "dw_mid"):
            x = self.dw_mid(x)
        x = self.pw_proj(x)
        return x + shortcut if self.residual else x


# timm mobilenetv4 'conv_small', channels at 1.0x width:
#   ("cn", kernel, stride, out_ch)
#   ("uir", dw_start, dw_mid, stride, expand, out_ch)
_CONV_SMALL_ARCH = [
    [("cn", 3, 2, 32), ("cn", 1, 1, 32)],
    [("cn", 3, 2, 96), ("cn", 1, 1, 64)],
    [
        ("uir", 5, 5, 2, 3.0, 96),
        ("uir", 0, 3, 1, 2.0, 96),
        ("uir", 0, 3, 1, 2.0, 96),
        ("uir", 0, 3, 1, 2.0, 96),
        ("uir", 0, 3, 1, 2.0, 96),
        ("uir", 3, 0, 1, 4.0, 96),
    ],
    [
        ("uir", 3, 3, 2, 6.0, 128),
        ("uir", 5, 5, 1, 4.0, 128),
        ("uir", 0, 5, 1, 4.0, 128),
        ("uir", 0, 5, 1, 3.0, 128),
        ("uir", 0, 3, 1, 4.0, 128),
        ("uir", 0, 3, 1, 4.0, 128),
    ],
    [("cn", 1, 1, 960)],
]


class MobileNetV4Backbone(nn.Module):
    def __init__(self, width_mult: float = 0.5, stem_size: int = 32,
                 trainable_bn: bool = False, head_hidden_size: int = 1280,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        w = width_mult
        ch = _round_channels(stem_size * w)
        self.conv_stem = nn.Conv2d(3, ch, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(ch)
        self.blocks = nn.ModuleList()
        for stage in _CONV_SMALL_ARCH:
            blocks = nn.ModuleList()
            for blk in stage:
                if blk[0] == "cn":
                    _, k, s, c = blk
                    out = _round_channels(c * w)
                    blocks.append(ConvBnAct(ch, out, k, s, bn_name="bn1"))
                else:
                    _, a, m, s, e, c = blk
                    out = _round_channels(c * w)
                    blocks.append(UniversalInvertedResidual(ch, out, e, a, m, s))
                ch = out
            self.blocks.append(blocks)
        self.num_features = ch
        self.conv_head = nn.Conv2d(ch, head_hidden_size, 1)
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.pinned = not trainable_bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) -> (B, H/32, W/32, num_features), the pre-pool
        map, in the backbone's dtype."""
        x = F.relu(self.bn1(conv2d(x.to(self.dtype), self.conv_stem)))
        for stage in self.blocks:
            for block in stage:
                x = block(x)
        return x
