"""Plain ChessCNN: ConvNeXtV2-Tiny (Woo et al., arXiv:2301.00808; timm's
``convnextv2_tiny.fcmae_ft_in22k_in1k`` layout) with the chess heads, in
f32, NHWC.

Stem: 4x4 stride-4 convolution, LayerNorm. Stages of depths 3-3-9-3 and
widths 96-192-384-768; stages 1-3 open with LayerNorm and a 2x2 stride-2
convolution. Block: 7x7 depthwise convolution -> LayerNorm -> Linear 4x ->
GELU (exact) -> GRN -> Linear -> residual. GRN (Global Response
Normalization): gx = ||x||_2 over H and W per channel, nx = gx / (mean_c gx
+ 1e-6), out = gamma * (x * nx) + beta + x. The head's LayerNorm acts on the
map; at 256 px the stride-32 map is the 8x8 board. Turn and castling read
the map's mean.

``forward(..., bits=8)`` quantizes each block's two pointwise products
(W8A8, per-token rows and per-output-channel weights, ``common.dense``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmarks.reference import common


def _stage_names(model: dict):
    for s, depth in enumerate(model["depths"]):
        yield s, depth, model["dims"][s]


def param_spec(model: dict) -> list:
    """(path, shape, mean, std) of every parameter: kernels of std
    1/sqrt(fan in), LayerNorm scales 1 + N(0, 0.1), GRN's gamma N(0, 0.1)
    (zero would make GRN the identity), biases N(0, 0.02)."""
    dims = model["dims"]
    spec = [("backbone/stem_conv/kernel", (4, 4, 3, dims[0]), 0.0, 48 ** -0.5),
            ("backbone/stem_conv/bias", (dims[0],), 0.0, 0.02),
            ("backbone/stem_norm/scale", (dims[0],), 1.0, 0.1),
            ("backbone/stem_norm/bias", (dims[0],), 0.0, 0.02)]
    for s, depth, dim in _stage_names(model):
        if s:
            prev = dims[s - 1]
            spec += [(f"backbone/downsample{s}_norm/scale", (prev,), 1.0, 0.1),
                     (f"backbone/downsample{s}_norm/bias", (prev,), 0.0, 0.02),
                     (f"backbone/downsample{s}_conv/kernel", (2, 2, prev, dim),
                      0.0, (4 * prev) ** -0.5),
                     (f"backbone/downsample{s}_conv/bias", (dim,), 0.0, 0.02)]
        for j in range(depth):
            b = f"backbone/stage{s}_block{j}"
            spec += [(f"{b}/dwconv/kernel", (7, 7, 1, dim), 0.0, 49 ** -0.5),
                     (f"{b}/dwconv/bias", (dim,), 0.0, 0.02),
                     (f"{b}/norm/scale", (dim,), 1.0, 0.1),
                     (f"{b}/norm/bias", (dim,), 0.0, 0.02),
                     (f"{b}/pwconv1/kernel", (dim, 4 * dim), 0.0, dim ** -0.5),
                     (f"{b}/pwconv1/bias", (4 * dim,), 0.0, 0.02),
                     (f"{b}/grn/gamma", (4 * dim,), 0.0, 0.1),
                     (f"{b}/grn/beta", (4 * dim,), 0.0, 0.02),
                     (f"{b}/pwconv2/kernel", (4 * dim, dim), 0.0,
                      (4 * dim) ** -0.5),
                     (f"{b}/pwconv2/bias", (dim,), 0.0, 0.02)]
    spec += [("backbone/head_norm/scale", (dims[-1],), 1.0, 0.1),
             ("backbone/head_norm/bias", (dims[-1],), 0.0, 0.02)]
    return spec + common.head_spec(dims[-1])


def conv(x: torch.Tensor, p: dict, stride: int = 1, padding: int = 0,
         groups: int = 1) -> torch.Tensor:
    """NHWC convolution with an HWIO kernel."""
    w = p["kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], stride, padding, 1,
                 groups)
    return y.permute(0, 2, 3, 1)


def grn(x: torch.Tensor, p: dict) -> torch.Tensor:
    gx = torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return p["gamma"] * (x * nx) + p["beta"] + x


def block(x: torch.Tensor, p: dict, bits) -> torch.Tensor:
    h = conv(x, p["dwconv"], padding=3, groups=x.shape[-1])
    h = common.dense(common.layer_norm(h, p["norm"]), p["pwconv1"], bits)
    h = grn(common.gelu(h, "erf"), p["grn"])
    return x + common.dense(h, p["pwconv2"], bits)


def forward(params: dict, x: torch.Tensor, model: dict, bits=None) -> dict:
    """x: (B, S, S, 3) normalized images -> {"squares" (B, 832), "turn"
    (B, 1), "castling" (B, 4)}, f32."""
    bb = params["backbone"]
    h = common.layer_norm(conv(x.float(), bb["stem_conv"], stride=4),
                          bb["stem_norm"])
    for s, depth, _ in _stage_names(model):
        if s:
            h = conv(common.layer_norm(h, bb[f"downsample{s}_norm"]),
                     bb[f"downsample{s}_conv"], stride=2)
        for j in range(depth):
            h = block(h, bb[f"stage{s}_block{j}"], bits)
    h = common.layer_norm(h, bb["head_norm"])
    return common.chess_heads(params, common.adaptive_pool_nhwc(h),
                              h.mean(dim=(1, 2)))


def work(model: dict) -> dict:
    """Multiply-adds of one image's forward by part: ``conv`` (stem,
    downsamples, depthwise), ``gemm`` (the pointwise products), ``heads``."""
    side = model["input_size"] // 4
    dims = model["dims"]
    convs = side * side * 48 * dims[0]
    gemm = 0
    for s, depth, dim in _stage_names(model):
        if s:
            side //= 2
            convs += side * side * 4 * dims[s - 1] * dim
        convs += depth * side * side * 49 * dim
        gemm += depth * side * side * 8 * dim * dim
    return {"conv": convs, "gemm": gemm,
            "heads": 64 * dims[-1] * 10 + dims[-1] * 5}
