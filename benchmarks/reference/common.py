"""Plain PyTorch pieces the references share: the chess heads, pooling,
LayerNorm, the GELU forms and fake quantization.

Everything computes in float32 on whatever device its inputs are on. Nothing
here imports the program under test; the formulas follow the published
models (timm's ViT-B/16 and ConvNeXtV2) and the chess heads' definition:
13 joint classes per square (empty, 6 white, 6 black pieces) as the sum of a
7-way type logit and a 3-way colour logit, a turn logit and 4 castling
logits.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#                .  P  N  B  R  Q  K  p  n  b  r  q  k
CLASS_TO_TYPE = (0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6)
CLASS_TO_COLOR = (0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2)
HEAD_WIDTHS = {"type_head": 7, "color_head": 3, "turn_head": 1,
               "castling_head": 4}
LN_EPS = 1e-6


@contextlib.contextmanager
def full_f32():
    """TF32 off for matrix products and convolutions while the reference
    runs: on the card an f32 product may otherwise round its inputs to 10
    mantissa bits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def head_spec(width: int) -> list:
    """(path, shape, mean, std) of the four chess heads on ``width``
    features: kernels of std 1/sqrt(fan in), small biases."""
    spec = []
    for name, out in HEAD_WIDTHS.items():
        spec.append((f"{name}/kernel", (width, out), 0.0, width ** -0.5))
        spec.append((f"{name}/bias", (out,), 0.0, 0.02))
    return spec


def layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"],
                        LN_EPS)


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    """``erf``: the exact GELU; ``sigmoid``: x * sigmoid(1.702 x)."""
    if form == "sigmoid":
        return x * torch.sigmoid(1.702 * x)
    if form == "erf":
        return F.gelu(x)
    raise ValueError(f"unknown GELU form {form!r}")


def fake_quant(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Symmetric abs-max quantization to ``bits`` along ``dim`` (one scale
    per slice across it), returned dequantized. The forward value is the
    quantized one; the gradient passes straight through."""
    qmax = 2 ** (bits - 1) - 1
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-8)
    scale = amax / qmax
    q = torch.round(x.detach() / scale).clamp(-qmax, qmax) * scale
    return x + (q - x).detach()


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    abs-max to 448), returned dequantized; the gradient passes straight
    through."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def low(x: torch.Tensor, bits, dim: int) -> torch.Tensor:
    """``x`` at ``bits``: "fp8" (``fake_fp8``) or an integer width
    (``fake_quant`` along ``dim``)."""
    return fake_fp8(x) if bits == "fp8" else fake_quant(x, bits, dim)


def dense(x: torch.Tensor, p: dict, bits=None) -> torch.Tensor:
    """x @ kernel + bias, kernel (in, out). With ``bits``, both operands are
    rounded first: an integer width quantizes the rows of x per row and the
    kernel per output channel (W{bits}A{bits} with dynamic per-token
    activation scales); "fp8" rounds each to float8 e4m3."""
    w = p["kernel"]
    if bits:
        x = low(x, bits, dim=-1)
        w = low(w, bits, dim=0)
    return x @ w + p["bias"]


def adaptive_pool_nhwc(x: torch.Tensor, out: int = 8) -> torch.Tensor:
    """(B, H, W, C) -> (B, out, out, C), torch's adaptive average windows."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)


def chess_heads(params: dict, grid: torch.Tensor,
                pooled: torch.Tensor) -> dict:
    """grid (B, 8, 8, C) features per square, pooled (B, C) -> {"squares"
    (B, 832), "turn" (B, 1), "castling" (B, 4)}."""
    dev = grid.device
    t = dense(grid, params["type_head"])
    c = dense(grid, params["color_head"])
    squares = (t.index_select(-1, torch.tensor(CLASS_TO_TYPE, device=dev))
               + c.index_select(-1, torch.tensor(CLASS_TO_COLOR, device=dev)))
    return {"squares": squares.reshape(grid.shape[0], -1),
            "turn": dense(pooled, params["turn_head"]),
            "castling": dense(pooled, params["castling_head"])}
