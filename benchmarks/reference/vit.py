"""Plain ChessViT: ViT-B/16 (Dosovitskiy et al., arXiv:2010.11929; timm's
``vit_base_patch16_224.augreg_in21k`` layout) with the chess heads, in f32.

Pre-norm blocks x + attn(LN1(x)), x + mlp(LN2(x)) with a fused qkv
projection, LayerNorm eps 1e-6, a CLS token and a learned position
embedding. The patch tokens are average-pooled to the 8x8 board and
classified per square; the CLS token feeds turn and castling.

The parameters are a nested dict in the layout the checkpoints use (flax's):
``backbone/patch_embed/kernel`` (P, P, 3, D), ``backbone/block{i}/attn/qkv/
kernel`` (D, 3D), ... ``type_head/kernel`` (D, 7).

``bits="fp8"`` rounds the operands of every block product, attention's
too, to float8 e4m3 (the training cell's control).

``forward(..., bits=8, gelu="sigmoid", shift="bound")`` is the W8A8 serving
form: each block's four products (qkv, proj, fc1, fc2) take rows quantized
per token and weights per output channel (``common.dense``); the fc1 GELU is
x * sigmoid(1.702 x); the softmax is taken against the shift
|q_i| max_j |k_j| / sqrt(d) - 45 instead of the row maximum (in f32 the
same probabilities, barring underflow). ``bits=4`` is the same at 4 bits.
"""

from __future__ import annotations

import torch

from benchmarks.reference import common

BOUND_OFFSET = 45.0


def param_spec(model: dict) -> list:
    """(path, shape, mean, std) of every parameter: kernels of std
    1/sqrt(fan in), LayerNorm scales 1 + N(0, 0.1), biases, the CLS token
    and the position embedding N(0, 0.02)."""
    D = model["embed_dim"]
    P = model["patch_size"]
    H = int(D * model["mlp_ratio"])
    G = model["input_size"] // P
    spec = [("backbone/cls_token", (1, 1, D), 0.0, 0.02),
            ("backbone/pos_embed", (1, G * G + 1, D), 0.0, 0.02),
            ("backbone/patch_embed/kernel", (P, P, 3, D), 0.0,
             (P * P * 3) ** -0.5),
            ("backbone/patch_embed/bias", (D,), 0.0, 0.02)]
    for i in range(model["depth"]):
        b = f"backbone/block{i}"
        for norm in ("norm1", "norm2"):
            spec += [(f"{b}/{norm}/scale", (D,), 1.0, 0.1),
                     (f"{b}/{norm}/bias", (D,), 0.0, 0.02)]
        for name, k, n in (("attn/qkv", D, 3 * D), ("attn/proj", D, D),
                           ("mlp/fc1", D, H), ("mlp/fc2", H, D)):
            spec += [(f"{b}/{name}/kernel", (k, n), 0.0, k ** -0.5),
                     (f"{b}/{name}/bias", (n,), 0.0, 0.02)]
    spec += [("backbone/norm/scale", (D,), 1.0, 0.1),
             ("backbone/norm/bias", (D,), 0.0, 0.02)]
    return spec + common.head_spec(D)


def attention(qkv: torch.Tensor, heads: int, shift: str = "max",
              fp8: bool = False) -> torch.Tensor:
    """(B, N, 3D) -> (B, N, D): softmax(q k^T / sqrt(d)) v per head; with
    ``fp8`` both products' operands rounded to float8 e4m3."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    if fp8:
        qkv = common.fake_fp8(qkv)
    q, k, v = qkv.reshape(B, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    scale = (D // heads) ** -0.5
    s = (q @ k.transpose(-1, -2)) * scale
    if shift == "max":
        p = torch.softmax(s, dim=-1)
    elif shift == "bound":
        kmax = k.norm(dim=-1).amax(dim=-1, keepdim=True)          # (B, H, 1)
        m = (q.norm(dim=-1) * kmax * scale - BOUND_OFFSET)[..., None]
        e = torch.exp(s - m)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        raise ValueError(f"unknown softmax shift {shift!r}")
    if fp8:
        p = common.fake_fp8(p)
    return (p @ v).transpose(1, 2).reshape(B, N, D)


def block(x: torch.Tensor, p: dict, heads: int, bits, gelu: str,
          shift: str) -> torch.Tensor:
    a = attention(common.dense(common.layer_norm(x, p["norm1"]),
                               p["attn"]["qkv"], bits), heads, shift,
                  fp8=bits == "fp8")
    x = x + common.dense(a, p["attn"]["proj"], bits)
    h = common.dense(common.layer_norm(x, p["norm2"]), p["mlp"]["fc1"], bits)
    return x + common.dense(common.gelu(h, gelu), p["mlp"]["fc2"], bits)


def forward(params: dict, x: torch.Tensor, model: dict, bits=None,
            gelu: str = "erf", shift: str = "max") -> dict:
    """x: (B, S, S, 3) normalized images -> {"squares" (B, 832), "turn"
    (B, 1), "castling" (B, 4)}, f32."""
    bb = params["backbone"]
    P = model["patch_size"]
    B, S, _, C = x.shape
    G = S // P
    patches = x.float().reshape(B, G, P, G, P, C).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, G * G, P * P * C)
    kernel = bb["patch_embed"]["kernel"]
    h = (patches @ kernel.reshape(-1, kernel.shape[-1])
         + bb["patch_embed"]["bias"])
    cls = bb["cls_token"].expand(B, 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1) + bb["pos_embed"]
    for i in range(model["depth"]):
        h = block(h, bb[f"block{i}"], model["num_heads"], bits, gelu, shift)
    h = common.layer_norm(h, bb["norm"])
    grid = common.adaptive_pool_nhwc(h[:, 1:].reshape(B, G, G, -1))
    return common.chess_heads(params, grid, h[:, 0])


def work(model: dict) -> dict:
    """Multiply-adds of one image's forward by part: ``gemm`` (the blocks'
    four products), ``attention`` (q k^T and p v), ``embed`` (the patch
    product) and ``heads``."""
    D = model["embed_dim"]
    P = model["patch_size"]
    G = model["input_size"] // P
    N = G * G + 1
    H = int(D * model["mlp_ratio"])
    depth = model["depth"]
    return {"embed": G * G * P * P * 3 * D,
            "gemm": depth * N * (D * 3 * D + D * D + 2 * D * H),
            "attention": depth * 2 * N * N * D,
            "heads": 64 * D * 10 + D * 5}
