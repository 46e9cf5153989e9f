"""Transformer building blocks (``chess_vision_tpu/models/layers.py``).

Parameters are kept in f32 and cast to the dtype of the activation where they
are used, as flax does with a module ``dtype``; so in bf16 the residual stream
stays bf16. A caller may cast the weights once up front (the serving
``Predictor`` does): rounding once or at every use gives the same bf16 values.
LayerNorm is the exception: it computes in f32 with f32 scale and bias and
rounds its output once, as flax's LayerNorm does. Flax computes the variance
as E[x^2] - E[x]^2 (``use_fast_variance``); ``F.layer_norm`` is two-pass, one
of the stated sources of tolerance against the JAX package. Dropout and drop
path act in train mode only (``module.train()``), so serving is unchanged;
they draw from the device's default generator, whose state
``torch.utils.checkpoint`` restores when a block is recomputed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chess_vision_tpu_torch.ops import attention as attention_ops


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in the dtype of ``x``."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in train mode drops the whole residual
    branch of a sample with probability ``rate`` and scales the kept ones by
    1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.empty(shape, dtype=torch.float32,
                           device=x.device).bernoulli_(keep).bool()
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Linear -> exact (erf) GELU -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(linear(x, self.fc1)))
        return self.drop(linear(x, self.fc2))


class Attention(nn.Module):
    """Multi-head self-attention with a fused (timm-layout) qkv projection;
    the attention itself is ``ops.attention.fused_qkv_attention``."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = linear(x, self.qkv)
        out = attention_ops.fused_qkv_attention(qkv, self.num_heads)
        return self.drop(linear(out, self.proj))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, dropout: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, dropout)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


def make_pool_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) row-stochastic matrix implementing torch's
    adaptive_avg_pool1d windows: start=floor(i*n/o), end=ceil((i+1)*n/o)."""
    mat = torch.zeros((out_size, in_size), dtype=torch.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        mat[i, start:end] = 1.0 / (end - start)
    return mat


def adaptive_avg_pool_nhwc(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool of an NHWC tensor as two small products with
    pooling matrices in the dtype of ``x``, as the JAX package computes it."""
    H, W = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return x
    ph = make_pool_matrix(H, oh).to(device=x.device, dtype=x.dtype)
    pw = make_pool_matrix(W, ow).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,bhwc->bowc", ph, x)
    return torch.einsum("pw,bowc->bopc", pw, x)
