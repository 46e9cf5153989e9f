"""Building blocks of the three archs (``chess_vision_tpu/models/layers.py``
and the BatchNorm that ``chess_vision_tpu/models/mobilenet.py`` takes from
flax). Convolutional modules take and return NHWC tensors, as the JAX
package's do.

Parameters are kept in f32 and cast to the dtype of the activation where they
are used, as flax does with a module ``dtype``; so in bf16 the residual stream
stays bf16. A caller may cast the weights once up front (the serving
``Predictor`` does): rounding once or at every use gives the same bf16 values.
LayerNorm, BatchNorm and GRN are the exceptions: they compute in f32 with
f32 parameters and round their output once, as flax's modules do. Flax computes the variance
as E[x^2] - E[x]^2 (``use_fast_variance``); ``F.layer_norm`` is two-pass, one
of the stated sources of tolerance against the JAX package. Dropout and drop
path act in train mode only (``module.train()``), so serving is unchanged;
they draw from the device's default generator, whose state
``torch.utils.checkpoint`` restores when a block is recomputed.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext

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


@contextmanager
def full_f32():
    """TF32 off for cuBLAS products and cuDNN convolutions inside the block:
    the counterpart of JAX's ``precision="highest"``. PyTorch leaves TF32 on
    for cuDNN convolutions by default (and off for products), so an f32
    forward on the card would otherwise round the convolutions' inputs to
    10-bit mantissas. Nothing changes for bf16 inputs or on the CPU."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied to an NHWC tensor in the dtype of ``x``; NHWC out.
    The NHWC tensor's NCHW view is ``channels_last``, which cuDNN takes and
    returns as it is, so neither permute copies. A 1x1 ungrouped convolution
    with stride 1 is the matrix product over channels it equals
    (``F.linear``)."""
    weight = conv.weight.to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    if (conv.kernel_size == (1, 1) and conv.stride == (1, 1)
            and conv.groups == 1):
        return F.linear(x, weight[:, :, 0, 0], bias)
    with full_f32() if x.dtype == torch.float32 else nullcontext():
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, conv.stride,
                     conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXtV2) of an NHWC tensor, in f32,
    rounded once to the input's dtype: gx = ||x||_2 over H and W per
    channel, nx = gx / (mean_c(gx) + 1e-6), out = gamma * (x * nx) + beta +
    x. timm's names: ``weight`` is gamma, ``bias`` beta."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt(torch.sum(xf * xf, dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        out = self.weight.float() * (xf * nx) + self.bias.float() + xf
        return out.to(x.dtype)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of an NHWC tensor in f32 (or
    f64 for f64 input), the variance as E[x^2] - E[x]^2 clipped at 0 (flax's
    ``_compute_stats``)."""
    xf = _at_least_f32(x)
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=dims)
    var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
    return mean, var


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax's ``_normalize`` over the last axis: in f32 (f64 for f64 input),
    (x - mean) * (rsqrt(var + eps) * scale) + bias, rounded once to the
    dtype of ``x``."""
    xf = _at_least_f32(x)
    mul = torch.rsqrt(var + eps) * weight.to(xf.dtype)
    return ((xf - mean) * mul + bias.to(xf.dtype)).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax's semantics.

    The running statistics are f32 buffers with timm's names
    (``running_mean``, ``running_var``; no ``num_batches_tracked``). A
    ``pinned`` module (the default) always normalizes with them, also under
    ``module.train()``: ``nn.BatchNorm2d`` would switch to the batch's
    statistics there. Unpinned and in train mode it normalizes with the
    batch's statistics (``batch_moments``) and updates the running ones as
    flax does: ``momentum * running + (1 - momentum) * batch`` with momentum
    0.99 and the biased variance (``nn.BatchNorm2d`` updates with the
    unbiased one and weights the batch by its own ``momentum``, 0.1)."""

    eps = 1e-5
    momentum = 0.99

    def __init__(self, num_features: int):
        super().__init__()
        self.pinned = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.pinned:
            mean, var = batch_moments(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return batch_norm(x, mean, var, self.weight, self.bias, self.eps)


def global_avg_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def cast_weights(model: nn.Module) -> nn.Module:
    """Round every weight of ``model`` except those of the modules that
    compute in f32 (LayerNorm, BatchNorm, GRN) to ``model.dtype`` once, in
    place (the per-use casts then do nothing). The running statistics are
    buffers and stay f32."""
    for module in model.modules():
        if isinstance(module, (nn.LayerNorm, BatchNorm, GRN)):
            continue
        for param in module.parameters(recurse=False):
            param.data = param.data.to(model.dtype)
    return model
