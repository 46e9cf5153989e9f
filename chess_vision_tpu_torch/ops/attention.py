"""Multi-head attention forward on the packed qkv projection.

Counterpart of ``chess_vision_tpu/ops/attention.py`` ``fused_qkv_attention``
(forward only; this package serves). The kernel, ``csrc/attention.cu``, reads
Q, K and V straight out of the packed (B, N, 3*H*Dh) projection and keeps the
scores on chip; ``reference_attention`` is the plain PyTorch version, with the
same math as the JAX package's ``_reference_attention``.
"""

from __future__ import annotations

import math

import torch

from chess_vision_tpu_torch.ops import _build

# Kernel launches since the last reset (chip_smoke.py proves the main path
# went through the kernel with it).
LAUNCHES = 0

_HEAD_DIMS = (16, 32, 64)  # instantiations in csrc/attention.cu
_MAX_GRID_YZ = 65535


def reference_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention: (B, N, 3*H*Dh) -> (B, N, H*Dh).

    Scores in the input dtype, softmax in f32, probabilities cast back to
    the input dtype for the product with V, as in the JAX reference."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.reshape(B, N, D)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3*H*Dh) packed qkv -> (B, N, H*Dh) attention output.

    A CPU tensor takes ``reference_attention``; a CUDA tensor launches the
    kernel (bf16, head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bf16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} does not split into "
                         f"3 x {num_heads} heads")
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {_HEAD_DIMS}")
    if B > _MAX_GRID_YZ or num_heads > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {num_heads} exceed the grid")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        rc = lib.cvt_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, num_heads, head_dim,
            1.0 / math.sqrt(head_dim), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
