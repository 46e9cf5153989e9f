"""Multi-head attention on the packed qkv projection, forward and backward.

Counterpart of ``chess_vision_tpu/ops/attention.py`` ``fused_qkv_attention``
and its custom VJP. The forward kernel, ``csrc/attention.cu``, reads Q, K and
V straight out of the packed (B, N, 3*H*Dh) projection and keeps the scores
on chip; ``reference_attention`` is the plain PyTorch version, with the same
math as the JAX package's ``_reference_attention``. ``fused_qkv_attention`` is
differentiable through a ``torch.autograd.Function`` that saves only ``qkv``
(as ``_tpu_attention_fwd`` does); its backward is the kernel
``csrc/attention_bwd.cu`` (``fused_qkv_attention_bwd``: one block per
(image, head) holds the head's Q, K, V and g in shared memory, recomputes the
softmax statistics into registers in a first sweep over the keys and forms
dQ, dK and dV in a second, with no scratch in device memory; above
``BWD_MAX_TOKENS`` tokens the two kernels of ``csrc/attention_bwd_long.cu``), with
``reference_attention_bwd`` as the plain version: the arithmetic of the JAX
package's ``_attn_bwd_kernel`` step by step, with its rounding points.

``fused_qkv_attention_quant`` is the int8 serving path's form (the JAX
package's function of that name, K4): attention, then per-token int8
quantization of the (B, N, H*Dh) output, in ``csrc/attention_quant.cu`` (one
launch: the blocks of a row chunk's heads form a thread-block cluster and
exchange their row maxima on chip, so at most ``QUANT_MAX_HEADS`` heads);
``reference_attention_quant`` is its plain version.
``fused_qkv_attention_quant_flat`` (K5) is the same on the ``"flat"`` int8
layout's (images * NP, 3*H*Dh) stream, whose token axis is padded to NP rows
per image: keys at token index >= ``n_real`` are masked out of the softmax.
It runs the same kernel through its second entry point, which keeps the rows
per image and the valid keys apart; ``reference_attention_quant_flat`` is its
plain version.
"""

from __future__ import annotations

import math

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops.rowquant import quantize_rows

# Kernel launches since the last reset, of the attention forward kernel, of
# the backward one, of the quantizing one and of its flat form (chip_smoke.py
# proves the main path went through the kernels with them).
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_LONG_LAUNCHES = 0  # of BWD_LAUNCHES, those of the long route
QUANT_LAUNCHES = 0
FLAT_LAUNCHES = 0

_HEAD_DIMS = (16, 32, 64)  # instantiations in csrc/attention.cu
BWD_MAX_TOKENS = 288  # kMaxN in csrc/attention_bwd.cu
QUANT_MAX_HEADS = 16  # kMaxHeads in csrc/attention_quant.cu
_MAX_GRID_YZ = 65535


def reference_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention: (B, N, 3*H*Dh) -> (B, N, H*Dh).

    Scores in the input dtype, softmax in f32, probabilities cast back to
    the input dtype for the product with V, as in the JAX reference."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(_accum_dtype(qkv)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.reshape(B, N, D)


def reference_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention backward: saved qkv (B, N, 3*H*Dh) and the
    cotangent g (B, N, H*Dh) of the output -> dqkv (B, N, 3*H*Dh).

    The steps and rounding points of the JAX package's ``_attn_bwd_kernel``:
    scores, the max-shifted softmax, its normalization, dP and r in f32; pn
    rounded to the input dtype only as the operand of dV = pn^T g; dS rounded
    to the input dtype after the scale is folded in, then dQ = dS K and
    dK = dS^T Q; f32 accumulation and one rounding of each output."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    acc = _accum_dtype(qkv)
    scale = 1.0 / math.sqrt(head_dim)
    q, k, v = (t.to(acc) for t in
               qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2))
    gh = g.reshape(B, N, num_heads, head_dim).to(acc)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.to(qkv.dtype).to(acc), gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    r = (dp * pn).sum(dim=-1, keepdim=True)
    ds = (pn * (dp - r) * scale).to(qkv.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(B, N, C3).to(qkv.dtype)


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16, f16 and f32 inputs; f64 stays f64."""
    return torch.promote_types(x.dtype, torch.float32)


def _check_kernel_input(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise on what the attention kernels do not take; returns the head dim."""
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
    return head_dim


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3*H*Dh) packed qkv -> (B, N, H*Dh) attention output,
    differentiable in ``qkv``.

    A CPU tensor takes ``reference_attention`` (and
    ``reference_attention_bwd`` for its gradient); a CUDA tensor launches the
    kernels (bf16, head dim 16, 32 or 64) or raises."""
    if qkv.requires_grad and torch.is_grad_enabled():
        return _FusedAttention.apply(qkv, num_heads)
    return fused_qkv_attention_fwd(qkv, num_heads)


class _FusedAttention(torch.autograd.Function):
    """The forward saves only ``qkv``; the backward recomputes the softmax
    statistics from it inside its one kernel (``fused_qkv_attention_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return fused_qkv_attention_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return fused_qkv_attention_bwd(qkv, g, ctx.num_heads), None


def fused_qkv_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward alone, outside autograd: ``reference_attention`` for a CPU
    tensor, the kernel for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return reference_attention(qkv, num_heads)
    head_dim = _check_kernel_input(qkv, num_heads)
    B, N, C3 = qkv.shape
    D = C3 // 3
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


def bwd_route(n: int) -> str:
    """The backward kernel that takes ``n`` tokens: ``"short"``
    (``csrc/attention_bwd.cu``, a head in shared memory) up to
    ``BWD_MAX_TOKENS``, ``"long"`` (``csrc/attention_bwd_long.cu``) above."""
    return "short" if n <= BWD_MAX_TOKENS else "long"


def fused_qkv_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Saved qkv (B, N, 3*H*Dh) and the output's cotangent g (B, N, H*Dh) ->
    dqkv (B, N, 3*H*Dh).

    A CPU tensor takes ``reference_attention_bwd``; a CUDA tensor launches
    a backward kernel (bf16, head dim 16, 32 or 64) or raises. Both kernels
    are hand-written and give the same function; the shape picks one
    (``bwd_route``): up to ``BWD_MAX_TOKENS`` tokens the one-block-per-head
    kernel of ``csrc/attention_bwd.cu``, above it the two kernels of
    ``csrc/attention_bwd_long.cu`` (dQ per 64-query tile, then dK/dV per
    64-key tile, through an f32 (B, H, 3, N) statistics scratch). ``g`` is
    made contiguous first (autograd may hand a strided one)."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    if g.shape != (B, N, D) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"does not match qkv {tuple(qkv.shape)} {qkv.dtype} "
                         f"on {qkv.device}")
    if qkv.device.type == "cpu":
        return reference_attention_bwd(qkv, g, num_heads)
    head_dim = _check_kernel_input(qkv, num_heads)
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    lib = _build.library()
    long = bwd_route(N) == "long"
    # the long route's row statistics (max, 1/l, r) per (image, head, row)
    stats = (torch.empty((B, num_heads, 3, N), dtype=torch.float32,
                         device=qkv.device) if long else None)
    scratch = [stats.data_ptr()] if long else []
    entry = lib.cvt_attention_bwd_long if long else lib.cvt_attention_bwd
    with torch.cuda.device(qkv.device):
        rc = entry(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), *scratch,
                   B, N, num_heads, head_dim, 1.0 / math.sqrt(head_dim),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention backward")
    global BWD_LAUNCHES, BWD_LONG_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_LONG_LAUNCHES += long
    return dqkv


def _pow2(x: float) -> bool:
    """True when x is an exact power of two (the JAX kernel then folds the
    softmax scale into q and honours a fixed shift)."""
    return math.frexp(x)[0] == 0.5


def _fixed_shift(softmax_shift: float | None, head_dim: int) -> bool:
    """Whether a calibrated shift is used as given. The JAX kernel uses it
    only where the softmax scale folds exactly (``_attn_quant_image``); other
    head dims keep the exact row max."""
    return softmax_shift is not None and _pow2(1.0 / math.sqrt(head_dim))


def _attention_quant_plain(qkv: torch.Tensor, n_real: int, num_heads: int,
                           softmax_shift: float | None):
    """(B, N, 3*H*Dh) -> (int8 (B, N, H*Dh), f32 (B, N, 1)), keys at token
    index >= n_real masked: the arithmetic shared by the plain versions of
    K4 (n_real = N) and K5.

    f32 scores; a masked key's score is -1e30, so its p is exactly 0;
    p = exp(s - shift) rounded to the input dtype feeds both P V and the row
    sum (the JAX kernel's ones column of V); the output is
    P V / max(rowsum, 1e-30) in f32, then quantized per token over all
    heads. The shift is ``softmax_shift`` where the JAX kernel takes it as a
    fixed shift, else the exact row max."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(head_dim))
    if n_real < N:
        s[..., n_real:] = -1e30
    if _fixed_shift(softmax_shift, head_dim):
        shift = float(softmax_shift)
    else:
        shift = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - shift).to(qkv.dtype).float()
    rowsum = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, N, H, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / rowsum.clamp_min(1e-30)
    return quantize_rows(o.reshape(B, N, D))


def reference_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None):
    """Plain PyTorch version of the quantizing attention: (B, N, 3*H*Dh) ->
    (int8 (B, N, H*Dh), f32 (B, N, 1)); see ``_attention_quant_plain``."""
    return _attention_quant_plain(qkv, qkv.shape[1], num_heads, softmax_shift)


def _check_quant_shape(D: int, num_heads: int) -> None:
    if D % 8 or D > 4096:
        raise ValueError(f"model width {D} must be a multiple of 8 up to 4096")
    if num_heads > QUANT_MAX_HEADS:
        raise ValueError(f"{num_heads} heads exceed the quantizing attention's "
                         f"{QUANT_MAX_HEADS} (one thread-block cluster holds "
                         "every head of a row chunk)")


def fused_qkv_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None):
    """(B, N, 3*H*Dh) packed qkv -> (int8 (B, N, H*Dh), f32 (B, N, 1)).

    softmax_shift: a calibrated per-layer shift (``ops/quant.py``
    ``calibrate_attn_shifts``), else the exact row max. A CPU tensor takes
    ``reference_attention_quant``; a CUDA tensor launches the kernel (bf16,
    head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention_quant(qkv, num_heads, softmax_shift)
    head_dim = _check_kernel_input(qkv, num_heads)
    B, N, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    fixed = _fixed_shift(softmax_shift, head_dim)
    oq = torch.empty((B, N, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((B, N, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        rc = lib.cvt_attention_quant(
            qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
            B, N, num_heads, head_dim, 1.0 / math.sqrt(head_dim),
            float(softmax_shift) if fixed else 0.0, int(fixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "quantizing attention")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return oq, os_


def _flat_images(qkv: torch.Tensor, images: int, n_real: int) -> int:
    """Check the flat stream's shape; returns NP, the rows per image."""
    if qkv.dim() != 2 or images < 1 or qkv.shape[0] % images:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not {images} images of "
                         "equally many rows")
    NP = qkv.shape[0] // images
    if not 1 <= n_real <= NP:
        raise ValueError(f"n_real {n_real} outside 1..{NP} rows per image")
    return NP


def reference_attention_quant_flat(qkv: torch.Tensor, images: int,
                                   n_real: int, num_heads: int,
                                   softmax_shift: float | None = None):
    """Plain PyTorch version of the flat quantizing attention: (images * NP,
    3*H*Dh) -> (int8 (images * NP, H*Dh), f32 (images * NP, 1)), keys at
    token index >= n_real masked; see ``_attention_quant_plain``. A padded
    query row attends to the real keys like any other row: what it holds
    stays in its own output row."""
    NP = _flat_images(qkv, images, n_real)
    oq, os_ = _attention_quant_plain(qkv.reshape(images, NP, -1), n_real,
                                     num_heads, softmax_shift)
    return oq.reshape(images * NP, -1), os_.reshape(images * NP, 1)


def fused_qkv_attention_quant_flat(qkv: torch.Tensor, images: int,
                                   n_real: int, num_heads: int,
                                   softmax_shift: float | None = None):
    """(images * NP, 3*H*Dh) flat packed qkv -> (int8 (images * NP, H*Dh),
    f32 (images * NP, 1)): the quantizing attention of the ``"flat"`` int8
    layout. Each image holds NP rows of which the first ``n_real`` are
    tokens; keys at index >= n_real take no part in any row's softmax.

    softmax_shift as for ``fused_qkv_attention_quant``. A CPU tensor takes
    ``reference_attention_quant_flat``; a CUDA tensor launches the kernel
    (bf16, head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention_quant_flat(qkv, images, n_real, num_heads,
                                              softmax_shift)
    NP = _flat_images(qkv, images, n_real)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    head_dim = _check_kernel_input(qkv.view(images, NP, -1), num_heads)
    M, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    fixed = _fixed_shift(softmax_shift, head_dim)
    oq = torch.empty((M, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((M, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        rc = lib.cvt_attention_quant_flat(
            qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
            images, NP, n_real, num_heads, head_dim,
            1.0 / math.sqrt(head_dim),
            float(softmax_shift) if fixed else 0.0, int(fixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flat quantizing attention")
    global FLAT_LAUNCHES
    FLAT_LAUNCHES += 1
    return oq, os_
