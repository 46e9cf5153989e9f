"""One whole quantized ViT block of the int8 serving path in one kernel launch.

Counterpart of ``chess_vision_tpu/ops/fused_block.py`` (K14), the ``"fused"``
layout of ``ops/quant.chessvit_int8_apply``. From this block's LN1 output,
already quantized (``xq``, ``xs``), and the bf16 residual stream ``res``:

    qkv = bf16(xq @ Wqkv)                       int8 product, rescale, bias
    a   = attention(qkv)                        p rounded to bf16, row sum
                                                floored at 1e-30
    x'  = bf16(res + rowq(a) @ Wproj)
    h   = rowq(LN2(x'))                         two-pass LN of the rounded x'
    g   = rowq(gelu(h @ Wfc1))
    x'' = bf16(x' + g @ Wfc2)
    out = x'', rowq(LN_next(x''))

operation for operation the chain of the split ops (``quant.block_int8``), as
the JAX kernel is written against ``_block_tpu``. On a CUDA tensor
``fused_vit_block`` is one cooperative launch of ``csrc/fused_block.cu``,
whose stages run the split kernels' device code (the ``wgmma`` GEMM of
``csrc/int8_gemm.cuh``, the attention loop of ``csrc/attention_loop.cuh``);
on a CPU tensor it runs ``fused_vit_block_plain``, the same steps in PyTorch.

The JAX kernel requires a power-of-two softmax scale and a token count of
128 k + 1..2 (TPU lane rules) and ``quant.py`` falls back to the block layout
otherwise. This kernel takes any token count. Its softmax shift is the JAX
kernel's: a calibrated shift where one is given, else the default "bound",
|q_i| max_j |k_j| - 45 per row and head (``fused_block.py:138-142``); as in
K4, both need a power-of-two softmax scale, else the exact row max.
``shift_mode`` also takes "fixed" (24) and "max", which the JAX kernel does
not: the layout (``ops/quant.py``) passes "bound", as the JAX one does.
"""

from __future__ import annotations

import math

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn_ops
from chess_vision_tpu_torch.ops import int8_matmul as int8_ops
from chess_vision_tpu_torch.ops import rowquant as rq

# Kernel launches since the last reset (chip_smoke.py proves the fused path
# went through the kernel with it).
LAUNCHES = 0

_HEAD_DIMS = (16, 32, 64)  # instantiations in csrc/fused_block.cu
_MAX_D = 4096              # the row pass holds a row in registers


def fused_vit_block_plain(xq, xs, res, q: dict, next_ln: dict, num_heads: int,
                          softmax_shift: float | None = None,
                          eps: float = 1e-6, gelu: str = "sigmoid",
                          shift_mode: str = "bound"):
    """Plain PyTorch version of the whole-block kernel, step by step with
    its rounding points; returns (x_new bf16, yq int8, ys f32)."""
    # qkv product + rescale + bias -> bf16
    qkv = int8_ops.int8_matmul_scale_bias_plain(
        xq, xs, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    # attention (p in bf16, row sum floored), then the per-token row quant
    # over all heads
    aq, as_ = attn_ops.reference_attention_quant(qkv, num_heads, softmax_shift,
                                                 shift_mode)
    # proj + residual rounded to bf16, two-pass LN2 of the rounded value,
    # row quant
    x1, hq, hs = int8_ops.int8_matmul_res_ln_quant_plain(
        aq, as_, q["proj"]["wq"], q["proj"]["scale"], q["proj"]["bias"], res,
        q["norm2"]["scale"], q["norm2"]["bias"], eps)
    # fc1 + GELU + row quant
    gq, gs = int8_ops.int8_matmul_gelu_quant_plain(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], gelu)
    # fc2 + residual rounded to bf16, the next block's LN1, row quant
    return int8_ops.int8_matmul_res_ln_quant_plain(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"], x1,
        next_ln["scale"], next_ln["bias"], eps)


def _weight(p: dict, O: int, K: int, dev, what: str):
    """A dense layer's kernel operands: int8 (O, K) weight, f32 (O,) scale
    and bias, or raise."""
    wq = p["wq"]
    if (wq.dtype != torch.int8 or wq.shape != (O, K) or wq.device != dev
            or not wq.is_contiguous() or wq.data_ptr() % 16):
        raise ValueError(f"{what} weight must be contiguous int8 ({O}, {K}) "
                         f"on {dev}, got {wq.dtype} {tuple(wq.shape)} on "
                         f"{wq.device}")
    return (wq, rq.f32_vector(p["scale"], O, dev, f"{what} scale"),
            rq.f32_vector(p["bias"], O, dev, f"{what} bias"))


# The kernel's stages in order (csrc/fused_block.cu); stage_ns has one slot
# more, the start.
STAGES = ("qkv gemm", "attention + row quant", "proj gemm", "ln2 row quant",
          "fc1 gemm + gelu + row quant", "fc2 gemm", "next ln1 row quant")


def fused_vit_block(xq, xs, res, q: dict, next_ln: dict, num_heads: int,
                    softmax_shift: float | None = None, eps: float = 1e-6,
                    gelu: str = "sigmoid", stage_ns: torch.Tensor | None = None,
                    shift_mode: str = "bound"):
    """One quantized ViT block in a single kernel launch.

    xq/xs: (B, N, D) int8 + (B, N, 1) f32 quantizing norm1(res); res:
    (B, N, D) bf16 residual stream; q: the block's pack (qkv/proj/fc1/fc2
    ``wq`` (O, K) + scale + bias, norm2 scale + bias); next_ln: the next
    block's norm1 {scale, bias}, required (the last block, which has no
    follow-on quant, runs on the split kernels). softmax_shift: calibrated
    per-layer scalar or None, which then takes shift_mode ("bound", the
    JAX kernel's, "fixed" or "max"); gelu: "sigmoid", "erf" or "hard". Returns
    (x_new, yq, ys) where yq/ys quantize next_ln(x_new). stage_ns: an
    optional int64 tensor of len(STAGES) + 1 on the device, into which the
    kernel notes the card's nanosecond clock at its start and after each
    stage (a measurement aid; the plain version leaves it alone).

    A CPU tensor takes ``fused_vit_block_plain``; a CUDA tensor launches the
    kernel (head dim 16, 32 or 64) or raises."""
    if next_ln is None:
        raise ValueError("the fused block needs the next block's norm1; the "
                         "last block runs on the split kernels")
    if gelu not in int8_ops.GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; expected one of "
                         f"{list(int8_ops.GELUS)}")
    if stage_ns is not None and (
            stage_ns.dtype != torch.int64 or stage_ns.device != xq.device
            or stage_ns.shape != (len(STAGES) + 1,)
            or not stage_ns.is_contiguous()):
        raise ValueError(f"stage_ns must be int64 ({len(STAGES) + 1},) on "
                         f"{xq.device}")
    if xq.device.type == "cpu":
        return fused_vit_block_plain(xq, xs, res, q, next_ln, num_heads,
                                     softmax_shift, eps, gelu, shift_mode)
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if xq.dim() != 3 or xq.dtype != torch.int8:
        raise TypeError(f"xq must be int8 (B, N, D), got {xq.dtype} "
                        f"{tuple(xq.shape)}")
    B, N, D = xq.shape
    if xs.shape != (B, N, 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be f32 {(B, N, 1)}, got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    if res.shape != (B, N, D) or res.dtype != torch.bfloat16:
        raise ValueError(f"res must be bf16 {(B, N, D)}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    head_dim = D // num_heads
    O1 = q["fc1"]["wq"].shape[0]
    if D % num_heads or head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}/{num_heads} not in {_HEAD_DIMS}")
    if D % 16 or O1 % 16 or D > _MAX_D or O1 > _MAX_D:
        raise ValueError(f"widths D={D}, O1={O1} must be multiples of 16 up "
                         f"to {_MAX_D}")
    for name, t in (("xq", xq), ("xs", xs), ("res", res)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             f"on {dev}")
    operands = [*_weight(q["qkv"], 3 * D, D, dev, "qkv"),
                *_weight(q["proj"], D, D, dev, "proj"),
                rq.f32_vector(q["norm2"]["scale"], D, dev, "norm2 scale"),
                rq.f32_vector(q["norm2"]["bias"], D, dev, "norm2 bias"),
                *_weight(q["fc1"], O1, D, dev, "fc1"),
                *_weight(q["fc2"], D, O1, dev, "fc2"),
                rq.f32_vector(next_ln["scale"], D, dev, "next norm1 scale"),
                rq.f32_vector(next_ln["bias"], D, dev, "next norm1 bias")]
    x_new = torch.empty_like(res)
    yq = torch.empty_like(xq)
    ys = torch.empty_like(xs)
    if xq.numel() == 0:
        return x_new, yq, ys
    kind, shift = attn_ops._shift(shift_mode, softmax_shift, head_dim)
    lib = _build.library()
    scratch = torch.empty(
        lib.cvt_fused_block_scratch_bytes(B * N, D, O1), dtype=torch.uint8,
        device=dev)
    with torch.cuda.device(dev):
        rc = lib.cvt_fused_block(
            xq.data_ptr(), xs.data_ptr(), res.data_ptr(),
            *(t.data_ptr() for t in operands), scratch.data_ptr(),
            x_new.data_ptr(), yq.data_ptr(), ys.data_ptr(), B, N, num_heads,
            head_dim, O1, 1.0 / math.sqrt(head_dim),
            shift, attn_ops.SHIFT_MODES[kind],
            int8_ops.GELUS[gelu], eps,
            None if stage_ns is None else stage_ns.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused block")
    global LAUNCHES
    LAUNCHES += 1
    return x_new, yq, ys


def fused_vit_stack(xq, xs, res, blocks, next_norm1s, shifts, num_heads: int,
                    eps: float = 1e-6, gelu: str = "sigmoid",
                    shift_mode: str = "bound"):
    """A chain of fused blocks: blocks[i] followed by next_norm1s[i], with
    the per-layer shifts[i] (floats or None, in any mixture).

    The JAX function of this name is a ``lax.scan`` over stacked weights, so
    that one compiled kernel serves every layer. Here the shift is a kernel
    argument and every layer launches the same kernel anyway: this is the
    loop over ``fused_vit_block``. Returns (x, yq, ys) after the last block."""
    if not (len(blocks) == len(next_norm1s) == len(shifts) and blocks):
        raise ValueError("blocks, next_norm1s and shifts must be equally "
                         "long and not empty")
    x = res
    for q, nxt, shift in zip(blocks, next_norm1s, shifts):
        x, xq, xs = fused_vit_block(xq, xs, x, q, nxt, num_heads, shift, eps,
                                    gelu, shift_mode=shift_mode)
    return x, xq, xs
