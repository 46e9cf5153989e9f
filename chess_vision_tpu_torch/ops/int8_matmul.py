"""int8 (W8A8) GEMM with the serving path's fused epilogues.

Counterpart of ``chess_vision_tpu/ops/int8_matmul.py``. Every function takes
activations as (..., K) int8 rows with (..., 1) f32 per-row scales, so each
stands for both the JAX package's per-image kernel and its flat twin:

  int8_matmul_gelu_quant    yq, ys = rowquant(gelu(y))               K8, K11
  int8_matmul_res_ln_quant  x' = bf16(res + y); yq, ys = rowquant(LN(x'))
                                                                     K9, K12
  int8_matmul_res           x' = bf16(res + y)                       K10, K13
  int8_matmul_scale_bias    bf16(y), the qkv product (``quant_dense_q``,
                            which the JAX package leaves to XLA)

with y = f32(xq @ wq) * xs * ws + bias. Weights are int8 stored (O, K), K
contiguous (``convert/jax_params.int8_pack_from_jax``). On a CUDA tensor each
runs the hand-written kernel ``csrc/int8_matmul.cu``; on a CPU tensor its
plain version (``*_plain``), the same arithmetic in PyTorch with an exact
int32 product.
"""

from __future__ import annotations

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import rowquant as rq

# Kernel launches per epilogue since the last reset (chip_smoke.py proves the
# main path went through the kernel with them).
LAUNCHES = {"scale_bias": 0, "gelu_quant": 0, "res_ln_quant": 0, "res": 0}

GELUS = {"erf": 0, "sigmoid": 1, "hard": 2}
_EPILOGUES = {"scale_bias": 0, "res": 1, "res_ln_quant": 2, "gelu_quant": 3}
_GELU_FNS = {"erf": rq.gelu_erf, "sigmoid": rq.gelu_sigmoid_div,
             "hard": rq.gelu_hard}
_MAX_ROWS = 2**31 - 65  # the kernel's row coordinates are 32-bit


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of (M, K) int8 rows with (O, K) int8 weights.

    Never through f32: 127^2 * 3072 ~ 5.0e7 exceeds 2^24. (On CUDA
    ``torch._int_mm`` takes more than 16 rows.)"""
    return torch._int_mm(xq, wq.t())


def _rescaled(xq, xs, wq, ws, bias) -> torch.Tensor:
    """(..., K) int8 -> (..., O) f32: ((acc * xs) * ws) + bias, JAX order."""
    K = xq.shape[-1]
    acc = int8_mm(xq.reshape(-1, K), wq).reshape(*xq.shape[:-1], wq.shape[0])
    return acc.float() * xs.float() * ws.float() + bias.float()


def int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias) -> torch.Tensor:
    return _rescaled(xq, xs, wq, ws, bias).to(torch.bfloat16)


def int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu: str = "erf"):
    return rq.quantize_rows(_GELU_FNS[gelu](_rescaled(xq, xs, wq, ws, bias)))


def int8_matmul_res_plain(xq, xs, wq, ws, bias, res) -> torch.Tensor:
    return (res.float() + _rescaled(xq, xs, wq, ws, bias)).to(res.dtype)


def int8_matmul_res_ln_quant_plain(xq, xs, wq, ws, bias, res, ln_scale,
                                   ln_bias, eps: float = 1e-6):
    # LayerNorm of the stored (bf16-rounded) residual, as the JAX kernel
    x = int8_matmul_res_plain(xq, xs, wq, ws, bias, res)
    yq, ys = rq.rowquant_plain(x, "ln", ln_scale, ln_bias, eps)
    return x, yq, ys


def _launch(epilogue: str, xq, xs, wq, ws, bias, res=None, gelu="erf",
            ln_scale=None, ln_bias=None, eps=1e-6):
    """Check the operands, allocate the outputs, launch; returns the outputs
    of the epilogue."""
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype}, {wq.dtype}")
    if gelu not in GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; expected one of {list(GELUS)}")
    K = xq.shape[-1]
    O = wq.shape[0]
    M = xq.numel() // K if K else 0
    if wq.dim() != 2 or wq.shape[1] != K or wq.device != dev:
        raise ValueError(f"wq {tuple(wq.shape)} on {wq.device} is not (O, {K}) "
                         f"on {dev}")
    if K % 16 or K < 16 or O % 8 or O < 8:
        raise ValueError(f"K={K} must be a multiple of 16, O={O} of 8")
    if M > _MAX_ROWS:
        raise ValueError(f"{M} rows exceed the kernel's grid")
    if xs.shape != (*xq.shape[:-1], 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be f32 {(*xq.shape[:-1], 1)}, got "
                         f"{xs.dtype} {tuple(xs.shape)}")
    out_shape = (*xq.shape[:-1], O)
    if res is not None and (res.shape != out_shape or res.dtype != torch.bfloat16):
        raise ValueError(f"res must be bf16 {out_shape}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    for name, t in (("xq", xq), ("xs", xs), ("wq", wq), ("res", res)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    # the kernel reads four columns' scales and biases in one 16-byte load
    ws, bias = (v.clone() if v.data_ptr() % 16 else v for v in
                (rq.f32_vector(ws, O, dev, "ws"),
                 rq.f32_vector(bias, O, dev, "bias")))
    g = b = yq = ys = None
    if epilogue == "res_ln_quant":
        g = rq.f32_vector(ln_scale, O, dev, "ln_scale")
        b = rq.f32_vector(ln_bias, O, dev, "ln_bias")
    if epilogue == "gelu_quant":
        # the kernel's scratch: the rows' max |gelu(y)| and, per 64 rows, a
        # count of the warps that have added theirs
        out = torch.empty((M + -(-M // 64),), dtype=torch.float32, device=dev)
    else:
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
    if epilogue in ("res_ln_quant", "gelu_quant"):
        yq = torch.empty(out_shape, dtype=torch.int8, device=dev)
        ys = torch.empty((*xq.shape[:-1], 1), dtype=torch.float32, device=dev)
    if M:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.cvt_int8_matmul(
                xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                bias.data_ptr(), ptr(res), out.data_ptr(), M, K, O,
                _EPILOGUES[epilogue], GELUS[gelu], ptr(g), ptr(b), eps,
                ptr(yq), ptr(ys), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"int8 matmul ({epilogue})")
        LAUNCHES[epilogue] += 1
    return out, yq, ys


def int8_matmul_scale_bias(xq, xs, wq, ws, bias) -> torch.Tensor:
    """qkv: (..., K) int8 rows -> bf16 (..., O) = bf16(y)."""
    if xq.device.type == "cpu":
        return int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias)
    return _launch("scale_bias", xq, xs, wq, ws, bias)[0]


def int8_matmul_gelu_quant(xq, xs, wq, ws, bias, gelu: str = "erf"):
    """fc1 + GELU ("erf", "sigmoid" or "hard") + requant: (..., K) int8 rows
    -> (int8 (..., O), f32 (..., 1))."""
    if xq.device.type == "cpu":
        return int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu)
    _, yq, ys = _launch("gelu_quant", xq, xs, wq, ws, bias, gelu=gelu)
    return yq, ys


def int8_matmul_res_ln_quant(xq, xs, wq, ws, bias, res, ln_scale, ln_bias,
                             eps: float = 1e-6):
    """proj/fc2 + residual + next LayerNorm + requant: returns (x' bf16
    (..., O), yq int8 (..., O), ys f32 (..., 1)), yq/ys quantizing LN(x')."""
    if xq.device.type == "cpu":
        return int8_matmul_res_ln_quant_plain(xq, xs, wq, ws, bias, res,
                                              ln_scale, ln_bias, eps)
    return _launch("res_ln_quant", xq, xs, wq, ws, bias, res=res,
                   ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)


def int8_matmul_res(xq, xs, wq, ws, bias, res) -> torch.Tensor:
    """Last fc2 + residual: x' = bf16(res + y), (..., O)."""
    if xq.device.type == "cpu":
        return int8_matmul_res_plain(xq, xs, wq, ws, bias, res)
    return _launch("res", xq, xs, wq, ws, bias, res=res)[0]


def gelu_selftest(n: int, gelu: str = "sigmoid", device="cuda") -> int:
    """On the card: the GEMM epilogue's four-at-a-time GELU (branch-free
    division) against the scalar GELU of the other kernels on 4 * n values;
    returns how many differ in any bit (0 is the contract)."""
    if gelu not in GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; expected one of {list(GELUS)}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.cvt_gelu_selftest(n, GELUS[gelu], bad.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gelu self-test")
    return int(bad.item())
