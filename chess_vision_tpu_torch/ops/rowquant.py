"""Fused pre-op + per-row dynamic int8 quantization.

Counterpart of ``chess_vision_tpu/ops/quant.py`` ``fused_rowquant`` (K7 on
(B, N, D), K6 on flat (M, D); the math is row-local, so one function takes
any (..., D)). On a CUDA tensor it runs the hand-written kernel
``csrc/rowquant.cu`` (one warp per row, the row read once); on a CPU tensor
``rowquant_plain``, the same arithmetic in PyTorch. The GELU forms here are
also the plain versions of the int8 GEMM's epilogue (``ops/int8_matmul.py``).
"""

from __future__ import annotations

import math

import torch

from chess_vision_tpu_torch.ops import _build

# Kernel launches since the last reset (chip_smoke.py proves the main path
# went through the kernel with it).
LAUNCHES = 0

MODES = {"none": 0, "ln": 1, "gelu": 2, "gelu_sigmoid": 3, "gelu_hard": 4}
_IN_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 4096  # 16 chunks of 8 values per lane in csrc/rowquant.cuh


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7), the JAX
    package's ``_erf``: its Pallas kernels have no erf primitive."""
    a = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4]))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_as(x * (1.0 / math.sqrt(2.0))))


def gelu_sigmoid_mul(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) in the row-quant kernel's form."""
    return x * (1.0 / (1.0 + torch.exp(-1.702 * x)))


def gelu_sigmoid_div(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) in the int8 GEMM epilogue's form."""
    return x / (1.0 + torch.exp(-1.702 * x))


def gelu_hard(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(0.4255 * x + 0.5, 0.0, 1.0)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (..., D) -> (int8 (..., D), f32 (..., 1)): symmetric per-row
    abs-max quantization, rounding half to even, amax floored at 1e-8. The
    codes take the quotient fl(127 / amax), as the JAX kernel and the CUDA
    kernels do: PyTorch evaluates ``127.0 / amax`` as fl(1 / amax) * 127,
    which is one unit off it for a quarter of all amax."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    inv = torch.full_like(amax, 127.0) / amax
    q = torch.round(x * inv).clamp(-127, 127).to(torch.int8)
    return q, amax * (1.0 / 127.0)


def layernorm_f32(x: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32, output left in f32. Two-pass
    statistics: the mean, then the mean of squared deviations. The inverse
    standard deviation rounds as the kernels' (``rowquant.cuh``:
    ``__fdiv_rn(1, __fsqrt_rn(var + eps))``): a correctly rounded f32
    square root, taken in f64 and rounded once (torch's f32 ``sqrt`` is not
    correctly rounded on every CPU, its ``rsqrt`` not on the card), then an
    IEEE division."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    cen = x - mu
    var = cen.square().mean(dim=-1, keepdim=True)
    inv_std = 1.0 / torch.sqrt((var + eps).double()).float()
    return (cen * inv_std * scale.float().to(x.device)
            + bias.float().to(x.device))


def rowquant_plain(x: torch.Tensor, mode: str = "none", ln_scale=None,
                   ln_bias=None, eps: float = 1e-6):
    """Plain PyTorch version of the kernel, in f32, the JAX order of
    operations: (..., D) -> (int8 (..., D), f32 (..., 1))."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    x = x.float()
    if mode == "ln":
        x = layernorm_f32(x, ln_scale, ln_bias, eps)
    elif mode == "gelu":
        x = gelu_erf(x)
    elif mode == "gelu_sigmoid":
        x = gelu_sigmoid_mul(x)
    elif mode == "gelu_hard":
        x = gelu_hard(x)
    return quantize_rows(x)


def f32_vector(v, n: int, device, what: str) -> torch.Tensor:
    """A per-column parameter as a contiguous f32 (n,) tensor on ``device``
    for a kernel, or raise."""
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32).contiguous()
    if v.shape != (n,):
        raise ValueError(f"{what} of shape {tuple(v.shape)}, expected ({n},)")
    return v


def fused_rowquant(x: torch.Tensor, mode: str = "none", ln_scale=None,
                   ln_bias=None, eps: float = 1e-6):
    """(..., D) bf16/f32 -> (int8 (..., D), f32 (..., 1) scales).

    mode: "none", "ln" (two-pass LayerNorm first; ln_scale and ln_bias
    required), "gelu" (erf), "gelu_sigmoid", "gelu_hard". A CPU tensor takes
    ``rowquant_plain``; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return rowquant_plain(x, mode, ln_scale, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"the row-quant kernel takes {_IN_DTYPES}, got {x.dtype}")
    D = x.shape[-1]
    if D % 8 or not 8 <= D <= _MAX_D:
        raise ValueError(f"row width {D} must be a multiple of 8 in 8..{_MAX_D}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    g = b = None
    if mode == "ln":
        if ln_scale is None or ln_bias is None:
            raise ValueError("mode 'ln' needs ln_scale and ln_bias")
        g = f32_vector(ln_scale, D, x.device, "ln_scale")
        b = f32_vector(ln_bias, D, x.device, "ln_bias")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if q.numel() == 0:
        return q, s
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.cvt_rowquant(
            x.data_ptr(), int(x.dtype == torch.float32), x.numel() // D, D,
            MODES[mode], g.data_ptr() if g is not None else None,
            b.data_ptr() if b is not None else None, eps, q.data_ptr(),
            s.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "row-quant")
    global LAUNCHES
    LAUNCHES += 1
    return q, s
