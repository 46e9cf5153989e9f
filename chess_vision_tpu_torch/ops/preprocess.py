"""Device-side preprocessing: uint8 NHWC -> mean/std-normalized model dtype.

Counterpart of ``chess_vision_tpu/ops/preprocess.py`` ``preprocess_u8``. The
normalize is one fused multiply-add per element with per-channel
``scale = 1/(255*std_c)`` and ``bias = -mean_c/std_c``; on a CUDA tensor it
runs in the hand-written kernel ``csrc/preprocess.cu``, on a CPU tensor in
``preprocess_u8_plain`` (the same arithmetic in PyTorch).
"""

from __future__ import annotations

import numpy as np
import torch

from chess_vision_tpu_torch.ops import _build

# Kernel launches since the last reset (chip_smoke.py proves the main path
# went through the kernel with it).
LAUNCHES = 0

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_MAX_CHANNELS = 8  # NormVec capacity in csrc/preprocess.cu


def norm_vectors(mean, std) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel f32 (scale, bias) exactly as the JAX package derives them
    (``chess_vision_tpu/ops/preprocess.py`` ``_norm_vectors``)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return 1.0 / (255.0 * std), -mean / std


def preprocess_u8_plain(images_u8: torch.Tensor, mean, std,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x.float() * scale + bias``."""
    scale, bias = norm_vectors(mean, std)
    scale = torch.from_numpy(scale).to(images_u8.device)
    bias = torch.from_numpy(bias).to(images_u8.device)
    return (images_u8.float() * scale + bias).to(out_dtype)


def preprocess_u8(images_u8: torch.Tensor, mean, std,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (B, H, W, C) -> normalized (B, H, W, C) in ``out_dtype``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if images_u8.device.type == "cpu":
        return preprocess_u8_plain(images_u8, mean, std, out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {images_u8.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    if images_u8.dim() != 4 or not images_u8.is_contiguous():
        raise ValueError("expected a contiguous (B, H, W, C) tensor, got "
                         f"shape {tuple(images_u8.shape)}")
    channels = images_u8.shape[-1]
    if not 1 <= channels <= _MAX_CHANNELS:
        raise ValueError(f"channels must be 1..{_MAX_CHANNELS}, got {channels}")
    scale, bias = norm_vectors(mean, std)
    if scale.shape != (channels,):
        raise ValueError(f"mean/std have {scale.shape[0]} entries for "
                         f"{channels} channels")
    out = torch.empty(images_u8.shape, dtype=out_dtype,
                      device=images_u8.device)
    lib = _build.library()
    with torch.cuda.device(images_u8.device):
        rc = lib.cvt_preprocess_u8(
            images_u8.data_ptr(), out.data_ptr(), images_u8.numel(), channels,
            scale.ctypes.data, bias.ctypes.data,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "preprocess")
    global LAUNCHES
    LAUNCHES += 1
    return out
