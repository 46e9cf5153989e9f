"""Device-side preprocessing: uint8 NHWC -> mean/std-normalized model dtype.

Counterpart of ``chess_vision_tpu/ops/preprocess.py`` ``preprocess_u8``. The
normalize is one fused multiply-add per element with per-channel
``scale = 1/(255*std_c)`` and ``bias = -mean_c/std_c``; on a CUDA tensor it
runs in the hand-written kernel ``csrc/preprocess.cu``, on a CPU tensor in
``preprocess_u8_plain`` (the same arithmetic in PyTorch).

The YCbCr 4:2:0 transport (``ycbcr420_to_rgb``, ``ycbcr420_to_rgb_planar``,
``ycbcr420_to_normalized``; the JAX package's functions of those names, plain
array code there as here) rebuilds RGB on the device from the JPEG's own
planes, which halves the host-to-device bytes; ``rgb_to_ycbcr420`` is the
numpy host side for images the native 4:2:0 decoder does not take.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _ycbcr420_rgb_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    size = y.shape[-2:]
    # bilinear chroma upsample with half-pixel centers: the triangle filter of
    # libjpeg's fancy upsampler
    up = lambda c: F.interpolate(  # noqa: E731
        c.float()[:, None], size=size, mode="bilinear", align_corners=False)[:, 0]
    yf = y.float()
    cbf = up(cb) - 128.0
    crf = up(cr) - 128.0
    r = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    return r, g, b


def ycbcr420_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
    """Subsampled JPEG planes -> RGB f32 in [0, 255], (B, S, S, 3).

    Y (B, S, S) uint8, Cb and Cr (B, S/2, S/2) uint8, as
    ``native.decode_ycbcr420`` gives them; JFIF full-range BT.601 matrix."""
    return torch.stack(_ycbcr420_rgb_planes(y, cb, cr), dim=-1).clamp(0.0, 255.0)


def ycbcr420_to_rgb_planar(y: torch.Tensor, cb: torch.Tensor,
                           cr: torch.Tensor) -> torch.Tensor:
    """``ycbcr420_to_rgb`` with channel-planar (B, 3, S, S) output, the
    layout the training augmentations run in."""
    return torch.stack(_ycbcr420_rgb_planes(y, cb, cr), dim=1).clamp(0.0, 255.0)


def ycbcr420_to_normalized(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                           mean, std, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Planes -> mean/std-normalized RGB (B, S, S, 3) in ``out_dtype``."""
    rgb = ycbcr420_to_rgb(y, cb, cr)
    mean = torch.tensor(mean, dtype=torch.float32, device=rgb.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=rgb.device) * 255.0
    return ((rgb - mean) / std).to(out_dtype)


def rgb_to_ycbcr420(img: np.ndarray):
    """Host side: uint8 (S, S, 3) RGB -> (Y, Cb, Cr) uint8 planes (JFIF
    BT.601, 2x2 box-averaged chroma)."""
    f = img.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    sub = lambda c: c.reshape(  # noqa: E731
        c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean(axis=(1, 3))
    clip = lambda c: np.clip(c + 0.5, 0, 255).astype(np.uint8)  # noqa: E731
    return clip(y), clip(sub(cb)), clip(sub(cr))
