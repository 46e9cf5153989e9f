"""Overlapping per-square crops, resized, as two matrix products
(``chess_vision_tpu/ops/square_crop.py``).

Each of the 64 crops (a window of int(square * overlap) pixels around its
square, the board edge-padded by (crop - square) // 2, resized bilinearly
with half-pixel centers) is a fixed linear map of the padded board:

    out[b, r, s, i, j, c] = sum_{h,w} R[r, i, h] * padded[b, h, w, c] * R[s, j, w]

where R[r] is the resize matrix placed on square-row r's window. The JAX
package computes it with two einsums, in the images' dtype: in bf16 the
bilinear weights themselves are rounded to bf16. In f32 the products run
with TF32 off (``layers.full_f32``), the counterpart of its
``precision="highest"``.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext

import numpy as np
import torch
import torch.nn.functional as F


def _resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, half-pixel centers
    (``F.interpolate(mode="bilinear", align_corners=False)`` upsampling)."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == in_size:
        np.fill_diagonal(mat, 1.0)
        return mat
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        mat[i, lo] += 1.0 - frac
        mat[i, hi] += frac
    return mat


@functools.lru_cache(maxsize=8)
def _crop_matrices(img_size: int, overlap: float,
                   out_size: int) -> tuple[np.ndarray, int]:
    """The (8, out_size, padded_size) crop-and-resize matrix of the square
    rows (the columns use the same) and the padding."""
    sq = img_size // 8
    crop = int(sq * overlap)
    pad = (crop - sq) // 2
    padded = img_size + 2 * pad
    resize = _resize_matrix(out_size, crop)
    combined = np.zeros((8, out_size, padded), dtype=np.float32)
    for r in range(8):
        combined[r, :, r * sq:r * sq + crop] = resize
    return combined, pad


def crop_squares(images: torch.Tensor, overlap: float = 1.5,
                 out_size: int = 64) -> torch.Tensor:
    """(B, H, H, C) NHWC boards -> (B, 64, out_size, out_size, C) crops in
    square order (0 = a8's region at the top left ... 63 = h1's), in the
    images' dtype."""
    from chess_vision_tpu_torch.models.layers import full_f32

    B, H, W, C = images.shape
    if H != W:
        raise ValueError(f"Expected square images, got {H}x{W}")
    mat_np, pad = _crop_matrices(H, overlap, out_size)
    mat = torch.from_numpy(mat_np).to(device=images.device, dtype=images.dtype)
    padded = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="replicate").permute(0, 2, 3, 1)
    with full_f32() if images.dtype == torch.float32 else nullcontext():
        t = torch.einsum("rih,bhwc->briwc", mat, padded)
        out = torch.einsum("briwc,sjw->brsijc", t, mat)
    return out.reshape(B, 64, out_size, out_size, C)
