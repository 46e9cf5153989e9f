"""Training augmentations on the device (``chess_vision_tpu/augment.py``).

The recipe of the JAX package, batched and channel-planar (B, 3, H, W), in
f32: ColorJitter(brightness = contrast = saturation = 0.3, hue = 0.1) with
its four adjustments in a random order per image -> RandomGrayscale(p = 0.1)
-> GaussianBlur(k = 5, sigma 0.1-1.5, p = 0.2) -> optional channel
permutation and inversion (off by default) -> normalize. No flip and no crop:
both destroy the labels of a chess board.

Drawing and applying are split. ``draw_params`` draws every image's
parameters from a ``torch.Generator``; ``apply_augment`` applies given
parameters, so a test can hand both packages the same draws (the two
frameworks' generators give different numbers from one seed). The formulas,
op order, ranges and probabilities are the JAX package's.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from chess_vision_tpu_torch.ops.preprocess import (
    ycbcr420_to_rgb,
    ycbcr420_to_rgb_planar,
)

_GRAY = (0.2989, 0.587, 0.114)  # ITU-R 601 luma weights

# torchvision ColorJitter ranges for (0.3, 0.3, 0.3, 0.1)
BRIGHTNESS = (0.7, 1.3)
CONTRAST = (0.7, 1.3)
SATURATION = (0.7, 1.3)
HUE = (-0.1, 0.1)
SIGMA = (0.1, 1.5)
GRAYSCALE_P = 0.1
BLUR_P = 0.2

PERMS = list(itertools.permutations(range(4)))  # 24 orders of the 4 ops


def draw_params(batch: int, generator: torch.Generator) -> dict:
    """Per-image augmentation parameters on the generator's device:
    ``brightness``, ``contrast``, ``saturation``, ``hue`` (B,) factors;
    ``order`` (B,) index into ``PERMS``; ``gray_u``, ``blur_u`` (B,) uniforms
    compared with the probabilities; ``sigma`` (B,); ``perm_u``, ``invert_u``
    (B,) uniforms and ``channel_perm`` (B, 3) for the optional extras."""
    dev = generator.device

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=generator, device=dev)
        return lo + (hi - lo) * u

    return {
        "brightness": uniform(*BRIGHTNESS),
        "contrast": uniform(*CONTRAST),
        "saturation": uniform(*SATURATION),
        "hue": uniform(*HUE),
        "order": torch.randint(0, len(PERMS), (batch,), generator=generator,
                               device=dev),
        "gray_u": uniform(),
        "blur_u": uniform(),
        "sigma": uniform(*SIGMA),
        "perm_u": uniform(),
        "channel_perm": torch.rand((batch, 3), generator=generator,
                                   device=dev).argsort(dim=1),
        "invert_u": uniform(),
    }


def _gray_p(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W) luma."""
    return (_GRAY[0] * x[:, 0] + _GRAY[1] * x[:, 1] + _GRAY[2] * x[:, 2])[:, None]


def _rgb_to_hsv_p(x: torch.Tensor):
    """(B, 3, H, W) -> h, s, v each (B, H, W)."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-12), zero)
    dsafe = deltac.clamp_min(1e-12)
    rc = (maxc - r) / dsafe
    gc = (maxc - g) / dsafe
    bc = (maxc - b) / dsafe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, h, zero)
    h = torch.remainder(h / 6.0, 1.0)
    return h, s, maxc


def _select6(i: torch.Tensor, opts) -> torch.Tensor:
    out = opts[5]
    for k in range(4, -1, -1):
        out = torch.where(i == k, opts[k], out)
    return out


def _hsv_to_rgb_p(h, s, v) -> torch.Tensor:
    """h, s, v (B, H, W) -> (B, 3, H, W)."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select6(i, (v, q, p, p, t, v))
    g = _select6(i, (t, v, v, q, p, p))
    b = _select6(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=1)


def _c1(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _color_jitter(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Random-order color jitter: at each of the 4 positions all 4
    adjustments are computed for the whole batch, and each image takes the
    one its order puts there."""
    fb, fc, fs = (_c1(params[k]) for k in ("brightness", "contrast", "saturation"))
    fh = params["hue"][:, None, None]
    perms = torch.tensor(PERMS, dtype=torch.int64, device=x.device)
    order = perms[params["order"].long()]  # (B, 4)

    def bright(im):
        return (im * fb).clamp(0.0, 1.0)

    def contrast(im):
        mean = _c1(_gray_p(im).mean(dim=(1, 2, 3)))
        return (fc * im + (1.0 - fc) * mean).clamp(0.0, 1.0)

    def saturation(im):
        return (fs * im + (1.0 - fs) * _gray_p(im)).clamp(0.0, 1.0)

    def hue(im):
        h, s, v = _rgb_to_hsv_p(im)
        return _hsv_to_rgb_p(torch.remainder(h + fh, 1.0), s, v).clamp(0.0, 1.0)

    for j in range(4):
        opid = _c1(order[:, j])
        x = torch.where(
            opid == 0, bright(x),
            torch.where(opid == 1, contrast(x),
                        torch.where(opid == 2, saturation(x), hue(x))))
    return x


def _gaussian_kernel_1d(sigma: torch.Tensor, size: int = 5) -> torch.Tensor:
    """(B,) sigmas -> (B, size) normalized kernels."""
    pos = torch.arange(size, dtype=torch.float32, device=sigma.device)
    pos = pos - (size - 1) / 2.0
    k = torch.exp(-0.5 * (pos[None, :] / sigma[:, None]) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def _gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, size: int = 5):
    """Separable 5-tap blur with a sigma per image and reflect padding."""
    pad = size // 2
    H, W = x.shape[2], x.shape[3]
    k1 = _gaussian_kernel_1d(sigma, size)
    xp = F.pad(x, (0, 0, pad, pad), mode="reflect")
    y = sum(_c1(k1[:, i]) * xp[:, :, i:i + H] for i in range(size))
    yp = F.pad(y, (pad, pad, 0, 0), mode="reflect")
    return sum(_c1(k1[:, i]) * yp[:, :, :, i:i + W] for i in range(size))


def apply_augment(x: torch.Tensor, params: dict, channel_perm_p: float = 0.0,
                  invert_p: float = 0.0) -> torch.Tensor:
    """Augment planar (B, 3, H, W) f32 images in [0, 1] with the given
    per-image parameters (``draw_params``)."""
    x = _color_jitter(x, params)
    x = torch.where(_c1(params["gray_u"]) < GRAYSCALE_P,
                    _gray_p(x).expand_as(x), x)
    x = torch.where(_c1(params["blur_u"]) < BLUR_P,
                    _gaussian_blur(x, params["sigma"]), x)
    if channel_perm_p > 0.0:
        index = params["channel_perm"].long()[:, :, None, None].expand_as(x)
        x = torch.where(_c1(params["perm_u"]) < channel_perm_p,
                        x.gather(1, index), x)
    if invert_p > 0.0:
        x = torch.where(_c1(params["invert_u"]) < invert_p, 1.0 - x, x)
    return x


def _batch_rgb01_planar(batch: dict) -> torch.Tensor:
    """[0, 1] RGB (B, 3, H, W) from a loader batch of either transport."""
    if "image" in batch:
        return batch["image"].permute(0, 3, 1, 2).float() / 255.0
    return ycbcr420_to_rgb_planar(batch["y"], batch["cb"], batch["cr"]) / 255.0


def preprocess_train_batch(batch: dict, params: dict, mean, std,
                           channel_perm_p: float = 0.0,
                           invert_p: float = 0.0) -> torch.Tensor:
    """Loader batch -> augmented, normalized f32 (B, H, W, 3): rebuilt,
    augmented and normalized planar, moved to the model's NHWC once at the
    end."""
    x = apply_augment(_batch_rgb01_planar(batch), params, channel_perm_p,
                      invert_p)
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)[None, :, None, None]
    std = torch.tensor(std, dtype=torch.float32, device=x.device)[None, :, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()


def preprocess_eval_batch(batch: dict, mean, std) -> torch.Tensor:
    """Loader batch -> normalized f32 (B, H, W, 3), no augmentation."""
    if "image" in batch:
        x = batch["image"].float() / 255.0
    else:
        x = ycbcr420_to_rgb(batch["y"], batch["cb"], batch["cr"]) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
