"""Plain training augmentations and their per-image draws, in f32 on
channel-planar (B, 3, H, W) images in [0, 1].

The recipe (torchvision's definitions): ColorJitter(brightness = contrast =
saturation = 0.3, hue = 0.1) with its four adjustments in a random order per
image, then RandomGrayscale(p = 0.1), then GaussianBlur(5 taps, sigma
0.1-1.5, reflect padding, p = 0.2). ``order`` indexes the 24 orders of
(brightness, contrast, saturation, hue) in lexicographic order. The draws'
keys and meanings are those of the program's ``aug_params`` argument.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

GRAY = (0.2989, 0.587, 0.114)
ORDERS = list(itertools.permutations(range(4)))


def draw(batch: int, gen: torch.Generator) -> dict:
    """Per-image parameters on the generator's device."""
    dev = gen.device

    def uniform(lo=0.0, hi=1.0, shape=None):
        u = torch.rand(shape or (batch,), generator=gen, device=dev)
        return lo + (hi - lo) * u

    return {"brightness": uniform(0.7, 1.3), "contrast": uniform(0.7, 1.3),
            "saturation": uniform(0.7, 1.3), "hue": uniform(-0.1, 0.1),
            "order": torch.randint(0, len(ORDERS), (batch,), generator=gen,
                                   device=dev),
            "gray_u": uniform(), "blur_u": uniform(),
            "sigma": uniform(0.1, 1.5),
            "perm_u": uniform(),
            "channel_perm": torch.rand((batch, 3), generator=gen,
                                       device=dev).argsort(dim=1),
            "invert_u": uniform()}


def gray(x: torch.Tensor) -> torch.Tensor:
    return GRAY[0] * x[0] + GRAY[1] * x[1] + GRAY[2] * x[2]


def rgb_to_hsv(x: torch.Tensor):
    r, g, b = x
    maxc = torch.max(torch.max(r, g), b)
    minc = torch.min(torch.min(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    d = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / d, (maxc - g) / d, (maxc - b) / d
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, h, torch.zeros_like(h))
    return torch.remainder(h / 6.0, 1.0), s, maxc


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)
    table = torch.stack([torch.stack(c) for c in ((v, q, p, p, t, v),
                                                  (t, v, v, q, p, p),
                                                  (p, p, t, v, v, q))])
    return table.gather(1, i[None, None].expand(3, 1, *i.shape))[:, 0]


def adjust(x: torch.Tensor, op: int, p: dict, k: int) -> torch.Tensor:
    """One jitter step on image ``k`` (3, H, W)."""
    if op == 0:
        return (x * p["brightness"][k]).clamp(0, 1)
    if op == 1:
        f = p["contrast"][k]
        return (f * x + (1 - f) * gray(x).mean()).clamp(0, 1)
    if op == 2:
        f = p["saturation"][k]
        return (f * x + (1 - f) * gray(x)).clamp(0, 1)
    h, s, v = rgb_to_hsv(x)
    return hsv_to_rgb(torch.remainder(h + p["hue"][k], 1.0), s, v).clamp(0, 1)


def blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian of ``sigma`` along both axes, reflect padding."""
    pos = torch.arange(5, dtype=torch.float32, device=x.device) - 2.0
    k = torch.exp(-0.5 * (pos / sigma) ** 2)
    k = k / k.sum()
    y = F.pad(x[None], (0, 0, 2, 2), mode="reflect")[0]
    y = sum(k[i] * y[:, i:i + x.shape[1]] for i in range(5))
    y = F.pad(y[None], (2, 2, 0, 0), mode="reflect")[0]
    return sum(k[i] * y[:, :, i:i + x.shape[2]] for i in range(5))


def apply(x: torch.Tensor, p: dict) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> augmented, image by image."""
    out = []
    for k in range(x.shape[0]):
        img = x[k]
        for op in ORDERS[int(p["order"][k])]:
            img = adjust(img, op, p, k)
        if p["gray_u"][k] < 0.1:
            img = gray(img).expand(3, -1, -1)
        if p["blur_u"][k] < 0.2:
            img = blur(img, p["sigma"][k])
        out.append(img)
    return torch.stack(out)


def ycbcr420_to_rgb01(y: torch.Tensor, cb: torch.Tensor,
                      cr: torch.Tensor) -> torch.Tensor:
    """uint8 Y (B, S, S), Cb and Cr (B, S/2, S/2) -> RGB (B, 3, S, S) in
    [0, 1]: chroma upsampled bilinearly with half-pixel centres (libjpeg's
    fancy upsampling), JFIF full-range BT.601."""
    cbf, crf = (F.interpolate(c.float()[:, None], size=y.shape[-2:],
                              mode="bilinear", align_corners=False)[:, 0] - 128.0
                for c in (cb, cr))
    yf = y.float()
    rgb = torch.stack([yf + 1.402 * crf,
                       yf - 0.344136 * cbf - 0.714136 * crf,
                       yf + 1.772 * cbf], dim=1)
    return rgb.clamp(0.0, 255.0) / 255.0
