"""Board images and labels from a seed, drawn on the device in bulk.

A board is 8x8 squares in two random colours, with a piece on ~45% of the
squares: a disk whose radius follows the piece type and whose shade follows
its colour, over per-pixel noise. Labels are the 13 joint classes (0 empty,
1-6 white P N B R Q K, 7-12 black), a turn bit (1: black to move) and four
castling bits (K, Q, k, q).

``boards`` gives uint8 (n, S, S, 3) RGB, for serving; ``corpus`` the same
boards as flattened YCbCr 4:2:0 planes (Y, then Cb and Cr at half size;
JFIF full-range BT.601) with (n, 70) float32 labels (squares, turn,
castling, legal), the layout of the program's device-resident corpus.
"""

from __future__ import annotations

import torch

OCCUPIED = 0.45


def draw_labels(n: int, gen: torch.Generator, device) -> dict:
    occupied = torch.rand((n, 64), generator=gen, device=device) < OCCUPIED
    pieces = torch.randint(1, 13, (n, 64), generator=gen, device=device)
    return {"squares": torch.where(occupied, pieces, 0),
            "turn": torch.rand((n, 1), generator=gen, device=device) < 0.5,
            "castling": torch.rand((n, 4), generator=gen, device=device) < 0.5}


def render(squares: torch.Tensor, size: int,
           gen: torch.Generator) -> torch.Tensor:
    """(b, 64) classes -> uint8 (b, size, size, 3) boards."""
    b = squares.shape[0]
    dev = squares.device
    light = 150 + 90 * torch.rand((b, 1, 1, 3), generator=gen, device=dev)
    dark = 60 + 90 * torch.rand((b, 1, 1, 3), generator=gen, device=dev)
    pix = torch.arange(size, device=dev)
    side = size // 8
    row, col = pix // side, pix // side
    square = (row[:, None] * 8 + col[None, :]).reshape(-1)          # (S*S,)
    u = ((pix % side).float() + 0.5) / side - 0.5
    dist = torch.sqrt(u[:, None] ** 2 + u[None, :] ** 2)            # (S, S)
    dark_sq = ((row[:, None] + col[None, :]) % 2 == 1)[None, :, :, None]
    img = torch.where(dark_sq, dark, light)
    cls = squares[:, square].reshape(b, size, size)
    kind = torch.where(cls > 6, cls - 6, cls)
    inside = (cls > 0) & (dist[None] < 0.12 + 0.045 * kind)
    shade = torch.where(cls > 6, 25.0, 235.0)[..., None]
    img = torch.where(inside[..., None], shade, img)
    img = img + 12 * torch.rand(img.shape, generator=gen, device=dev) - 6
    return img.round().clamp(0, 255).to(torch.uint8)


def boards(n: int, size: int, seed: int, device, chunk: int = 256):
    """uint8 (n, size, size, 3) boards on the host, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    squares = draw_labels(n, gen, device)["squares"]
    out = torch.empty((n, size, size, 3), dtype=torch.uint8)
    for start in range(0, n, chunk):
        out[start:start + chunk] = render(squares[start:start + chunk], size,
                                          gen).cpu()
    return out.numpy()


def to_ycbcr420(img: torch.Tensor) -> torch.Tensor:
    """uint8 (b, S, S, 3) RGB -> uint8 (b, S*S*3/2): Y, Cb, Cr planes, the
    chroma averaged over 2x2 pixels."""
    x = img.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    planes = [y] + [torch.nn.functional.avg_pool2d(c[:, None], 2)[:, 0]
                    for c in (cb, cr)]
    return torch.cat([p.round().clamp(0, 255).to(torch.uint8).flatten(1)
                      for p in planes], dim=1)


def corpus(n: int, size: int, seed: int, device, chunk: int = 256):
    """(uint8 (n, S*S*3/2) planes, float32 (n, 70) labels), both on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = draw_labels(n, gen, device)
    pixels = torch.empty((n, size * size * 3 // 2), dtype=torch.uint8,
                         device=device)
    for start in range(0, n, chunk):
        pixels[start:start + chunk] = to_ycbcr420(
            render(labels["squares"][start:start + chunk], size, gen))
    rows = torch.cat([labels["squares"].float(), labels["turn"].float(),
                      labels["castling"].float(),
                      torch.ones((n, 1), device=device)], dim=1)
    return pixels, rows


def class_weights(squares: torch.Tensor, classes: int = 13) -> torch.Tensor:
    """Inverse square-root class frequencies over ``squares``, normalized to
    mean 1 (frequencies floored at 1e-6)."""
    counts = torch.bincount(squares.reshape(-1).long(), minlength=classes)
    freq = counts.double() / counts.sum()
    w = 1.0 / torch.sqrt(freq.clamp_min(1e-6))
    return (w / w.mean()).float()
