"""Random weights from a seed, made on the device in one draw.

A configuration's reference module gives its parameters as (path, shape,
mean, std) rows (``param_spec``). One normal draw on the device covers them
all; each leaf is mean + std * its slice, rounded to bfloat16 (the type the
cells serve in) and kept as float32, so the program and the reference read
the same numbers. The tree's layout is the checkpoints' (flax's), which the
program's entry points take.
"""

from __future__ import annotations

import numpy as np
import torch


def make_flat(spec: list, seed: int, device) -> torch.Tensor:
    """All leaves of ``spec`` back to back, float32 on ``device``."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    means = torch.tensor([m for _, _, m, _ in spec], device=device)
    stds = torch.tensor([s for _, _, _, s in spec], device=device)
    counts = torch.tensor(sizes, device=device)
    flat = (flat * stds.repeat_interleave(counts)
            + means.repeat_interleave(counts))
    return flat.to(torch.bfloat16).float()


def tree(spec: list, flat) -> dict:
    """Nested dict of views of ``flat`` (a tensor or an array) by path."""
    out: dict = {}
    offset = 0
    for path, shape, _, _ in spec:
        n = int(np.prod(shape))
        node = out
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = flat[offset:offset + n].reshape(shape)
        offset += n
    return out
