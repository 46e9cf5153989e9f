"""LR schedule (``chess_vision_tpu/train/schedule.py``): linear warm-up from
0, then cosine decay to 0, stepped per optimizer step; a plain function of the
step, computed on the host."""

from __future__ import annotations

import math


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """Returns ``schedule(step) -> lr`` for an integer step."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step / max(warmup_steps, 1))
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def build_schedule(cfg: dict, steps_per_epoch: int):
    return warmup_cosine_schedule(
        base_lr=cfg["training"]["lr"],
        warmup_steps=cfg["scheduler"]["warmup_epochs"] * steps_per_epoch,
        total_steps=cfg["training"]["epochs"] * steps_per_epoch,
    )
