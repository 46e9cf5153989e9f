"""TensorBoard + run-metadata logging (the port's own copy of
``chess_vision_tpu/utils/logging.py``, same tags).

Per-step step/loss, step/piece_loss, step/lr; per-epoch
loss/{train,val,ood} and accuracy/{board,square,turn,castling,
full_fen}_{train,val} + accuracy/{board,square}_ood.

Per-step device scalars are buffered and read back in one flush per epoch,
so logging never makes a step wait for the device. The TensorBoard writer is
imported when a logger is made.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from datetime import datetime


def _to_floats(values: list) -> list[float]:
    """Device scalars come back in one stacked copy, not one per step."""
    import torch

    if values and all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([v.detach().float().reshape(()) for v in values]).tolist()
    return [float(v) for v in values]


class MetricLogger:
    def __init__(self, tb_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(tb_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=tb_dir)
        self._pending_steps: list = []

    def log_step(self, step: int, loss, piece_loss, lr) -> None:
        """loss/piece_loss may be device scalars; materialized at flush."""
        self._pending_steps.append((step, loss, piece_loss, lr))

    def flush_steps(self) -> None:
        if not self._pending_steps:
            return
        losses = _to_floats([s[1] for s in self._pending_steps])
        piece_losses = _to_floats([s[2] for s in self._pending_steps])
        for (step, _, _, lr), loss, piece_loss in zip(
                self._pending_steps, losses, piece_losses):
            self.writer.add_scalar("step/loss", loss, step)
            self.writer.add_scalar("step/piece_loss", piece_loss, step)
            if lr is not None:
                self.writer.add_scalar("step/lr", float(lr), step)
        self._pending_steps.clear()

    def log_epoch(self, prefix: str, metrics: dict, epoch: int) -> None:
        self.writer.add_scalar(f"loss/{prefix}", metrics["loss"], epoch)
        for name in ("board", "square", "turn", "castling", "full_fen"):
            self.writer.add_scalar(
                f"accuracy/{name}_{prefix}", metrics[f"{name}_acc"], epoch
            )

    def log_ood(self, metrics: dict, epoch: int) -> None:
        self.writer.add_scalar("accuracy/board_ood", metrics["board_acc"], epoch)
        self.writer.add_scalar("accuracy/square_ood", metrics["square_acc"], epoch)
        self.writer.add_scalar("loss/ood", metrics["loss"], epoch)

    def close(self) -> None:
        self.flush_steps()
        self.writer.close()


def get_git_info():
    try:
        git_hash = (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
        git_dirty = bool(
            subprocess.check_output(
                ["git", "status", "--porcelain"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
        return git_hash, git_dirty
    except Exception:
        return None, None


def write_run_meta(save_dir: str, cfg: dict, **extra) -> str:
    """run_meta.json with argv/config/git provenance."""
    git_hash, git_dirty = get_git_info()
    meta = {
        "timestamp": datetime.now().isoformat(),
        "command": sys.argv,
        "config": cfg,
        "git_hash": git_hash,
        "git_dirty": git_dirty,
        **extra,
    }
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "run_meta.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def update_run_meta(path: str, **extra) -> None:
    with open(path) as f:
        meta = json.load(f)
    meta.update(extra)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
