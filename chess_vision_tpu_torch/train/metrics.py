"""Metric accumulation on the device (``chess_vision_tpu/train/metrics.py``).

Each step returns a small dict of summed counts as 0-d f32 tensors on the
model's device; they are added up there and read back once per epoch
(``finalize``), so no step waits on a device-to-host copy.
"""

from __future__ import annotations

import torch

METRIC_SUM_KEYS = (
    "loss_sum", "squares_correct", "boards_correct", "turn_correct",
    "castling_rights_correct", "castling_all_correct", "full_fen_correct",
    "n",
)


@torch.no_grad()
def batch_metric_sums(outputs: dict, batch: dict, loss: torch.Tensor) -> dict:
    """Summed counts of one batch; ``batch["mask"]`` (if present) excludes
    padded rows from every count."""
    sq_logits = outputs["squares"].reshape(-1, 64, 13)
    sq_labels = batch["squares"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(sq_labels.shape[0], dtype=torch.float32,
                          device=sq_labels.device)
    n_real = mask.sum()

    sq_correct = sq_logits.argmax(dim=-1) == sq_labels
    board_correct = sq_correct.all(dim=1)
    turn_correct = ((outputs["turn"] > 0).float() == batch["turn"])[:, 0]
    castling_right_correct = (outputs["castling"] > 0).float() == batch["castling"]
    castling_all_correct = castling_right_correct.all(dim=1)
    full_correct = board_correct & turn_correct & castling_all_correct

    msum = lambda x, m: (x.float() * m).sum()  # noqa: E731
    return {
        "loss_sum": loss.detach().float() * n_real,
        "squares_correct": msum(sq_correct, mask[:, None]),
        "boards_correct": msum(board_correct, mask),
        "turn_correct": msum(turn_correct, mask),
        "castling_rights_correct": msum(castling_right_correct, mask[:, None]),
        "castling_all_correct": msum(castling_all_correct, mask),
        "full_fen_correct": msum(full_correct, mask),
        "n": n_real,
    }


def accumulate(total: dict | None, sums: dict) -> dict:
    if total is None:
        return dict(sums)
    return {k: total[k] + v for k, v in sums.items()}


def finalize(total: dict) -> dict:
    """Read the accumulated sums back (one stacked copy) into the metric dict."""
    keys = list(total)
    values = torch.stack([total[k].float() for k in keys]).tolist()
    t = dict(zip(keys, values))
    n = max(t["n"], 1.0)
    return {
        "loss": t["loss_sum"] / n,
        "square_acc": t["squares_correct"] / (n * 64),
        "board_acc": t["boards_correct"] / n,
        "turn_acc": t["turn_correct"] / n,
        "castling_right_acc": t["castling_rights_correct"] / (n * 4),
        "castling_acc": t["castling_all_correct"] / n,
        "full_fen_acc": t["full_fen_correct"] / n,
    }
