"""Loss functions (``chess_vision_tpu/train/losses.py``), in f32.

Weighted, label-smoothed cross entropy on the square logits plus binary cross
entropy on turn and castling. ``torch.nn.functional.cross_entropy`` has the
same weighting and smoothing semantics but takes no sample mask, so the masked
form is written out as the JAX package writes it:

  - NLL term: per-sample weight w[y_i]; the mean divides by sum_i w[y_i]
  - smoothing term: -(sum_c w_c * logp_ic) over the same denominator
  - total = (1 - s) * nll_term + (s / K) * smooth_term

A ``sample_mask`` zeroes padded rows out of every sum.

Over several devices each rank holds a slice of the global batch; given the
global batch's denominators (``total_loss(..., reduce=...)``), a rank's
loss is its share of the global loss, so the shares and their gradients sum
over the ranks to the one-device values (an average of per-rank means would
be another number wherever class weights or the mask differ by rank).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_smoothed_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
    label_smoothing: float = 0.0,
    sample_mask: torch.Tensor | None = None,
    denom: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean cross entropy over (N, K) logits and (N,) integer labels;
    ``denom`` replaces the sum of the per-sample weights (``sample_weights``)
    as the divisor."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    w_vec, w_per_sample = sample_weights(labels, num_classes, class_weights,
                                         sample_mask)
    if denom is None:
        denom = w_per_sample.sum()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    nll_term = (nll * w_per_sample).sum() / denom
    if label_smoothing == 0.0:
        return nll_term
    smooth = -(logp * w_vec).sum(dim=-1)
    if sample_mask is not None:
        smooth = smooth * sample_mask
    smooth_term = smooth.sum() / denom
    return ((1.0 - label_smoothing) * nll_term
            + (label_smoothing / num_classes) * smooth_term)


def sample_weights(labels: torch.Tensor, num_classes: int, class_weights,
                   sample_mask: torch.Tensor | None):
    """(class weight vector (K,), per-sample weights w[y_i] times the mask)."""
    if class_weights is None:
        w_vec = torch.ones(num_classes, dtype=torch.float32, device=labels.device)
        w_per_sample = torch.ones(labels.shape, dtype=torch.float32,
                                  device=labels.device)
    else:
        w_vec = class_weights.float()
        w_per_sample = w_vec[labels.long()]
    if sample_mask is not None:
        w_per_sample = w_per_sample * sample_mask
    return w_vec, w_per_sample


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
    denom: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean binary cross entropy on logits; ``sample_mask`` (N,) excludes
    padded rows from the mean. ``denom`` replaces the divisor (the number of
    elements, or of masked-in rows times the columns)."""
    x = logits.float()
    z = targets.float()
    loss = x.clamp_min(0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    if sample_mask is None:
        return loss.mean() if denom is None else loss.sum() / denom
    m = sample_mask[:, None]
    if denom is None:
        denom = (m.sum() * loss.shape[-1]).clamp_min(1.0)
    return (loss * m).sum() / denom


def total_loss(outputs: dict, batch: dict, class_weights, label_smoothing: float,
               turn_weight: float, castling_weight: float, reduce=None):
    """piece + turn_weight * turn + castling_weight * castling. Returns
    (loss, dict of the three components). ``reduce`` sums a tensor over the
    data-parallel ranks: the denominators are then the global batch's and
    the loss is this rank's share of the global loss."""
    num_classes = 13
    mask = batch.get("mask")
    sq_mask = None if mask is None else mask.repeat_interleave(64)
    labels = batch["squares"].reshape(-1)
    denoms = [None] * 3
    if reduce is not None:
        _, w = sample_weights(labels, num_classes, class_weights, sq_mask)
        rows = (torch.tensor(float(labels.shape[0] // 64), device=w.device)
                if mask is None else mask.sum())
        summed = reduce(torch.stack([w.sum(), rows.float()]))
        rows = summed[1] if mask is None else summed[1].clamp_min(1.0)
        denoms = [summed[0], rows * outputs["turn"].shape[-1],
                  rows * outputs["castling"].shape[-1]]
    piece_loss = weighted_smoothed_cross_entropy(
        outputs["squares"].reshape(-1, num_classes), labels, class_weights,
        label_smoothing, sq_mask, denom=denoms[0])
    turn_loss = bce_with_logits(outputs["turn"], batch["turn"], mask,
                                denom=denoms[1])
    castling_loss = bce_with_logits(outputs["castling"], batch["castling"],
                                    mask, denom=denoms[2])
    loss = piece_loss + turn_weight * turn_loss + castling_weight * castling_loss
    return loss, {"piece_loss": piece_loss, "turn_loss": turn_loss,
                  "castling_loss": castling_loss}
