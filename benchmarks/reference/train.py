"""A plain training step in f32: augment, forward, loss, backward, clip,
AdamW.

Loss: the square logits' cross entropy with class weights w and label
smoothing s, (1 - s) * sum_i w[y_i] nll_i / sum_i w[y_i] + (s / 13) *
sum_i sum_c -w_c log p_ic / sum_i w[y_i], plus the binary cross entropies of
the turn and the castling flags (means), each weighted by its config weight.
Update: the gradient's global norm g; at or above the clip c every gradient
is scaled by c / g. AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on
every parameter) at the step's rate: linear warm-up from 0 over the warm-up
epochs, then cosine to 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference import augment

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree: dict, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(value, dict):
            yield from leaves(value, path)
        else:
            yield path, value


def rebuild(names, tensors) -> dict:
    """The tree whose leaves at ``names`` ("a/b/c") are ``tensors``."""
    out: dict = {}
    for path, t in zip(names, tensors):
        node = out
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = t
    return out


def learning_rate(step: int, tcfg: dict, steps_per_epoch: int) -> float:
    base = tcfg["training"]["lr"]
    warm = tcfg["scheduler"]["warmup_epochs"] * steps_per_epoch
    total = tcfg["training"]["epochs"] * steps_per_epoch
    if step < warm:
        return base * step / max(warm, 1)
    progress = (step - warm) / max(total - warm, 1)
    return base * 0.5 * (1.0 + math.cos(math.pi * progress))


def loss_fn(out: dict, labels: torch.Tensor, class_weights, tcfg: dict):
    """``labels`` (B, 70): squares, turn, castling, legal."""
    t = tcfg["training"]
    squares = labels[:, :64].reshape(-1).long()
    logp = F.log_softmax(out["squares"].reshape(-1, 13), dim=-1)
    w = (class_weights if class_weights is not None
         else torch.ones(13, device=logp.device))
    per = w[squares]
    denom = per.sum()
    nll = -(logp.gather(1, squares[:, None])[:, 0] * per).sum() / denom
    smooth = -(logp * w).sum() / denom
    s = t.get("label_smoothing", 0.0)
    piece = (1 - s) * nll + (s / 13) * smooth
    turn = F.binary_cross_entropy_with_logits(out["turn"], labels[:, 64:65])
    castling = F.binary_cross_entropy_with_logits(out["castling"],
                                                  labels[:, 65:69])
    return (piece + t.get("turn_loss_weight", 1.0) * turn
            + t.get("castling_loss_weight", 1.0) * castling)


def images(pixels: torch.Tensor, size: int) -> tuple:
    """Flattened 4:2:0 planes (B, S*S*3/2) -> (Y, Cb, Cr)."""
    n_y, half = size * size, size // 2
    B = pixels.shape[0]
    return (pixels[:, :n_y].reshape(B, size, size),
            pixels[:, n_y:n_y + half * half].reshape(B, half, half),
            pixels[:, n_y + half * half:].reshape(B, half, half))


def steps(arch, model: dict, params: dict, batches: list, aug_params: list,
          class_weights, tcfg: dict, steps_per_epoch: int, mean, std,
          bits=None) -> dict:
    """Train a copy of ``params`` (a tree of f32 tensors) on ``batches`` of
    (pixels, labels). Returns {"losses": [...], "first": {leaf: the first
    step's clipped gradient}, "grad": {leaf: its norm}, "delta": {leaf: the
    change over all the steps}}."""
    names, start = zip(*leaves(params))
    tensors = [p.detach().clone().requires_grad_(True) for p in start]
    params = rebuild(names, tensors)
    mu = [torch.zeros_like(p) for p in tensors]
    nu = [torch.zeros_like(p) for p in tensors]
    mean = torch.tensor(mean, device=tensors[0].device)[None, :, None, None]
    std = torch.tensor(std, device=tensors[0].device)[None, :, None, None]
    clip = tcfg["training"]["grad_clip_norm"]
    decay = tcfg["training"]["weight_decay"]
    losses, first = [], None
    for step, ((pixels, labels), ap) in enumerate(zip(batches, aug_params)):
        x = augment.apply(augment.ycbcr420_to_rgb01(
            *images(pixels, model["input_size"])), ap)
        x = ((x - mean) / std).permute(0, 2, 3, 1)
        loss = loss_fn(arch.forward(params, x, model, bits=bits), labels,
                       class_weights, tcfg)
        grads = torch.autograd.grad(loss, tensors)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
            if first is None:
                first = dict(zip(names, grads))
            lr = learning_rate(step, tcfg, steps_per_epoch)
            for p, g, m, v in zip(tensors, grads, mu, nu):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (m / (1 - B1 ** (step + 1))) / (
                    torch.sqrt(v / (1 - B2 ** (step + 1))) + EPS)
                p.sub_(lr * (upd + decay * p))
    return {"losses": losses, "first": first,
            "grad": {n: float(g.norm()) for n, g in first.items()},
            "delta": {n: p.detach() - s
                      for n, p, s in zip(names, tensors, start)}}
