"""Train state and optimizer (``chess_vision_tpu/train/state.py``).

The JAX package's optimizer is ``optax.chain(clip_by_global_norm(c),
adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay))``, and this module
computes the same update with fused ``torch._foreach_*`` passes over the
parameter list:

  - the global norm is taken over the trainable gradients; when it is not
    below ``c`` every gradient becomes ``g / norm * c`` (optax's form:
    ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is not the
    same);
  - AdamW decays **every** trainable parameter, biases and LayerNorm too
    (optax's ``adamw`` has no mask here);
  - with ``model.freeze_backbone`` the backbone's parameters take no
    gradient, keep their values bit for bit and stay out of the norm (the
    JAX package's ``multi_transform`` partition with the clip inside it).

The clip factor stays on the device: no step waits for the norm. The moments
are kept per ``state_dict`` name in the parameters' own (PyTorch) layout;
``utils/checkpoint.py`` carries them through the weight bridge into optax's
``opt_state`` structure and back.

Over several devices (``parallel/mesh.py``, ``shard_train_state``) the update
is the same function: the gradients of the parameters that FSDP does not
hold are summed over the data axis here (FSDP has reduce-scattered its own),
the global norm adds every shard's squares once (TP cuts over the model
axis, FSDP shards over the data axis), and AdamW runs on each rank's shards
of the parameters and moments.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from chess_vision_tpu_torch.fen import NUM_CLASSES, fen_to_labels
from chess_vision_tpu_torch.train.schedule import build_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8


class TrainState:
    """The model, its AdamW moments and the step count.

    ``step`` is the number of optimizer updates taken, kept on the host; it
    indexes the schedule and the bias corrections (optax keeps the same count
    twice in its state). ``mu`` and ``nu`` map the trainable parameters'
    names to their first and second moments."""

    def __init__(self, model: nn.Module, schedule, clip_norm: float,
                 weight_decay: float, freeze_backbone: bool = False):
        self.model = model
        self.schedule = schedule
        self.clip_norm = float(clip_norm)
        self.weight_decay = float(weight_decay)
        self.freeze_backbone = freeze_backbone
        self.step = 0
        self.names: list[str] = []
        self.params: list[torch.Tensor] = []
        for name, param in model.named_parameters():
            frozen = freeze_backbone and name.startswith("backbone.")
            param.requires_grad_(not frozen)
            if not frozen:
                self.names.append(name)
                self.params.append(param)
        self.mu = {n: torch.zeros_like(p) for n, p in zip(self.names, self.params)}
        self.nu = {n: torch.zeros_like(p) for n, p in zip(self.names, self.params)}
        self.mesh = None  # parallel.mesh.Mesh once sharded
        self.tp_layout: dict = {}

    def _global_norm(self, grads: list) -> torch.Tensor:
        """The norm of the whole gradient. One device (or data parallel,
        whose gradients are whole after the reduction): the norm of the
        per-tensor norms. Sharded: every shard's squares once, summed over
        the axes the shard is cut along."""
        from chess_vision_tpu_torch.parallel.mesh import is_sharded

        mesh = self.mesh
        if mesh is None or not (self.tp_layout or mesh.fsdp):
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        squares = torch.stack(torch._foreach_norm(grads)) ** 2
        # by axis: 0 whole, 1 cut over data, 2 over model, 3 over both
        axis = torch.tensor([is_sharded(p) + 2 * (n in self.tp_layout)
                             for n, p in zip(self.names, self.params)],
                            device=squares.device)
        parts = torch.zeros(4, dtype=squares.dtype, device=squares.device)
        parts.index_add_(0, axis, squares)
        by_data, by_model, by_both = parts[1:2], parts[2:3], parts[3:4]
        if mesh.dp > 1:
            dist.all_reduce(by_data, group=mesh.dp_group)
        if mesh.tp > 1:
            dist.all_reduce(by_model, group=mesh.tp_group)
        if mesh.world > 1:
            dist.all_reduce(by_both)
        return torch.sqrt(parts.sum())

    def _reduce_gradients(self, grads: list) -> None:
        """Sum over the data axis, in place, the gradients that FSDP does
        not reduce (one all-reduce of their concatenation)."""
        from chess_vision_tpu_torch.parallel.mesh import is_sharded

        if self.mesh is None or self.mesh.dp == 1:
            return
        whole = [g for g, p in zip(grads, self.params) if not is_sharded(p)]
        flat = torch.cat([g.reshape(-1) for g in whole])
        dist.all_reduce(flat, group=self.mesh.dp_group)
        parts = flat.split([g.numel() for g in whole])
        torch._foreach_copy_(whole, [p.view_as(g) for p, g in zip(parts, whole)])

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """One clipped AdamW update from the parameters' ``.grad``; clears the
        gradients. A parameter that the loss does not reach (MobileNet's
        ``conv_head``) has no ``.grad`` and takes a zero gradient, as in
        optax: its moments stay zero and weight decay still shrinks it.
        Returns the global gradient norm before clipping, a 0-d tensor left
        on the device."""
        from chess_vision_tpu_torch.parallel.mesh import local

        grads = [torch.zeros_like(local(p)) if p.grad is None
                 else local(p.grad) for p in self.params]
        self._reduce_gradients(grads)
        mu = [local(self.mu[n]) for n in self.names]
        nu = [local(self.nu[n]) for n in self.names]
        params = [local(p) for p in self.params]
        norm = self._global_norm(grads)
        clip = norm >= self.clip_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(grads, torch.where(clip, self.clip_norm * one, one))

        count = self.step + 1
        lr = self.schedule(self.step)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        denom = torch._foreach_div(nu, 1.0 - B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(mu, 1.0 - B1 ** count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        for p in self.params:
            p.grad = None
        self.step = count
        return norm


def create_train_state(cfg: dict, model: nn.Module,
                       steps_per_epoch: int) -> TrainState:
    tcfg = cfg["training"]
    return TrainState(
        model, build_schedule(cfg, steps_per_epoch),
        clip_norm=tcfg.get("grad_clip_norm", 1.0),
        weight_decay=tcfg.get("weight_decay", 0.0),
        freeze_backbone=cfg["model"].get("freeze_backbone", False))


def compute_class_weights(samples: list[dict]) -> torch.Tensor | None:
    """Inverse-sqrt-frequency class weights from manifest FENs, normalized to
    mean 1; None when no sample carries a FEN."""
    counts = np.zeros(NUM_CLASSES, dtype=np.float64)
    for sample in samples:
        fen = sample.get("fen")
        if fen:
            labels = fen_to_labels(fen.split()[0])
            counts += np.bincount(labels, minlength=NUM_CLASSES)
    if counts.sum() == 0:
        return None
    freq = counts / counts.sum()
    weights = 1.0 / np.sqrt(np.clip(freq, 1e-6, None))
    weights /= weights.mean()
    return torch.from_numpy(weights.astype(np.float32))
