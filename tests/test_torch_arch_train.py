"""One train step of the CNN and square archs: the port's
(chess_vision_tpu_torch/train/loop.py) against the JAX package's loss and
gradients (chess_vision_tpu/train/loop.py's ``loss_fn``) on the same weights,
batch and augmentation draws (the JAX step's own keys, handed to the port's
step as parameters, as in tests/test_torch_train_step.py), with dropout and
drop path off.

With ``pin_backbone_bn=false`` the square model normalizes with the batch's
statistics and updates the running ones (momentum 0.99, biased variance);
pinned, the statistics stay bit for bit. Tolerances, relative to the largest
|value| of each tensor (of the whole gradient, 1e-6 of it, for tensors whose
gradient is zero in exact arithmetic: a BatchNorm bias whose shift the next
batch-statistics BatchNorm takes out): loss 1e-5; updated statistics 1e-5
(read 1.5e-7).

Gradients: with pinned statistics 1e-4 (read 5.8e-6 square, 3.2e-6 CNN).
With batch statistics the f32 step's gradients are noise-limited on both
sides: every BatchNorm puts its output's mean at 0, so many ReLU inputs lie
within rounding of 0, and a flip moves its channel's batch statistics and
through them every gradient of the channel (read on this step: per tensor up
to 0.14 apart, median 6.5e-3; on another step the JAX package's own f32
gradients were 1.4e-2 from the same step in f64). That step is held to its
loss, its statistics and the median tensor's gradient (3e-2). The arithmetic
of the batch-statistics backward is held in f64 instead: the model's forward
and backward on the same f64 images in both packages (the JAX package's
compute dtype set to f64 under ``enable_x64``, the port's model in f64; the
loss is f32 in both, as the heads' outputs are), gradients 1e-6 (read
7.2e-8) and updated statistics 1e-12 (read 2.8e-16).

Last, the trainer's CLI on ``configs/square.yaml``, one tiny epoch, unpinned:
the checkpoint's ``batch_stats``."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from chess_vision_tpu import augment as jaug
import chess_vision_tpu.models as jax_models
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.train.losses import total_loss as jax_total_loss
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_tree,
    variables_from_state_dict,
)
from chess_vision_tpu_torch.models import build_model, init_weights
from chess_vision_tpu_torch.train import loop as tloop
from chess_vision_tpu_torch.train.losses import total_loss
from chess_vision_tpu_torch.train import state as tstate
from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}
MEAN = STD = (0.5, 0.5, 0.5)
B = 4


def _cfg(arch, pin=True):
    return {"model": {"arch": arch, "input_size": 64, "square_input_size": 32,
                      "head_dropout": 0.0, "drop_path_rate": 0.0,
                      "pin_backbone_bn": pin},
            "training": {"mixed_precision": False, "lr": 1e-3, "epochs": 2,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 0}}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
            "squares": rng.integers(0, 13, (B, 64)).astype(np.int32),
            "turn": rng.integers(0, 2, (B, 1)).astype(np.float32),
            "castling": rng.integers(0, 2, (B, 4)).astype(np.float32),
            "legal": np.ones((B, 1), np.float32),
            "mask": np.array([1, 1, 1, 0], np.float32)}


def _aug_params(aug_rng):
    """The draws of the JAX step's augmentation key, as the port's step
    takes them (tests/test_torch_train_step.py)."""
    keys = jax.random.split(aug_rng, B)
    kj = jax.vmap(lambda k: jax.random.split(k, 7)[0])(keys)
    fb, fc, fs, fh, which = jax.vmap(jaug._color_jitter_params)(kj)
    pg, pb, sigma, pc, cperm, pi = jax.vmap(jaug._rest_params)(keys)
    names = ("brightness", "contrast", "saturation", "hue", "order", "gray_u",
             "blur_u", "sigma", "perm_u", "channel_perm", "invert_u")
    values = (fb, fc, fs, fh, which, pg, pb, sigma, pc, cperm, pi)
    return {n: torch.from_numpy(np.array(v)) for n, v in zip(names, values)}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _setup(cfg, seed=0):
    """Port weights from ``init_weights`` with running statistics off the
    init's 0 and 1, in the JAX layout too, and the port's train state."""
    model = init_weights(build_model(cfg), seed=seed)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=gen) * 0.4 + 0.1)
    variables = variables_from_state_dict(model.state_dict())
    return (variables["params"], variables["batch_stats"],
            tstate.create_train_state(cfg, model, 4))


def _port_step(tst, cfg, weights, batch, aug):
    """The port's train step; returns its loss and the gradients it applied
    (zero where no ``.grad`` reached a parameter, as the step takes it)."""
    ttrain, _ = tloop.make_steps(tst, cfg, torch.from_numpy(weights), MEAN, STD)
    grads = {}
    apply = tst.apply_gradients

    def capture():
        grads.update({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad.detach().clone())
                      for n, p in zip(tst.names, tst.params)})
        return apply()

    tst.apply_gradients = capture
    try:
        sums = ttrain({k: torch.from_numpy(v) for k, v in batch.items()}, aug)
    finally:
        del tst.apply_gradients
    return sums["step_loss"].item(), grads


def _grad_rels(grads, jgrads) -> dict:
    top = max(np.abs(g.numpy()).max() for g in jgrads.values())
    return {k: float(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
                     / max(np.abs(jgrads[k].numpy()).max(), 1e-6 * top))
            for k in grads}


def _assert_stats_close(ours: dict, theirs: dict, before: dict, rtol: float):
    """The running statistics moved, and as flax moved them."""
    ours, theirs, before = (state_dict_from_tree(t) for t in (ours, theirs, before))
    assert ours.keys() == theirs.keys() == before.keys() and len(ours) == 2 * 45
    scale = max(v.abs().max().item() for v in theirs.values())
    for k in theirs:
        assert not torch.equal(theirs[k].double(), before[k].double()), k
        diff = (ours[k].double() - theirs[k].double()).abs().max().item()
        assert diff <= rtol * scale, (k, diff)


@pytest.mark.parametrize("arch,pin", [("square", False), ("square", True),
                                      ("cnn", True)])
def test_train_step_matches_jax(arch, pin):
    cfg = _cfg(arch, pin)
    weights = np.linspace(0.5, 1.5, 13).astype(np.float32)
    params, stats, tst = _setup(cfg)
    jmodel = jax_build_model(cfg)
    batch = _batch()
    aug_rng, drop_rng = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    images = jaug.preprocess_train_batch(jb, aug_rng, MEAN, STD)

    def loss_fn(p):
        variables = {"params": p, **({"batch_stats": stats} if stats else {})}
        out, mutated = jmodel.apply(variables, images, train=True,
                                    rngs={"dropout": drop_rng},
                                    mutable=["batch_stats"])
        loss = jax_total_loss(out, jb, jnp.asarray(weights), 0.1, 1.0, 1.0)[0]
        return loss, mutated.get("batch_stats")

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jgrads = state_dict_from_tree(jax.tree.map(np.asarray, jgrads))
    loss, grads = _port_step(tst, cfg, weights, batch, _aug_params(aug_rng))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert grads.keys() == jgrads.keys()
    assert all(np.isfinite(g.numpy()).all() for g in grads.values())
    rels = _grad_rels(grads, jgrads)
    if pin:
        worst = max(rels, key=rels.get)
        assert rels[worst] <= 1e-4, (worst, rels[worst])
    else:
        assert np.median(list(rels.values())) <= 3e-2
    ours = variables_from_state_dict(tst.model.state_dict())["batch_stats"]
    if arch == "square" and not pin:
        _assert_stats_close(ours, jax.tree.map(np.asarray, jstats), stats, 1e-5)
    elif arch == "square":
        assert state_dict_from_tree(ours).keys() == state_dict_from_tree(stats).keys()
    else:
        assert not ours and not jstats


def test_unpinned_backward_matches_jax_in_f64():
    cfg = _cfg("square", False)
    weights = np.linspace(0.5, 1.5, 13).astype(np.float32)
    params, stats, tst = _setup(cfg, seed=2)
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    aug_rng, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    images = np.asarray(jaug.preprocess_train_batch(jb, aug_rng, MEAN, STD),
                        np.float64)
    with enable_x64(True), mock.patch.object(jax_models, "_compute_dtype",
                                             lambda *_: jnp.float64):
        jmodel = jax_build_model(cfg)
        stats64 = jax.tree.map(lambda a: np.asarray(a, np.float64), stats)

        def loss_fn(p):
            out, mutated = jmodel.apply(
                {"params": p, "batch_stats": stats64}, jnp.asarray(images),
                train=True, mutable=["batch_stats"])
            loss = jax_total_loss(out, jb, jnp.asarray(weights), 0.1, 1.0, 1.0)[0]
            return loss, mutated["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(lambda a: np.asarray(a, np.float64), params))
        jgrads = state_dict_from_tree(jax.tree.map(np.asarray, jgrads))
        jstats = jax.tree.map(np.asarray, jstats)
    model = tst.model.double().train()
    model.dtype = model.backbone.dtype = torch.float64
    out = model(torch.from_numpy(images))
    loss, _ = total_loss(out, {k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.from_numpy(weights), 0.1, 1.0, 1.0)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    rels = _grad_rels(grads, jgrads)
    worst = max(rels, key=rels.get)
    assert rels[worst] <= 1e-6, (worst, rels[worst])
    _assert_stats_close(variables_from_state_dict(model.state_dict())["batch_stats"],
                        jstats, stats, 1e-12)


def test_pinned_square_step_leaves_statistics_bit_equal():
    cfg = _cfg("square", pin=True)
    _, stats, tst = _setup(cfg, seed=1)
    before = {k: v.clone() for k, v in tst.model.state_dict().items()
              if "running" in k}
    assert len(before) == 2 * 45
    aug_rng, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    loss, grads = _port_step(tst, cfg, np.ones(13, np.float32), _batch(1),
                             _aug_params(aug_rng))
    assert np.isfinite(loss)
    assert grads["type_head.1.weight"].abs().max() > 0
    assert tst.step == 1 and tst.model.training
    for k, v in tst.model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k


def test_square_config_trains_and_writes_its_batch_stats(tmp_path):
    """The trainer's CLI (``python -m chess_vision_tpu_torch.train``) on
    ``configs/square.yaml`` at 64 px (square input 32), one epoch on 24
    boards of the JAX package's generator, with the backbone's BatchNorm
    unpinned: the checkpoint carries the moved running statistics in the JAX
    layout, and the port's evaluate CLI reads it."""
    corpus = tmp_path / "corpus"
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu.datagen.generate",
         "--out", str(corpus), "--count", "24", "--size", "64", "--seed", "7"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    args = ["--set", "training.epochs=1", "training.batch_size=8",
            "data.num_workers=0", "data.max_samples=24",
            f"data.train_dir={corpus}", "data.ood_val_dir=",
            "model.pretrained=false", "model.input_size=64",
            "model.square_input_size=32", "model.pin_backbone_bn=false",
            f"checkpointing.save_dir={tmp_path / 'ckpt'}",
            f"logging.tensorboard_dir={tmp_path / 'runs'}"]
    r = subprocess.run([sys.executable, "-m", "chess_vision_tpu_torch.train",
                        "--config", "configs/square.yaml", "--device", "cpu",
                        *args], cwd=REPO, env=ENV, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "Parameters: 2,925,183" in r.stdout
    ckpt = load_checkpoint(str(tmp_path / "ckpt" / "latest.ckpt"))
    assert ckpt["config"]["model"]["arch"] == "square"
    stem = ckpt["batch_stats"]["backbone"]["stem"]["bn"]
    assert stem["mean"].shape == (16,) and stem["mean"].dtype == "float32"
    assert (stem["mean"] != 0).all() and (stem["var"] != 1).all()
    assert len(ckpt["batch_stats"]["backbone"]) == 1 + 2 + 2 + 6 + 6 + 1
    r = subprocess.run([sys.executable, "-m", "chess_vision_tpu_torch.evaluate",
                        "--checkpoint", str(tmp_path / "ckpt" / "latest.ckpt"),
                        "--test-dir", str(corpus), "--batch-size", "8",
                        "--device", "cpu"], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Overall (24 images" in r.stdout
