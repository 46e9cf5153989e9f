"""The port's optimizer, class weights and checkpoints
(chess_vision_tpu_torch/train/state.py, utils/checkpoint.py) against the JAX
package's optax chain and msgpack checkpoints, on a tiny ChessViT (embed 64,
depth 2, 4 heads, 64 px) with numpy-made gradients.

Tolerances: parameters after five steps atol 2e-6. One AdamW update moves a
parameter by about lr = 1e-2 times a ratio of order 1; the two f32
implementations differ in the last bits of that ratio (bias corrections
computed in f64 here and in f32 by optax, m / (sqrt(v) + eps) in another
order), about 1e-7 relative, which five steps add up. Moments rtol 1e-5,
atol 1e-9 (a first moment near zero is a difference of larger terms).
Checkpoints carry arrays bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.train import state as jstate
from chess_vision_tpu.utils import checkpoint as jckpt
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_tree,
    tree_from_state_dict,
)
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.train import state as tstate
from chess_vision_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
STEPS_PER_EPOCH = 3


def _cfg(freeze=False, clip=1.0):
    return {"model": {"arch": "vit", "input_size": 64, "embed_dim": 64,
                      "depth": 2, "num_heads": 4, "freeze_backbone": freeze,
                      "remat": False},
            "training": {"mixed_precision": False, "lr": 1e-2, "epochs": 4,
                         "weight_decay": 0.1, "grad_clip_norm": clip},
            "scheduler": {"warmup_epochs": 1}}


def _states(cfg, seed=0):
    """A JAX TrainState and a port TrainState on the same weights, every bias
    made non-zero so that weight decay shows on it."""
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, 64, seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape).astype(np.float32)
                                   * 0.05 if a.ndim == 1 else 0), variables["params"])
    jst, _ = jstate.create_train_state(cfg, {"params": jax.tree.map(jnp.asarray, params)},
                                       STEPS_PER_EPOCH)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_tree(params))
    return jst, tstate.create_train_state(cfg, model, STEPS_PER_EPOCH), params


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * scale, params)


def _step_both(jst, tst, grads):
    jst = jst.apply_gradients(jax.tree.map(jnp.asarray, grads))
    named = dict(tst.model.named_parameters())
    for name, g in state_dict_from_tree(grads).items():
        if named[name].requires_grad:
            named[name].grad = g
    return jst, tst.apply_gradients()


def _assert_params_equal(jst, tst, atol):
    ours = tree_from_state_dict(dict(tst.model.named_parameters()))
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_theirs = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jst.params))
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_theirs]
    for (path, a), (_, b) in zip(flat_ours, flat_theirs):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("name,scale,clip", [("clipped", 1.0, 1.0),
                                             ("unclipped", 1e-4, 1.0),
                                             ("clip_at_norm", 1e-2, 0.05)])
def test_five_steps_match_optax(name, scale, clip):
    cfg = _cfg(clip=clip)
    jst, tst, params = _states(cfg)
    bias0 = tst.model.backbone.blocks[0].mlp.fc1.bias.detach().clone()
    for step in range(5):
        grads = _grads(params, 10 + step, scale)
        expect = float(optax_global_norm(grads))
        jst, norm = _step_both(jst, tst, grads)
        np.testing.assert_allclose(norm.item(), expect, rtol=1e-5)
        assert (norm.item() >= clip) == (name != "unclipped")
    assert tst.step == int(jst.step) == 5
    _assert_params_equal(jst, tst, atol=2e-6)
    adam = jst.opt_state[1][0]
    for ours, theirs in ((tst.mu, adam.mu), (tst.nu, adam.nu)):
        theirs = state_dict_from_tree(jax.tree.map(np.asarray, theirs))
        for key in theirs:
            torch.testing.assert_close(ours[key], theirs[key], rtol=1e-5, atol=1e-9)
    # a bias decays too: optax's adamw has no mask
    assert not torch.equal(tst.model.backbone.blocks[0].mlp.fc1.bias, bias0)


def optax_global_norm(tree):
    import optax

    return optax.global_norm(jax.tree.map(jnp.asarray, tree))


def test_bias_with_zero_gradient_decays():
    cfg = _cfg()
    _, tst, _ = _states(cfg)
    tst.step = STEPS_PER_EPOCH  # past the warm-up: lr is 1e-2
    before = {n: p.detach().clone() for n, p in zip(tst.names, tst.params)}
    for p in tst.params:
        p.grad = torch.zeros_like(p)
    tst.apply_gradients()
    lr = tst.schedule(STEPS_PER_EPOCH)
    for n, p in zip(tst.names, tst.params):  # p <- p - lr * wd * p
        torch.testing.assert_close(p, before[n] * (1 - lr * 0.1), rtol=1e-6, atol=0)
    assert lr > 0 and all(p.grad is None for p in tst.params)


def test_frozen_backbone_is_untouched_and_out_of_the_norm():
    cfg = _cfg(freeze=True)
    jst, tst, params = _states(cfg)
    before = {n: p.detach().clone() for n, p in tst.model.named_parameters()}
    assert all(not n.startswith("backbone.") for n in tst.names) and len(tst.names) == 8
    for step in range(5):
        grads = _grads(params, 20 + step, 1.0)
        heads = {k: v for k, v in grads.items() if k != "backbone"}
        jst, norm = _step_both(jst, tst, grads)
        np.testing.assert_allclose(norm.item(), float(optax_global_norm(heads)),
                                   rtol=1e-5)
    for n, p in tst.model.named_parameters():
        if n.startswith("backbone."):
            assert torch.equal(p, before[n]) and not p.requires_grad, n
        else:
            assert not torch.equal(p, before[n]), n
    _assert_params_equal(jst, tst, atol=2e-6)


def test_compute_class_weights_matches_jax():
    rng = np.random.default_rng(0)
    from chess_vision_tpu.fen import labels_to_fen

    samples = [{"fen": labels_to_fen(rng.choice(13, size=64, p=[0.5] + [0.5 / 12] * 12)
                                     .astype(np.int32)) + " w KQ -"}
               for _ in range(20)] + [{"filename": "x.png"}]
    ours = tstate.compute_class_weights(samples)
    theirs = jstate.compute_class_weights(samples)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)
    assert tstate.compute_class_weights([{"filename": "x.png"}]) is None


@pytest.mark.parametrize("freeze", [False, True])
def test_port_checkpoint_restores_into_a_jax_train_state(tmp_path, freeze):
    cfg = _cfg(freeze=freeze)
    jst, tst, params = _states(cfg)
    for step in range(2):
        jst, _ = _step_both(jst, tst, _grads(params, 30 + step, 1.0))
    path = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(path, tst, epoch=0, best_val_acc=0.25, config=cfg)
    ckpt = jckpt.load_checkpoint(path)
    assert (ckpt["step"], ckpt["epoch"], ckpt["best_val_acc"]) == (2, 0, 0.25)
    assert ckpt["config"] == cfg
    fresh, _, _ = _states(cfg, seed=1)
    restored = fresh.replace(
        params=jckpt.restore_tree(fresh.params, ckpt["params"]),
        opt_state=jckpt.restore_tree(fresh.opt_state, ckpt["opt_state"]),
        batch_stats=jckpt.restore_tree(fresh.batch_stats, ckpt["batch_stats"]),
        step=np.asarray(ckpt["step"], np.int32))
    assert jax.tree.structure(restored.opt_state) == jax.tree.structure(jst.opt_state)
    for ours, theirs in ((restored.params, jst.params),
                         (restored.opt_state, jst.opt_state)):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6,
                                       rtol=1e-5)
    # and the JAX state goes on from there as the port does
    grads = _grads(params, 40, 1.0)
    restored, _ = _step_both(restored, tst, grads)
    _assert_params_equal(restored, tst, atol=2e-6)


@pytest.mark.parametrize("freeze", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, freeze):
    cfg = _cfg(freeze=freeze)
    jst, tst, params = _states(cfg)
    for step in range(2):
        jst = jst.apply_gradients(jax.tree.map(jnp.asarray, _grads(params, 50 + step, 1.0)))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jst.params, jst.opt_state, jst.batch_stats,
                          step=int(jst.step), epoch=0, best_val_acc=0.0, config=cfg)
    ckpt = tckpt.load_checkpoint(path)
    tckpt.restore_train_state(tst, ckpt)
    assert tst.step == 2
    _assert_params_equal(jst, tst, atol=0)
    adam = (jst.opt_state.inner_states["train"].inner_state if freeze
            else jst.opt_state)[1][0]
    heads_only = {k: v for k, v in adam.mu.items() if not (freeze and k == "backbone")}
    for key, value in state_dict_from_tree(jax.tree.map(np.asarray, heads_only)).items():
        assert torch.equal(tst.mu[key], value), key
    jst, _ = _step_both(jst, tst, _grads(params, 60, 1.0))
    _assert_params_equal(jst, tst, atol=2e-6)
    # weights only (--reset-schedule): moments and step stay fresh
    _, fresh, _ = _states(cfg, seed=2)
    tckpt.restore_train_state(fresh, ckpt, weights_only=True)
    assert fresh.step == 0 and all(not m.any() for m in fresh.mu.values())
    # a checkpoint of the other freezing mode is refused, not half loaded
    _, other, _ = _states(_cfg(freeze=not freeze), seed=3)
    with pytest.raises(ValueError):
        tckpt.restore_train_state(other, ckpt)
