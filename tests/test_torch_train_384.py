"""The slice's path at ``model.input_size=384``: a narrow ViT (embed 64,
depth 2, 2 heads of 32) has (384 / 16)^2 + 1 = 577 tokens, where the port's
attention backward takes its long route (``ops/attention.bwd_route``:
``"long"`` in bf16, ``"f32_long"`` in f32; on the CPU its plain version,
``reference_attention_bwd``). One train step of the port against one of the
JAX package on the same weights (through ``convert/jax_params.py``), batch
and augmentation draws, dropout and drop path off; an eval step; the
counters untouched on the CPU.

Tolerances, as ``tests/test_torch_train_step.py`` (each relative to the
largest |value| of its tensor): f32 loss 1e-5, gradients 2e-5 (the same
arithmetic in another order); bf16 loss 2e-3 against the JAX bf16 step's
(7e-4 read), gradients 6e-2 against the JAX *f32* step's on the same
weights (1.1e-2 read): at 577 tokens the JAX bf16 step sums the patch
embedding's bias gradient over 1,154 tokens in bf16 and lands 0.30 from its
own f32 step's, where the port's bf16 step lands 0.007 from it; every other
bf16 difference passes through bf16 layers (the JAX package differentiates
its plain attention on the CPU, with scores and dP rounded to bf16, where
the port's backward rounds pn and dS, as its kernels). Eval metrics: the
loss to 1e-5 (f32) and 2e-2 (bf16), counts exact in f32 and within 2 in
bf16 (a logit near a tie may flip one square's argmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu import augment as jaug
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.train import loop as jloop
from chess_vision_tpu.train import state as jstate
from chess_vision_tpu.train.losses import total_loss as jax_total_loss
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.train import loop as tloop
from chess_vision_tpu_torch.train import state as tstate

torch.set_num_threads(2)
MEAN = STD = (0.5, 0.5, 0.5)
B, SIZE, TOKENS = 2, 384, 577


def _cfg(mixed):
    return {"model": {"arch": "vit", "input_size": SIZE, "embed_dim": 64, "depth": 2,
                      "num_heads": 2, "head_dropout": 0.0, "drop_path_rate": 0.0,
                      "remat": False},
            "training": {"mixed_precision": mixed, "lr": 1e-3, "epochs": 1,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 0}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8),
            "squares": rng.integers(0, 13, (B, 64)).astype(np.int32),
            "turn": rng.integers(0, 2, (B, 1)).astype(np.float32),
            "castling": rng.integers(0, 2, (B, 4)).astype(np.float32),
            "legal": np.ones((B, 1), np.float32),
            "mask": np.ones((B,), np.float32)}


def _pair(cfg, seed=0):
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, SIZE, seed=seed)
    params = jax.tree.map(np.asarray, variables["params"])
    jst, _ = jstate.create_train_state(cfg, variables, 4)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_tree(params))
    return jmodel, jst, tstate.create_train_state(cfg, model, 4)


def _aug_params(aug_rng):
    """The JAX train step's draws (``tests/test_torch_train_step.py``)."""
    keys = jax.random.split(aug_rng, B)
    kj = jax.vmap(lambda k: jax.random.split(k, 7)[0])(keys)
    fb, fc, fs, fh, which = jax.vmap(jaug._color_jitter_params)(kj)
    pg, pb, sigma, pc, cperm, pi = jax.vmap(jaug._rest_params)(keys)
    names = ("brightness", "contrast", "saturation", "hue", "order", "gray_u",
             "blur_u", "sigma", "perm_u", "channel_perm", "invert_u")
    values = (fb, fc, fs, fh, which, pg, pb, sigma, pc, cperm, pi)
    return {n: torch.from_numpy(np.array(v)) for n, v in zip(names, values)}


def _counts():
    return (attn.LAUNCHES, attn.BWD_LAUNCHES, attn.BWD_LONG_LAUNCHES,
            attn.F32_LAUNCHES, attn.F32_BWD_LAUNCHES, attn.F32_BWD_LONG_LAUNCHES)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("mixed,loss_tol,grad_tol", [(False, 1e-5, 2e-5),
                                                     (True, 2e-3, 6e-2)],
                         ids=("f32", "bf16"))
def test_train_step_at_384px_matches_jax(mixed, loss_tol, grad_tol):
    cfg = _cfg(mixed)
    dtype = torch.bfloat16 if mixed else torch.float32
    assert attn.bwd_route(TOKENS, dtype) == ("long" if mixed else "f32_long")
    weights = np.linspace(0.5, 1.5, 13).astype(np.float32)
    jmodel, jst, tst = _pair(cfg)
    assert tst.model.backbone.pos_embed.shape[1] == TOKENS
    ttrain, _ = tloop.make_steps(tst, cfg, torch.from_numpy(weights), MEAN, STD)
    aug_rng, drop_rng = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    batch = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    images = jaug.preprocess_train_batch(jb, aug_rng, MEAN, STD)

    def loss_fn(params, model):
        out = model.apply({"params": params}, images, train=True,
                          rngs={"dropout": drop_rng})
        return jax_total_loss(out, jb, jnp.asarray(weights), 0.1, 1.0, 1.0)[0]

    jloss = loss_fn(jst.params, jmodel)
    # the gradients of the JAX f32 step on the same weights (see above)
    jgrads = jax.grad(loss_fn)(jst.params, jax_build_model(_cfg(False)))
    jgrads = state_dict_from_tree(jax.tree.map(np.asarray, jgrads))
    grads = {}
    apply = tst.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone() for n, p in zip(tst.names, tst.params)})
        return apply()

    tst.apply_gradients = capture
    before = _counts()
    try:
        sums = ttrain({k: torch.from_numpy(v) for k, v in batch.items()},
                      _aug_params(aug_rng))
    finally:
        del tst.apply_gradients
    assert _counts() == before  # the CPU runs the plain versions
    assert abs(sums["step_loss"].item() - float(jloss)) <= loss_tol * abs(float(jloss))
    assert grads.keys() == jgrads.keys()
    worst = max(_rel(grads[k].float().numpy(), jgrads[k].float().numpy()) for k in grads)
    assert worst <= grad_tol, worst


@pytest.mark.parametrize("mixed", [False, True], ids=("f32", "bf16"))
def test_eval_step_at_384px_matches_jax(mixed):
    cfg = _cfg(mixed)
    jmodel, jst, tst = _pair(cfg, seed=1)
    _, jeval = jloop.make_steps(jmodel, cfg, None, MEAN, STD)
    _, teval = tloop.make_steps(tst, cfg, None, MEAN, STD)
    batch = _batch(2)
    ours = teval({k: torch.from_numpy(v) for k, v in batch.items()})
    theirs = jeval(jst.params, jst.batch_stats, {k: jnp.asarray(v) for k, v in batch.items()})
    assert ours.keys() == theirs.keys()
    for key in theirs:
        if "loss" in key:
            np.testing.assert_allclose(ours[key].item(), float(theirs[key]),
                                       rtol=2e-2 if mixed else 1e-5)
        else:
            assert abs(ours[key].item() - float(theirs[key])) <= (2 if mixed else 0), key
