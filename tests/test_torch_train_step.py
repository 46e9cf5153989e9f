"""The training slice as a whole: the port's train and eval steps
(chess_vision_tpu_torch/train/loop.py) against the JAX package's on the same
tiny ViT (embed 64, depth 2, 4 heads of 16, 64 px), the same batch and the
same augmentation draws (the JAX step's own keys, reproduced here and handed
to the port's step as parameters), with dropout and drop path off.

Tolerances, each relative to the largest |value| of its tensor.
  f32: loss 1e-5, gradients 2e-5 (1.6e-6 read): the same arithmetic in
  another order (LayerNorm variance one-pass in flax, two-pass here; XLA's
  fusions).
  bf16: loss 2e-3 (9e-5 read), gradients 6e-2 (3.8e-2 read). On the CPU the
  JAX package differentiates its
  plain attention (XLA's autodiff: scores and dP rounded to bf16), while
  the port's backward is the kernel's arithmetic (f32 scores and dP, bf16 pn
  and dS); flax rounds a Dense product before adding the bias; and every
  difference passes through bf16 layers whose ulp is 2^-8 of the value.
  Parameters after three steps are held looser than gradients: AdamW divides
  the mean gradient by its root mean square, so a gradient entry near zero
  whose sign differs between the two moves its parameter by up to lr per step
  in opposite directions. The bound is that worst case, 2 * lr * steps (read:
  0.007 of it in f32, 0.76 in bf16); the 99th percentile of the entries is
  held to a thousandth of it in f32 and a twentieth in bf16 (read: 8e-6 and
  0.02)."""

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
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_tree,
    tree_from_state_dict,
)
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.train import loop as tloop
from chess_vision_tpu_torch.train import state as tstate

torch.set_num_threads(2)
MEAN = STD = (0.5, 0.5, 0.5)
B, LR, STEPS = 4, 1e-3, 3


def _cfg(mixed, **model):
    return {"model": {"arch": "vit", "input_size": 64, "embed_dim": 64, "depth": 2,
                      "num_heads": 4, "head_dropout": 0.0, "drop_path_rate": 0.0,
                      "remat": False, **model},
            "training": {"mixed_precision": mixed, "lr": LR, "epochs": 2,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 0}}


def _batches(n, seed=0, transport="rgb"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"squares": rng.integers(0, 13, (B, 64)).astype(np.int32),
                 "turn": rng.integers(0, 2, (B, 1)).astype(np.float32),
                 "castling": rng.integers(0, 2, (B, 4)).astype(np.float32),
                 "legal": np.ones((B, 1), np.float32),
                 "mask": np.array([1, 1, 1, 0], np.float32)}
        if transport == "rgb":
            batch["image"] = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
        else:
            batch["y"] = rng.integers(0, 256, (B, 64, 64), dtype=np.uint8)
            batch["cb"] = rng.integers(0, 256, (B, 32, 32), dtype=np.uint8)
            batch["cr"] = rng.integers(0, 256, (B, 32, 32), dtype=np.uint8)
        out.append(batch)
    return out


def _pair(cfg, seed=0):
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, 64, seed=seed)
    params = jax.tree.map(np.asarray, variables["params"])
    jst, _ = jstate.create_train_state(cfg, variables, 4)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_tree(params))
    # the inverse bridge gives the JAX tree back
    back = tree_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    return jmodel, jst, tstate.create_train_state(cfg, model, 4)


def _jax_keys(base_rng, step):
    """The keys of the JAX train step (loop.py: fold_in, split)."""
    aug_rng, drop_rng = jax.random.split(jax.random.fold_in(base_rng, step))
    return aug_rng, drop_rng


def _aug_params(aug_rng):
    keys = jax.random.split(aug_rng, B)
    kj = jax.vmap(lambda k: jax.random.split(k, 7)[0])(keys)
    fb, fc, fs, fh, which = jax.vmap(jaug._color_jitter_params)(kj)
    pg, pb, sigma, pc, cperm, pi = jax.vmap(jaug._rest_params)(keys)
    names = ("brightness", "contrast", "saturation", "hue", "order", "gray_u",
             "blur_u", "sigma", "perm_u", "channel_perm", "invert_u")
    values = (fb, fc, fs, fh, which, pg, pb, sigma, pc, cperm, pi)
    return {n: torch.from_numpy(np.array(v)) for n, v in zip(names, values)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_step_with_grads(tst, train_step, batch, aug):
    grads = {}
    apply = tst.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in zip(tst.names, tst.params)})
        return apply()

    tst.apply_gradients = capture
    try:
        sums = train_step(batch, aug)
    finally:
        del tst.apply_gradients  # the class's method again, no cycle
    return grads, sums


@pytest.mark.parametrize("mixed,transport,loss_tol,grad_tol,typical", [
    (False, "rgb", 1e-5, 2e-5, 1e-3), (True, "rgb", 2e-3, 6e-2, 0.05),
    (False, "ycbcr420", 1e-5, 2e-5, 1e-3)])
def test_train_steps_match_jax(mixed, transport, loss_tol, grad_tol, typical):
    cfg = _cfg(mixed)
    weights = np.linspace(0.5, 1.5, 13).astype(np.float32)
    jmodel, jst, tst = _pair(cfg)
    jtrain, _ = jloop.make_steps(jmodel, cfg, jnp.asarray(weights), MEAN, STD)
    ttrain, _ = tloop.make_steps(tst, cfg, torch.from_numpy(weights), MEAN, STD)
    base_rng = jax.random.key(0)
    batches = _batches(STEPS, transport=transport)

    # one step: the loss and every gradient
    aug_rng, drop_rng = _jax_keys(base_rng, 0)
    jb = _jbatch(batches[0])
    images = jaug.preprocess_train_batch(jb, aug_rng, MEAN, STD)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, images, train=True,
                           rngs={"dropout": drop_rng})
        return jax_total_loss(out, jb, jnp.asarray(weights), 0.1, 1.0, 1.0)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jst.params)
    jgrads = state_dict_from_tree(jax.tree.map(np.asarray, jgrads))
    grads, sums = _port_step_with_grads(tst, ttrain, _tbatch(batches[0]),
                                        _aug_params(aug_rng))
    assert abs(sums["step_loss"].item() - float(jloss)) <= loss_tol * abs(float(jloss))
    assert grads.keys() == jgrads.keys() and len(grads) == 4 + 2 * 12 + 2 + 8
    worst = max(_rel(grads[k].numpy(), jgrads[k].numpy()) for k in grads)
    assert worst <= grad_tol, worst
    jst, jsums = jax.jit(jtrain)(jst, jb, base_rng)

    # two more steps: parameters and metric sums
    total, jtotal = dict(sums), dict(jsums)
    for step in range(1, STEPS):
        aug_rng, _ = _jax_keys(base_rng, step)
        sums = ttrain(_tbatch(batches[step]), _aug_params(aug_rng))
        jst, jsums = jax.jit(jtrain)(jst, _jbatch(batches[step]), base_rng)
        total = {k: total[k] + sums[k] for k in total}
        jtotal = {k: jtotal[k] + jsums[k] for k in jtotal}
    assert tst.step == int(jst.step) == STEPS
    assert total.keys() == jtotal.keys()
    for key in jtotal:
        if "loss" in key:
            np.testing.assert_allclose(total[key].item(), float(jtotal[key]),
                                       rtol=max(loss_tol, 1e-5) * 2)
        elif mixed:  # a bf16 logit near a tie may flip one square's argmax
            assert abs(total[key].item() - float(jtotal[key])) <= 3, key
        else:
            assert total[key].item() == float(jtotal[key]), key
    ours = state_dict_from_tree(tree_from_state_dict(dict(tst.model.named_parameters())))
    theirs = state_dict_from_tree(jax.tree.map(np.asarray, jst.params))
    diffs = torch.cat([(ours[k] - theirs[k]).abs().flatten() for k in theirs])
    bound = 2 * LR * STEPS
    assert diffs.max().item() <= bound, diffs.max().item()
    assert diffs.quantile(0.99).item() <= typical * bound, diffs.quantile(0.99).item()


@pytest.mark.parametrize("mixed", [False, True])
def test_eval_step_matches_jax(mixed):
    cfg = _cfg(mixed)
    jmodel, jst, tst = _pair(cfg, seed=1)
    _, jeval = jloop.make_steps(jmodel, cfg, None, MEAN, STD)
    _, teval = tloop.make_steps(tst, cfg, None, MEAN, STD)
    batch = _batches(1, seed=3)[0]
    ours = teval(_tbatch(batch))
    theirs = jeval(jst.params, jst.batch_stats, _jbatch(batch))
    assert ours.keys() == theirs.keys()
    for key in theirs:
        tol = 2e-2 if mixed else 1e-5
        if "loss" in key:
            np.testing.assert_allclose(ours[key].item(), float(theirs[key]), rtol=tol)
        else:
            assert abs(ours[key].item() - float(theirs[key])) <= (2 if mixed else 0)
    assert not tst.model.training and tst.step == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_remat_gives_the_same_gradients(mixed):
    """Dropout and drop path on: the recomputed blocks must draw the same
    masks (the generator's state is restored), so the gradients are equal."""
    grads = {}
    for remat in (False, True):
        cfg = _cfg(mixed, head_dropout=0.3, drop_path_rate=0.3, remat=remat)
        _, _, tst = _pair(cfg, seed=2)
        ttrain, _ = tloop.make_steps(tst, cfg, None, MEAN, STD, seed=5)
        assert tst.model.backbone.remat is remat
        grads[remat], _ = _port_step_with_grads(tst, ttrain, _tbatch(_batches(1)[0]), None)
    for key in grads[False]:
        torch.testing.assert_close(grads[True][key], grads[False][key],
                                   rtol=1e-6, atol=1e-9)


def test_dropout_follows_the_seed_and_the_step():
    def losses(seed):
        cfg = _cfg(False, head_dropout=0.3, drop_path_rate=0.3)
        _, _, tst = _pair(cfg)
        ttrain, _ = tloop.make_steps(tst, cfg, None, MEAN, STD, seed=seed)
        batch = _tbatch(_batches(1)[0])
        return [ttrain(batch)["step_loss"].item() for _ in range(2)]

    first, again, other = losses(0), losses(0), losses(1)
    assert first == again  # one seed: identical runs
    assert first[0] != other[0]  # another seed: other masks and draws


def test_attn_out_remat_and_f32_on_the_card_are_refused():
    """The name is from when both raised (ROADMAP Queue A item 7); both are
    ported: ``remat="attn_out"`` builds (its gradients are held to
    ``remat=False``'s in ``tests/test_torch_remat.py``), an unknown policy
    raises, and ``resolve_remat`` has the JAX rule's three tiers."""
    assert build_model(_cfg(True, remat="attn_out")).backbone.remat == "attn_out"
    with pytest.raises(ValueError, match="remat"):
        build_model(_cfg(True, remat="blocks"))
    from chess_vision_tpu_torch.models import normalize_remat, resolve_remat

    assert normalize_remat("FALSE") is False and normalize_remat("full") is True
    assert normalize_remat("auto") == "auto" and normalize_remat(True) is True
    assert resolve_remat(64, device_bytes=80 * 2**30) is False
    assert resolve_remat(4096, device_bytes=80 * 2**30) == "attn_out"
    assert resolve_remat(1 << 16, device_bytes=80 * 2**30) is True
    assert resolve_remat(64, "cpu") is False
