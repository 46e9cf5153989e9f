"""The port's losses, metric sums and schedule
(chess_vision_tpu_torch/train/{losses,metrics,schedule}.py) against the JAX
package's on the same numpy inputs. Tolerance 1e-6 throughout (absolute, on
values of order 1 to 10): both sides compute in f32 and differ only in the
order of sums and in log-softmax's last bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.train import losses as jl
from chess_vision_tpu.train import metrics as jm
from chess_vision_tpu.train import schedule as js
from chess_vision_tpu_torch.train import losses as tl
from chess_vision_tpu_torch.train import metrics as tm
from chess_vision_tpu_torch.train import schedule as ts

torch.set_num_threads(2)
ATOL = 1e-6


def _batch(seed=0, B=6, padded=2):
    rng = np.random.default_rng(seed)
    outputs = {"squares": rng.normal(size=(B, 64 * 13)).astype(np.float32) * 2,
               "turn": rng.normal(size=(B, 1)).astype(np.float32),
               "castling": rng.normal(size=(B, 4)).astype(np.float32)}
    batch = {"squares": rng.integers(0, 13, size=(B, 64)).astype(np.int32),
             "turn": rng.integers(0, 2, size=(B, 1)).astype(np.float32),
             "castling": rng.integers(0, 2, size=(B, 4)).astype(np.float32),
             "mask": np.concatenate([np.ones(B - padded), np.zeros(padded)]).astype(np.float32)}
    # a few boards the logits get right, so the counts are not all zero
    for b in range(3):
        onehot = np.eye(13, dtype=np.float32)[batch["squares"][b]] * 20
        outputs["squares"][b] = onehot.reshape(-1)
        outputs["turn"][b] = batch["turn"][b] * 2 - 1
        outputs["castling"][b] = batch["castling"][b] * 2 - 1
    outputs["squares"][2, :13] = -outputs["squares"][2, :13]  # one wrong square
    return outputs, batch


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("weights,smoothing,mask", [
    (False, 0.0, False), (True, 0.0, True), (False, 0.1, True), (True, 0.1, False),
    (True, 0.1, True)])
def test_cross_entropy_matches_jax(weights, smoothing, mask):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(50, 13)).astype(np.float32) * 3
    labels = rng.integers(0, 13, size=50).astype(np.int32)
    w = (rng.random(13).astype(np.float32) + 0.5) if weights else None
    m = (rng.random(50) < 0.7).astype(np.float32) if mask else None
    ours = tl.weighted_smoothed_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w), smoothing,
        None if m is None else torch.from_numpy(m))
    theirs = jl.weighted_smoothed_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), smoothing,
        None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(ours.item(), float(theirs), atol=ATOL)
    if m is None:  # without a mask it is torch's own cross entropy
        ref = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels).long(),
            weight=None if w is None else torch.from_numpy(w),
            label_smoothing=smoothing)
        np.testing.assert_allclose(ours.item(), ref.item(), atol=ATOL)


def test_bce_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, 4)).astype(np.float32) * 4
    z = rng.integers(0, 2, size=(9, 4)).astype(np.float32)
    m = (np.arange(9) < 6).astype(np.float32)
    for mask in (None, m):
        ours = tl.bce_with_logits(torch.from_numpy(x), torch.from_numpy(z),
                                  None if mask is None else torch.from_numpy(mask))
        theirs = jl.bce_with_logits(jnp.asarray(x), jnp.asarray(z),
                                    None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(ours.item(), float(theirs), atol=ATOL)
    zero = tl.bce_with_logits(torch.from_numpy(x), torch.from_numpy(z),
                              torch.zeros(9))
    assert zero.item() == 0.0  # an all-padding batch divides by 1, not 0


def test_total_loss_and_its_gradient_match_jax():
    outputs, batch = _batch()
    w = np.linspace(0.5, 1.5, 13).astype(np.float32)
    touts = {k: v.requires_grad_() for k, v in _t(outputs).items()}
    loss, aux = tl.total_loss(touts, _t(batch), torch.from_numpy(w), 0.1, 0.7, 1.3)
    jloss, jaux = jl.total_loss(_j(outputs), _j(batch), jnp.asarray(w), 0.1, 0.7, 1.3)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    for key in jaux:
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]), atol=ATOL)
    loss.backward()
    jgrads = jax.grad(lambda o: jl.total_loss(o, _j(batch), jnp.asarray(w), 0.1,
                                              0.7, 1.3)[0])(_j(outputs))
    for key in jgrads:
        np.testing.assert_allclose(touts[key].grad.numpy(), np.asarray(jgrads[key]),
                                   atol=ATOL)
        assert (touts[key].grad[-2:] == 0).all()  # padded rows take no gradient


def test_metric_sums_with_a_padded_batch_match_jax():
    outputs, batch = _batch(seed=3)
    loss = 1.2345
    ours = tm.batch_metric_sums(_t(outputs), _t(batch), torch.tensor(loss))
    theirs = jm.batch_metric_sums(_j(outputs), _j(batch), jnp.asarray(loss))
    assert tuple(ours) == tm.METRIC_SUM_KEYS == jm.METRIC_SUM_KEYS
    for key in theirs:
        assert ours[key].dim() == 0 and ours[key].dtype == torch.float32
        np.testing.assert_allclose(ours[key].item(), float(theirs[key]), atol=ATOL)
    assert ours["n"].item() == 4 and ours["boards_correct"].item() == 2
    nomask = {k: v for k, v in batch.items() if k != "mask"}
    np.testing.assert_allclose(
        tm.batch_metric_sums(_t(outputs), _t(nomask), torch.tensor(loss))["n"].item(), 6)
    total = tm.accumulate(tm.accumulate(None, ours), ours)
    jtotal = jm.accumulate(jm.accumulate(None, theirs), theirs)
    fin, jfin = tm.finalize(total), jm.finalize(jtotal)
    assert fin.keys() == jfin.keys()
    for key in jfin:
        np.testing.assert_allclose(fin[key], jfin[key], atol=ATOL)


@pytest.mark.parametrize("warmup_epochs,epochs,spe", [(1, 10, 7), (0, 3, 5)])
def test_schedule_matches_jax(warmup_epochs, epochs, spe):
    cfg = {"training": {"lr": 3e-4, "epochs": epochs},
           "scheduler": {"warmup_epochs": warmup_epochs}}
    ours, theirs = ts.build_schedule(cfg, spe), js.build_schedule(cfg, spe)
    warm, total = warmup_epochs * spe, epochs * spe
    for step in (0, 1, max(warm - 1, 0), warm, (warm + total) // 2, total - 1, total):
        np.testing.assert_allclose(ours(step), theirs(step), rtol=1e-12, atol=0)
        # the form optax evaluates inside the jitted update, in f32: within
        # 1e-6 of the base rate (the f32 cosine near its zero)
        np.testing.assert_allclose(ours(step), float(theirs(jnp.asarray(step))),
                                   rtol=1e-5, atol=3e-4 * 1e-6)
    assert ours(0) == (0.0 if warm else 3e-4) and abs(ours(total)) < 1e-12
