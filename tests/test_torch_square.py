"""The port's ChessSquareCNN (per-square MobileNetV4;
chess_vision_tpu_torch/models/square.py, mobilenet.py, layers.BatchNorm and
ops/square_crop.py) against the JAX package's on the same weights and
BatchNorm statistics, carried over the weight bridge, and the same inputs.

Tolerances: f32 atol/rtol 1e-4 (read 1.2e-6: the same arithmetic in another
order); the crops in bf16 within one bf16 ulp of JAX's (both products round
to bf16 once; the sums run in another order). bf16 logits: atol 2^-8, one
bf16 ulp at the logits' magnitude (up to 0.98), read 0.0: the port rounds
where flax does, BatchNorm computing in f32 and rounding once. BatchNorm
computed in bf16 instead reads 0.0132 (3.4 ulps) and must fail the bound.
The argmax FENs are identical.
BatchNorm in train mode: outputs and updated statistics rtol 1e-5 (f32 sums
in another order)."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import abstract_variables, init_variables
from chess_vision_tpu.models import mobilenet as jax_mobilenet
from chess_vision_tpu.ops import square_crop as jax_crop
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_jax,
    state_dict_from_tree,
)
from chess_vision_tpu_torch.models import build_model, param_count
from chess_vision_tpu_torch.models import layers
from chess_vision_tpu_torch.models.layers import BatchNorm
from chess_vision_tpu_torch.models.mobilenet import MobileNetV4Backbone
from chess_vision_tpu_torch.ops import square_crop

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_ATOL = 2.0**-8


def _cfg(mixed: bool, turn_color_stats: bool = False) -> dict:
    return {"model": {"arch": "square", "input_size": 64, "head_dropout": 0.0,
                      "drop_path_rate": 0.0, "square_input_size": 32,
                      "square_overlap": 1.5,
                      "turn_color_stats": turn_color_stats},
            "training": {"mixed_precision": mixed}}


def _golden_input() -> np.ndarray:
    return np.linspace(0, 1, 2 * 64 * 64 * 3, dtype=np.float32).reshape(
        2, 64, 64, 3)


def _stats(batch_stats, seed):
    """Running statistics away from the init's 0 and 1, so that a model
    that ignored them, or swapped mean and variance, would show."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.05, 0.5, np.shape(a)).astype(
            np.float32), batch_stats)


@pytest.fixture(scope="module")
def golden():
    """The JAX ChessSquareCNN at the golden test's shapes (64 px, square
    input 32, batch 2, init at key 42), with and without turn_color_stats,
    in f32 and bf16: {turn_color_stats: (params, batch_stats, {mixed: out})}."""
    x = jnp.asarray(_golden_input())
    out = {}
    for tcs in (False, True):
        variables = init_variables(jax_build_model(_cfg(False, tcs)), 64, seed=42)
        params = jax.tree.map(np.asarray, variables["params"])
        stats = _stats(variables["batch_stats"], 7)
        refs = {}
        for mixed in (False, True):
            ref = jax_build_model(_cfg(mixed, tcs)).apply(
                {"params": params, "batch_stats": stats}, x, train=False)
            refs[mixed] = {k: np.asarray(v, np.float32) for k, v in ref.items()}
        out[tcs] = (params, stats, refs)
    return out


def _port(params, stats, cfg):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg, stats))
    return model


def _forward(model, x) -> dict:
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}


def test_crop_matrices_equal_jax():
    for img, overlap, out in ((64, 1.5, 32), (256, 1.5, 64), (256, 1.25, 48),
                              (64, 1.0, 8)):
        np.testing.assert_array_equal(square_crop._resize_matrix(out, img // 8),
                                      jax_crop._resize_matrix(out, img // 8))
        ours, pad = square_crop._crop_matrices(img, overlap, out)
        theirs, jpad = jax_crop._crop_matrices(img, overlap, out)
        assert pad == jpad
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_squares_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jax_crop.crop_squares(jnp.asarray(x, dtype), 1.5, 32)
    out = square_crop.crop_squares(torch.from_numpy(x).to(getattr(torch, dtype)),
                                   1.5, 32)
    assert out.shape == (2, 64, 32, 32, 3) and str(out.dtype) == f"torch.{dtype}"
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:  # within one bf16 ulp of each value
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= ulp).all()


def test_mobilenet_backbone_matches_jax():
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    backbone = jax_mobilenet.MobileNetV4Backbone()
    variables = backbone.init(jax.random.key(2), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _stats(variables["batch_stats"], 3)
    ref, _ = backbone.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x))
    ours = MobileNetV4Backbone()
    sd = state_dict_from_tree({"backbone": params})
    sd.update(state_dict_from_tree({"backbone": stats}))
    ours.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    assert out.shape == (4, 1, 1, 480) and ours.num_features == 480
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("turn_color_stats", [False, True])
def test_f32_golden_matches_jax(golden, turn_color_stats):
    params, stats, ref = golden[turn_color_stats]
    out = _forward(_port(params, stats, _cfg(False, turn_color_stats)),
                   _golden_input())
    for k in ("squares", "turn", "castling"):
        assert out[k].dtype == np.float32 and out[k].shape == ref[False][k].shape
        np.testing.assert_allclose(out[k], ref[False][k], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=k)


def _batch_norm_in_bf16(x, mean, var, weight, bias, eps):
    """A planted fault: flax's normalization computed in the activations'
    dtype instead of f32."""
    d = x.dtype
    return (x - mean.to(d)) * (torch.rsqrt(var.to(d) + eps) * weight.to(d)) \
        + bias.to(d)


def test_bf16_golden_fens_match_jax(golden):
    for turn_color_stats in (False, True):
        params, stats, ref = golden[turn_color_stats]
        model = _port(params, stats, _cfg(True, turn_color_stats))
        out = _forward(model, _golden_input())
        for k in ("squares", "turn", "castling"):
            np.testing.assert_allclose(out[k], ref[True][k], atol=BF16_ATOL,
                                       rtol=0, err_msg=k)
        ids = [o["squares"].reshape(-1, 64, 13).argmax(-1)
               for o in (out, ref[True])]
        np.testing.assert_array_equal(*ids)
        np.testing.assert_array_equal(out["turn"] > 0, ref[True]["turn"] > 0)
        np.testing.assert_array_equal(out["castling"] > 0,
                                      ref[True]["castling"] > 0)
        with mock.patch.object(layers, "batch_norm", _batch_norm_in_bf16):
            planted = _forward(model, _golden_input())
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(planted["squares"], ref[True]["squares"],
                                       atol=BF16_ATOL, rtol=0)
    # the weights rounded once serve the same values; BatchNorm stays f32
    once = _forward(model.cast_weights(), _golden_input())
    assert model.backbone.conv_stem.weight.dtype == torch.bfloat16
    assert model.backbone.bn1.weight.dtype == torch.float32
    assert model.backbone.bn1.running_var.dtype == torch.float32
    for k in out:
        np.testing.assert_array_equal(once[k], out[k])


def test_param_count_is_jax_and_the_reference_at_full_width():
    cfg = {"model": {"arch": "square", "input_size": 256}}
    variables = abstract_variables(jax_build_model(cfg), 256)
    count = lambda tree: sum(int(np.prod(a.shape))  # noqa: E731
                             for a in jax.tree.leaves(tree))
    model = build_model(cfg)
    assert param_count(model) == count(variables["params"]) == 2_925_183
    assert (sum(b.numel() for b in model.buffers())
            == count(variables["batch_stats"]))


def test_pinned_batchnorm_keeps_running_statistics_in_train_mode(golden):
    """``model.train()`` switches ``nn.BatchNorm2d`` to the batch's
    statistics; the pinned backbone (the default) keeps normalizing with the
    running ones and leaves them untouched."""
    params, stats, ref = golden[False]
    model = _port(params, stats, _cfg(False))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    model.train()
    out = _forward(model, _golden_input())
    np.testing.assert_allclose(out["squares"], ref[False]["squares"],
                               atol=F32_TOL, rtol=F32_TOL)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k


def test_unpinned_batchnorm_matches_flax_in_train_mode():
    """Batch statistics (biased variance, E[x^2] - E[x]^2, in f32) and the
    running update with momentum 0.99, as flax's BatchNorm, in f32 and
    bf16."""
    for dtype in ("float32", "bfloat16"):
        _check_unpinned_batchnorm(dtype)


def _check_unpinned_batchnorm(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 5, 5, 8)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=(2, 8)).astype(np.float32)
    mean, var = rng.uniform(0.1, 1.0, size=(2, 8)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, epsilon=1e-5,
                      dtype=getattr(jnp, dtype))
    ref, updated = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, getattr(jnp, dtype)), mutable=["batch_stats"])
    ours = BatchNorm(8)
    ours.pinned = False
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in
                          (("weight", scale), ("bias", bias),
                           ("running_mean", mean), ("running_var", var))})
    out = ours.train()(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(out.dtype) == f"torch.{dtype}"
    tol = 1e-5 if dtype == "float32" else 8e-3  # bf16: one ulp
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(updated["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(updated["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-7)
