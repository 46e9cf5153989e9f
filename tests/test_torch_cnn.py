"""The port's ChessCNN (ConvNeXtV2-Tiny; chess_vision_tpu_torch/models/cnn.py,
convnext.py and layers.GRN) against the JAX package's on the same weights,
carried over the weight bridge, and the same inputs.

f32: atol/rtol 1e-4 (read 5e-6 on logits up to 3.9: the same arithmetic in
another order; LayerNorm's variance is E[x^2]-E[x]^2 in flax and two-pass in
PyTorch). bf16: atol 6.25e-2, four bf16 ulps at the logits' magnitude
(2..4), read 0.047: the convolutions and Dense layers round their products
before adding the bias in flax, after it here; and the argmax FENs are
identical."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import abstract_variables, init_variables
from chess_vision_tpu.models import convnext as jax_convnext
from chess_vision_tpu.models import layers as jax_layers
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_jax,
    state_dict_from_tree,
)
from chess_vision_tpu_torch.models import build_model, param_count
from chess_vision_tpu_torch.models.cnn import ChessCNN
from chess_vision_tpu_torch.models.convnext import (
    ConvNeXtV2Backbone,
    ConvNeXtV2Block,
)
from chess_vision_tpu_torch.models.layers import GRN

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_ATOL = 6.25e-2
GOLDEN = {"arch": "cnn", "input_size": 64, "head_dropout": 0.0,
          "drop_path_rate": 0.0}


def _cfg(mixed: bool) -> dict:
    return {"model": dict(GOLDEN), "training": {"mixed_precision": mixed}}


def _golden_input() -> np.ndarray:
    return np.linspace(0, 1, 2 * 64 * 64 * 3, dtype=np.float32).reshape(
        2, 64, 64, 3)


def _sub_state_dict(tree: dict, prefix: str) -> dict:
    """The bridge's state_dict of a JAX subtree placed at ``tree``'s path,
    with the keys' ``prefix`` cut off."""
    sd = state_dict_from_tree(tree)
    assert all(k.startswith(prefix) for k in sd)
    return {k[len(prefix):]: v for k, v in sd.items()}


def _perturbed(params, seed):
    """Random values in the init's shapes: GRN's zeros and LayerNorm's ones
    would hide a swapped or ignored parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0.0, 0.2, np.shape(a)).astype(np.float32)
        + np.asarray(a), params)


@pytest.fixture(scope="module")
def golden():
    """The JAX ChessCNN at the golden test's shapes (tests/test_golden.py:
    64 px, batch 2, init at key 42) and its f32 and bf16 forwards."""
    x = jnp.asarray(_golden_input())
    variables = init_variables(jax_build_model(_cfg(False)), 64, seed=42)
    params = jax.tree.map(np.asarray, variables["params"])
    out = {}
    for mixed in (False, True):
        ref = jax_build_model(_cfg(mixed)).apply(variables, x, train=False)
        out[mixed] = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    return params, out


def _port(params, mixed: bool) -> ChessCNN:
    cfg = _cfg(mixed)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model


def _forward(model, x) -> dict:
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}


def _ids(logits):
    return logits.reshape(-1, 64, 13).argmax(-1)


def test_grn_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 5, 12)).astype(np.float32)
    gamma, beta = (rng.normal(size=12).astype(np.float32) for _ in range(2))
    ref = jax_layers.GRN().apply({"params": {"gamma": gamma, "beta": beta}},
                                 jnp.asarray(x))
    grn = GRN(12)
    grn.load_state_dict({"weight": torch.from_numpy(gamma),
                         "bias": torch.from_numpy(beta)})
    with torch.inference_mode():
        out = grn(torch.from_numpy(x))
        out16 = grn(torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # bf16 in: computed in f32, rounded once
    ref16 = jax_layers.GRN().apply({"params": {"gamma": gamma, "beta": beta}},
                                   jnp.asarray(x, jnp.bfloat16))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out16.float().numpy(),
                                  np.asarray(ref16, np.float32))


def test_convnext_block_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 9, 9, 16)).astype(np.float32)
    block = jax_convnext.ConvNeXtV2Block(dim=16)
    params = _perturbed(block.init(jax.random.key(3), jnp.asarray(x))["params"], 4)
    ref = block.apply({"params": params}, jnp.asarray(x))
    ours = ConvNeXtV2Block(16)
    ours.load_state_dict(_sub_state_dict(
        {"backbone": {"stage0_block0": params}}, "backbone.stages.0.blocks.0."))
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


def test_narrow_backbone_matches_jax():
    depths, dims = (1, 1, 2, 1), (8, 16, 32, 64)
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    backbone = jax_convnext.ConvNeXtV2Backbone(depths=depths, dims=dims)
    params = _perturbed(backbone.init(jax.random.key(5), jnp.asarray(x))["params"],
                        6)
    ref = backbone.apply({"params": params}, jnp.asarray(x))
    ours = ConvNeXtV2Backbone(depths, dims)
    ours.load_state_dict(_sub_state_dict({"backbone": params}, "backbone."))
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    assert out.shape == (2, 2, 2, 64) and ours.num_features == 64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


def test_f32_golden_matches_jax(golden):
    params, ref = golden
    out = _forward(_port(params, False), _golden_input())
    for k in ("squares", "turn", "castling"):
        assert out[k].dtype == np.float32 and out[k].shape == ref[False][k].shape
        np.testing.assert_allclose(out[k], ref[False][k], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=k)
    np.testing.assert_array_equal(_ids(out["squares"]), _ids(ref[False]["squares"]))


def test_bf16_golden_fens_match_jax(golden):
    params, ref = golden
    model = _port(params, True)
    out = _forward(model, _golden_input())
    for k in ("squares", "turn", "castling"):
        np.testing.assert_allclose(out[k], ref[True][k], atol=BF16_ATOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(_ids(out["squares"]), _ids(ref[True]["squares"]))
    np.testing.assert_array_equal(out["turn"] > 0, ref[True]["turn"] > 0)
    np.testing.assert_array_equal(out["castling"] > 0, ref[True]["castling"] > 0)
    # the serving Predictor rounds the weights once: the same values
    once = _forward(model.cast_weights(), _golden_input())
    assert model.backbone.stages[0].blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    assert model.backbone.stages[0].blocks[0].mlp.grn.weight.dtype == torch.float32
    assert model.backbone.head["norm"].weight.dtype == torch.float32
    for k in out:
        np.testing.assert_array_equal(once[k], out[k])


def test_param_count_equals_jax_at_full_width():
    cfg = {"model": {"arch": "cnn", "input_size": 256}}
    variables = abstract_variables(jax_build_model(cfg), 256)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    model = build_model(cfg)
    assert param_count(model) == want == 27_878_031
    assert model.backbone.num_features == 768
    assert not list(model.buffers())  # no BatchNorm: nothing in batch_stats


def test_train_mode_drops_and_eval_mode_does_not(golden):
    params, _ = golden
    cfg = _cfg(False)
    cfg["model"].update(head_dropout=0.5, drop_path_rate=0.5)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    x = torch.from_numpy(_golden_input())
    with torch.inference_mode():
        evals = [model(x)["squares"] for _ in range(2)]
        model.train()
        torch.manual_seed(0)
        trained = model(x)["squares"]
    torch.testing.assert_close(evals[0], evals[1], rtol=0, atol=0)
    assert not torch.equal(trained, evals[0])
