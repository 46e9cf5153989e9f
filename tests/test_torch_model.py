"""The port's ChessViT (chess_vision_tpu_torch/models) against the JAX
package's on the same weights (through the weight bridge) and inputs.

f32: outputs allclose at atol/rtol 1e-4 and identical argmax FENs. bf16:
atol 6.25e-2 on the logits (two bf16 ulps at their magnitude, 4..8): bf16
rounds at other points in the two (flax rounds the product before adding the
bias; LayerNorm variance as E[x^2]-E[x]^2 in flax, two-pass in PyTorch), and
FENs agree on every square whose top-2 margin exceeds that tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.models import common as jax_common
from chess_vision_tpu.models import layers as jax_layers
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
from chess_vision_tpu_torch.models import build_model, common, layers

torch.set_num_threads(2)

BF16_ATOL = 6.25e-2

NARROW = {"input_size": 64, "embed_dim": 64, "depth": 2, "num_heads": 4}
HEAD64 = {"input_size": 64, "embed_dim": 128, "depth": 2, "num_heads": 2}
GOLDEN = {"input_size": 64, "head_dropout": 0.0, "drop_path_rate": 0.0}


def _pair(model_cfg, mixed, seed):
    cfg = {"model": {"arch": "vit", **model_cfg},
           "training": {"mixed_precision": mixed}}
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, model_cfg["input_size"], seed=seed)
    tmodel = build_model(cfg)
    tmodel.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]), cfg))
    return jmodel, variables, tmodel


def _run(model_cfg, mixed, x, seed=0):
    jmodel, variables, tmodel = _pair(model_cfg, mixed, seed)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x))
    ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("squares", "turn", "castling"):
        assert out[k].dtype == np.float32 and out[k].shape == ref[k].shape
    return ref, out


def _normal_images(size, seed=0):
    return np.random.default_rng(seed).normal(size=(2, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name,model_cfg", [("narrow", NARROW), ("head64", HEAD64)])
def test_f32_matches_jax(name, model_cfg):
    ref, out = _run(model_cfg, False, _normal_images(64))
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["squares"].reshape(-1, 64, 13).argmax(-1),
                                  ref["squares"].reshape(-1, 64, 13).argmax(-1))
    np.testing.assert_array_equal(out["turn"] > 0, ref["turn"] > 0)
    np.testing.assert_array_equal(out["castling"] > 0, ref["castling"] > 0)


def test_f32_golden_config_matches_jax():
    """Full ViT-B width at 64 px with the golden test's input
    (tests/test_golden.py)."""
    x = np.linspace(0, 1, 2 * 64 * 64 * 3, dtype=np.float32).reshape(2, 64, 64, 3)
    ref, out = _run(GOLDEN, False, x, seed=42)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["squares"].reshape(-1, 64, 13).argmax(-1),
                                  ref["squares"].reshape(-1, 64, 13).argmax(-1))


@pytest.mark.parametrize("name,model_cfg", [("narrow", NARROW), ("head64", HEAD64)])
def test_bf16_matches_jax(name, model_cfg):
    ref, out = _run(model_cfg, True, _normal_images(64, seed=1))
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=BF16_ATOL, rtol=0, err_msg=k)
    logits = ref["squares"].reshape(-1, 64, 13)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > BF16_ATOL
    assert confident.mean() > 0.5
    ours = out["squares"].reshape(-1, 64, 13).argmax(-1)
    np.testing.assert_array_equal(ours[confident], logits.argmax(-1)[confident])


def test_bf16_cast_once_equals_cast_at_use():
    _, _, tmodel = _pair(NARROW, True, seed=3)
    x = torch.from_numpy(_normal_images(64, seed=2))
    with torch.inference_mode():
        at_use = tmodel(x)
        once = tmodel.cast_weights()(x)
    assert tmodel.backbone.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert tmodel.backbone.norm.weight.dtype == torch.float32
    for k in at_use:
        torch.testing.assert_close(once[k], at_use[k], rtol=0, atol=0)


def test_combine_type_color_matches_jax():
    rng = np.random.default_rng(4)
    t = rng.normal(size=(2, 8, 8, 7)).astype(np.float32)
    c = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    ours = common.combine_type_color(torch.from_numpy(t), torch.from_numpy(c))
    ref = jax_common.combine_type_color(jnp.asarray(t), jnp.asarray(c))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("in_size,out_size", [(16, 8), (14, 8), (4, 8), (8, 8)])
def test_adaptive_pool_matches_jax(in_size, out_size):
    np.testing.assert_array_equal(layers.make_pool_matrix(in_size, out_size).numpy(),
                                  np.asarray(jax_layers.make_pool_matrix(in_size, out_size)))
    x = np.random.default_rng(5).normal(size=(2, in_size, in_size, 5)).astype(np.float32)
    ours = layers.adaptive_avg_pool_nhwc(torch.from_numpy(x), (out_size, out_size))
    ref = jax_layers.adaptive_avg_pool_nhwc(jnp.asarray(x), (out_size, out_size))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("arch", ["cnn", "square"])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError):
        build_model({"model": {"arch": arch}})
