"""The weight bridge (chess_vision_tpu_torch/convert/jax_params.py): JAX
ChessViT params -> the port's state_dict, checked by mapping the result back
with the JAX package's own converter (convert_reference_model), which must
return the original tree exactly."""

import jax
import numpy as np
import pytest
import torch

from chess_vision_tpu.convert.timm_convert import convert_reference_model
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
from chess_vision_tpu_torch.models import build_model

torch.set_num_threads(2)

CONFIGS = {
    "narrow": {"input_size": 64, "embed_dim": 64, "depth": 2, "num_heads": 4},
    "vit_b_64px": {"input_size": 64},
}


def _cfg(name):
    return {"model": {"arch": "vit", **CONFIGS[name]},
            "training": {"mixed_precision": False}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_trip_through_reference_converter(name):
    cfg = _cfg(name)
    params = init_variables(jax_build_model(cfg), cfg["model"]["input_size"],
                            seed=7)["params"]
    params = jax.tree.map(np.asarray, params)
    sd = state_dict_from_jax(params, cfg)
    back, batch_stats = convert_reference_model(sd, cfg)
    assert batch_stats == {}
    want, got = _flat(params), _flat(back)
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_keys_and_shapes_match_model(name):
    cfg = _cfg(name)
    params = init_variables(jax_build_model(cfg), cfg["model"]["input_size"],
                            seed=8)["params"]
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    model_sd = build_model(cfg).state_dict()
    assert sd.keys() == model_sd.keys()
    for key, value in sd.items():
        assert value.shape == model_sd[key].shape, key
    assert "type_head.1.weight" in sd
    assert sd["backbone.patch_embed.proj.weight"].shape[1:] == (3, 16, 16)


def test_other_archs_not_ported():
    with pytest.raises(NotImplementedError):
        state_dict_from_jax({}, {"model": {"arch": "cnn"}})
