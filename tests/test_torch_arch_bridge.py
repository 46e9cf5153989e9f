"""The weight bridge and the checkpoints of the CNN and square archs
(chess_vision_tpu_torch/convert/jax_params.py, utils/checkpoint.py): JAX
params and ``batch_stats`` -> the port's state_dict -> back, exactly; the
JAX package's own converter (``convert_reference_model``, which reads timm's
names) on the port's state_dict gives the same trees; and a checkpoint
written by either package serves in the other with the same outputs (f32,
atol/rtol 1e-4 as in tests/test_torch_cnn.py and test_torch_square.py)."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.convert.timm_convert import (
    _verify_against_model,
    convert_reference_model,
)
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import abstract_variables, init_variables
from chess_vision_tpu.train import state as jstate
from chess_vision_tpu.utils import checkpoint as jckpt
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_jax,
    variables_from_state_dict,
)
from chess_vision_tpu_torch.evaluate import load_model
from chess_vision_tpu_torch.models import build_model, init_weights
from chess_vision_tpu_torch.train import state as tstate
from chess_vision_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

ARCHS = ("cnn", "square")


def _cfg(arch: str) -> dict:
    return {"model": {"arch": arch, "name": "test", "input_size": 64,
                      "square_input_size": 32, "head_dropout": 0.0,
                      "drop_path_rate": 0.0, "pin_backbone_bn": False},
            "training": {"mixed_precision": False, "lr": 1e-3, "epochs": 1,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0},
            "scheduler": {"warmup_epochs": 0}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture(scope="module")
def jax_variables():
    """Each arch's JAX variables at 64 px, with running statistics moved off
    the init's 0 and 1."""
    out = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        variables = init_variables(jax_build_model(_cfg(arch)), 64, seed=11)
        out[arch] = {
            "params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree.map(
                lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
                    np.float32), variables.get("batch_stats", {}))}
    return out


def _x():
    return np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _jax_out(cfg, variables):
    out = jax_build_model(cfg).apply(
        {k: v for k, v in variables.items() if v}, jnp.asarray(_x()), train=False)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_out(model):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(torch.from_numpy(_x())).items()}


def _assert_close(ours, theirs):
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_both_ways_with_batch_stats(jax_variables, arch):
    cfg, variables = _cfg(arch), jax_variables[arch]
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], cfg, variables["batch_stats"]))  # strict
    back = variables_from_state_dict(model.state_dict())
    _assert_trees_equal(back["params"], variables["params"])
    _assert_trees_equal(back["batch_stats"], variables["batch_stats"])
    assert (arch == "square") == bool(back["batch_stats"])
    assert not any("num_batches_tracked" in k for k in model.state_dict())


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_converter_reads_the_port_state_dict(arch):
    """timm's names: the JAX package's converter maps the port's state_dict
    (an independent init) to the trees the inverse bridge gives, and they
    are the JAX model's structure."""
    cfg = _cfg(arch)
    sd = init_weights(build_model(cfg), seed=5).state_dict()
    params, batch_stats = convert_reference_model(sd, cfg)
    ours = variables_from_state_dict(sd)
    _assert_trees_equal(params, ours["params"])
    _assert_trees_equal(batch_stats, ours["batch_stats"])
    _verify_against_model(params, batch_stats, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_serves_in_the_jax_package(jax_variables, tmp_path, arch):
    cfg, variables = _cfg(arch), jax_variables[arch]
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], cfg, variables["batch_stats"]))
    path = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(path, tstate.create_train_state(cfg, model, 4),
                          epoch=0, best_val_acc=0.5, config=cfg)
    ckpt = jckpt.load_checkpoint(path)
    template = abstract_variables(jax_build_model(cfg), 64)
    restored = {"params": jckpt.restore_tree(template["params"], ckpt["params"]),
                "batch_stats": jckpt.restore_tree(template.get("batch_stats", {}),
                                                  ckpt["batch_stats"])}
    _assert_trees_equal(jax.tree.map(np.asarray, restored), variables)
    _assert_close(_port_out(model), _jax_out(cfg, restored))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_serves_in_the_port(jax_variables, tmp_path, arch):
    cfg, variables = _cfg(arch), jax_variables[arch]
    jst, _ = jstate.create_train_state(cfg, jax.tree.map(jnp.asarray, variables), 4)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jst.params, jst.opt_state, jst.batch_stats,
                          step=0, epoch=0, best_val_acc=0.0, config=cfg)
    model, loaded_cfg = load_model(path, "cpu")
    assert loaded_cfg == cfg and model.dtype == torch.float32
    _assert_close(_port_out(model), _jax_out(cfg, variables))
    # and the port's trainer resumes it, statistics included
    fresh = tstate.create_train_state(cfg, init_weights(build_model(cfg)), 4)
    tckpt.restore_train_state(fresh, tckpt.load_checkpoint(path))
    _assert_trees_equal(
        variables_from_state_dict(fresh.model.state_dict())["batch_stats"],
        variables["batch_stats"])


def test_inverse_bridge_copies_the_tensors():
    """The trees the inverse bridge gives are copies: a train step that
    updates the model in place (BatchNorm's running statistics, AdamW's
    parameters) leaves a tree taken before it as it was. The bridge once
    handed out numpy views of the tensors' memory."""
    model = init_weights(build_model(_cfg("square")), seed=6)
    variables = variables_from_state_dict(model.state_dict())
    before = {k: v.copy() for k, v in _flat(variables).items()}
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.add_(1.0)
    after = _flat(variables)
    for key, value in before.items():
        np.testing.assert_array_equal(after[key], value, err_msg=key)
