"""The f32 forms of the attention kernels (K2 and K3 on f32 inputs,
``csrc/attention_f32.cu``) through their plain versions on the CPU, against
the JAX package's Pallas kernels in interpret mode on the same f32 inputs,
at N <= 288 and N > 288 (the bf16 backward's short and long routes; in f32
the cluster route takes up to 512 tokens); then an f32 ViT through the port's
train step and its serving path against the JAX package's. The kernels
themselves run on the card only (``tests/test_torch_f32_cuda.py``).

Tolerances. Forward 2e-6 and backward 1e-5 absolute (values of order 1):
the same f32 arithmetic, the sums in another order (the JAX kernel divides
P [V | 1] once; the plain version normalizes p first). Train step: the
f32 bounds of ``tests/test_torch_train_step.py`` (loss 1e-5, gradients 2e-5
of each tensor's largest entry). Serving: FEN strings identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.fen import assemble_fens_batch as jax_fens
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.ops.attention import (
    _kernel_attention,
    _kernel_attention_bwd,
)
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

# (B, N, H, Dh): the bf16 short route's ragged edge, the ViT's 257 tokens at
# narrow heads, and past the short route's 288 (the long route in bf16)
SHAPES = [(2, 17, 2, 32), (1, 257, 2, 64), (1, 300, 2, 16)]


def _qkv_g(B, N, H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32),
            rng.normal(size=(B, N, H * Dh)).astype(np.float32))


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_f32_forward_plain_matches_jax_kernel(B, N, H, Dh):
    qkv, _ = _qkv_g(B, N, H, Dh)
    ours = attn.fused_qkv_attention(torch.from_numpy(qkv), H)
    theirs = np.asarray(_kernel_attention(jnp.asarray(qkv), H, interpret=True))
    assert ours.dtype == torch.float32 and theirs.dtype == np.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=2e-6)


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_f32_backward_plain_matches_jax_kernel(B, N, H, Dh):
    qkv, g = _qkv_g(B, N, H, Dh, seed=1)
    ours = attn.fused_qkv_attention_bwd(torch.from_numpy(qkv),
                                        torch.from_numpy(g), H)
    theirs = np.asarray(_kernel_attention_bwd(jnp.asarray(qkv), jnp.asarray(g),
                                              H, interpret=True))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)
    # the f32 route takes every token count and counts apart from bf16's
    assert attn.bwd_route(N, torch.float32) == "f32"


def test_f32_plain_path_counts_no_kernel_launch():
    """On the CPU the wrappers run the plain versions: no counter moves, the
    bf16 ones nor the f32 ones; autograd goes through the operator."""
    qkv, g = _qkv_g(1, 17, 2, 16)
    before = (attn.LAUNCHES, attn.BWD_LAUNCHES, attn.F32_LAUNCHES,
              attn.F32_BWD_LAUNCHES)
    x = torch.from_numpy(qkv).requires_grad_()
    out = attn.fused_qkv_attention(x, 2)
    out.backward(torch.from_numpy(g))
    assert (attn.LAUNCHES, attn.BWD_LAUNCHES, attn.F32_LAUNCHES,
            attn.F32_BWD_LAUNCHES) == before
    torch.testing.assert_close(
        x.grad, attn.reference_attention_bwd(x.detach(), torch.from_numpy(g), 2),
        rtol=0, atol=0)


def _cfg(**model):
    return {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                      "input_size": 64, "embed_dim": 64, "depth": 2,
                      "num_heads": 4, "head_dropout": 0.0, "drop_path_rate": 0.0,
                      "remat": False, **model},
            "training": {"mixed_precision": False, "lr": 1e-3, "epochs": 2,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 0}}


@pytest.fixture(scope="module")
def f32_pair():
    cfg = _cfg()
    jmodel = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, init_variables(jmodel, 64, seed=4)["params"])
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_tree(params))
    return cfg, jmodel, params, model


def test_f32_vit_gradients_match_jax(f32_pair):
    """The f32 ViT's loss gradients through the attention operator (plain
    backward on the CPU) against JAX's autodiff of the same f32 model."""
    from chess_vision_tpu.train.losses import total_loss as jax_loss
    from chess_vision_tpu_torch.train.losses import total_loss

    cfg, jmodel, params, model = f32_pair
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    batch = {"squares": rng.integers(0, 13, (3, 64)).astype(np.int32),
             "turn": rng.integers(0, 2, (3, 1)).astype(np.float32),
             "castling": rng.integers(0, 2, (3, 4)).astype(np.float32),
             "mask": np.ones(3, np.float32)}

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return jax_loss(out, {k: jnp.asarray(v) for k, v in batch.items()},
                        None, 0.1, 1.0, 1.0)[0]

    jval, jgrads = jax.value_and_grad(jloss)(params)
    model.zero_grad()
    loss, _ = total_loss(model(torch.from_numpy(x)),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         None, 0.1, 1.0, 1.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    theirs = state_dict_from_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        ref = theirs[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 2e-5, (name, err)


def test_f32_serving_fens_match_jax(f32_pair):
    """``Predictor`` on an f32 model (the wrappers' f32 path) against the JAX
    model on the same f32 normalized input: identical FENs."""
    from chess_vision_tpu_torch.serve import Predictor

    cfg, jmodel, params, _ = f32_pair
    images = np.random.default_rng(9).integers(0, 256, (6, 64, 64, 3),
                                               dtype=np.uint8)
    predictor = Predictor((cfg, params), batch_size=4, device="cpu")
    assert predictor.model.dtype == torch.float32
    ours = predictor.predict_array(images)
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    out = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    preds = np.asarray(jnp.argmax(out["squares"].reshape(-1, 64, 13), -1))
    theirs = jax_fens(preds.astype(np.uint8), np.asarray(out["turn"][:, 0] > 0),
                      np.asarray(out["castling"] > 0))
    assert ours == theirs
