"""``model.remat="attn_out"`` (``models/vit_backbone.py``): each block's
input and attention output are kept and everything else is recomputed in the
backward, so the attention forward runs once a block, as without remat, and
the gradients are those of ``remat=False``; against the JAX package's
``remat="attn_out"`` on the same weights and input. Then
``resolve_remat``'s three tiers on the cases of ``tests/test_remat_policy.py``
in the port's units (``models/__init__.py``: bytes per image measured on the
card).

Tolerances: ``attn_out`` against ``False`` bit for bit (the recomputed ops
are the same ops on the same values; dropout and drop path on, their
generator state restored by the checkpoint); against JAX the f32 bound of
``tests/test_torch_train_step.py`` (2e-5 of each tensor's largest
gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu_torch import models as tmodels
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)
GB = 2**30


def _cfg(mixed, remat, dropout=0.0):
    return {"model": {"arch": "vit", "input_size": 64, "embed_dim": 64,
                      "depth": 2, "num_heads": 4, "head_dropout": dropout,
                      "drop_path_rate": dropout, "remat": remat},
            "training": {"mixed_precision": mixed}}


def _grads(cfg, x, seed=3):
    """Gradients of the summed outputs and the number of attention forwards
    (plain versions on the CPU, counted through the wrapper)."""
    model = tmodels.init_weights(tmodels.build_model(cfg), seed=0).train()
    calls = []
    forward = attn.fused_qkv_attention_fwd

    def counted(qkv, heads):
        calls.append(qkv.shape)
        return forward(qkv, heads)

    torch.manual_seed(seed)
    attn.fused_qkv_attention_fwd = counted
    try:
        out = model(x)
        sum(v.float().sum() for v in out.values()).backward()
    finally:
        attn.fused_qkv_attention_fwd = forward
    return {n: p.grad for n, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("mixed", [False, True])
def test_attn_out_gives_the_gradients_of_no_remat(mixed):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 64, 64, 3)).astype(np.float32))
    ref, calls_ref = _grads(_cfg(mixed, False, 0.3), x)
    ours, calls = _grads(_cfg(mixed, "attn_out", 0.3), x)
    full, calls_full = _grads(_cfg(mixed, True, 0.3), x)
    # the attention forward runs once a block (depth 2), twice with full remat
    assert (calls_ref, calls, calls_full) == (2, 2, 4)
    for name in ref:
        torch.testing.assert_close(ours[name], ref[name], rtol=0, atol=0)
        torch.testing.assert_close(full[name], ref[name], rtol=0, atol=0)


def test_attn_out_matches_jax_attn_out():
    cfg = _cfg(False, "attn_out")
    jmodel = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, init_variables(jmodel, 64, seed=2)["params"])
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                           rngs={"dropout": jax.random.key(0)})
        return sum(jnp.sum(v) for v in out.values())

    jgrads = state_dict_from_tree(jax.tree.map(np.asarray,
                                               jax.grad(jloss)(params)))
    model = tmodels.build_model(cfg).train()
    model.load_state_dict(state_dict_from_tree(params))
    assert model.backbone.remat == "attn_out"
    out = model(torch.from_numpy(x))
    sum(v.sum() for v in out.values()).backward()
    for name, p in model.named_parameters():
        ref = jgrads[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 2e-5, (name, err)


def _bytes(batch, per_image):
    """The device size at which ``batch`` images of ``per_image`` activation
    bytes exactly fit beside the state and headroom."""
    return (tmodels.STATE_BYTES + tmodels.HEADROOM_BYTES
            + per_image * batch)


# the cases of tests/test_remat_policy.py, moved into the port's units: the
# JAX test's 16 GB chip and its device cache become device sizes at the
# edges of the port's tiers (86 MB and ATTN_OUT_BYTES_PER_IMAGE an image)
@pytest.mark.parametrize("case", ["noremat", "noremat_at_edge", "attn_out",
                                  "attn_out_at_edge", "full"])
def test_resolve_remat_tiers(case):
    no, mid = tmodels.NOREMAT_BYTES_PER_IMAGE, tmodels.ATTN_OUT_BYTES_PER_IMAGE
    assert mid < no
    batch = 256
    device_bytes, want = {
        "noremat": (_bytes(batch, no) + GB, False),
        "noremat_at_edge": (_bytes(batch, no), False),
        "attn_out": (_bytes(batch, (no + mid) / 2), "attn_out"),
        "attn_out_at_edge": (_bytes(batch, mid), "attn_out"),
        "full": (_bytes(batch, mid) - 1, True),
    }[case]
    assert tmodels.resolve_remat(batch, device_bytes=device_bytes) == want


def test_resolve_remat_is_monotone_and_build_model_takes_its_answer():
    order = {False: 0, "attn_out": 1, True: 2}
    answers = [order[tmodels.resolve_remat(b, device_bytes=80 * GB)]
               for b in (32, 64, 256, 512, 1024, 2048, 4096, 8192, 1 << 16)]
    assert answers == sorted(answers) and set(answers) == {0, 1, 2}
    assert tmodels.normalize_remat("attn_out") == "attn_out"
    cfg = _cfg(True, tmodels.normalize_remat("ATTN_OUT"))
    assert tmodels.build_model(cfg).backbone.remat == "attn_out"
