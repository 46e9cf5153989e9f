"""The plain references against the program on the CPU at toy sizes, and
the frozen work counts against hand counts at the cells' shapes."""

import numpy as np
import pytest
import torch

from benchmarks import inputs, weights, work
from benchmarks.reference import augment, common, convnext, vit
from benchmarks.reference import train as ref_train

TINY_VIT = {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
            "input_size": 64, "patch_size": 16, "embed_dim": 64, "depth": 2,
            "num_heads": 4, "mlp_ratio": 4.0}
CNN = {"arch": "cnn", "name": "convnextv2_tiny.fcmae_ft_in22k_in1k",
       "input_size": 64, "depths": [3, 3, 9, 3], "dims": [96, 192, 384, 768]}


def _weights(spec: list, seed: int) -> tuple[dict, dict]:
    """(numpy tree for the program, tensor tree for the reference)."""
    flat = weights.make_flat(spec, seed, "cpu")
    return weights.tree(spec, flat.numpy().copy()), weights.tree(spec, flat)


def _program(model: dict, params: dict, dtype=torch.float32):
    from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
    from chess_vision_tpu_torch.models import build_model

    cfg = {"model": dict(model, remat=False),
           "training": {"mixed_precision": dtype == torch.bfloat16}}
    net = build_model(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    return net


def _images(model: dict, n: int = 3, seed: int = 5) -> torch.Tensor:
    boards = inputs.boards(n, model["input_size"], seed, "cpu")
    return (torch.from_numpy(boards).float() / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("arch,model", [(vit, TINY_VIT), (convnext, CNN)])
def test_forward_matches_the_program_in_f32(arch, model):
    spec = arch.param_spec(model)
    params_np, params = _weights(spec, 3_000_000_001)
    x = _images(model)
    with torch.no_grad():
        want = _program(model, params_np)(x)
        got = arch.forward(params, x, model)
    for key in ("squares", "turn", "castling"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_w8a8_forward_matches_the_programs_int8_path():
    from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
    from chess_vision_tpu_torch.ops import quant

    spec = vit.param_spec(TINY_VIT)
    params_np, params = _weights(spec, 17)
    x = _images(TINY_VIT, n=8)
    pack = int8_pack_from_jax(quant.quantize_chessvit(params_np, num_heads=4))
    kw = {"gelu": "sigmoid", "shift": "bound"}
    with torch.no_grad():
        prog = quant.chessvit_int8_apply(pack, x.to(torch.bfloat16),
                                         num_heads=4)["squares"]
        ref8 = vit.forward(params, x, TINY_VIT, bits=8, **kw)["squares"]
        ref4 = vit.forward(params, x, TINY_VIT, bits=4, **kw)["squares"]
        ref = vit.forward(params, x, TINY_VIT)["squares"]

    def rel(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

    # read 0.015 and 0.018 at seed 17; W4A4 0.30 away
    assert rel(prog, ref8) < min(rel(prog, ref), 0.03)
    assert rel(ref4, ref8) > 10 * rel(prog, ref8)


def test_bound_shift_gives_the_softmax():
    qkv = torch.randn(2, 17, 3 * 32, dtype=torch.float64)
    torch.testing.assert_close(vit.attention(qkv, 4, "bound"),
                               vit.attention(qkv, 4, "max"))


def test_augment_matches_the_program():
    from chess_vision_tpu_torch import augment as prog_augment

    gen = torch.Generator().manual_seed(9)
    params = augment.draw(6, gen)
    params["order"] = torch.arange(6) * 4          # six of the 24 orders
    params["gray_u"][:2] = 0.05                    # some grayscale, some blur
    params["blur_u"][2:4] = 0.1
    x = torch.rand(6, 3, 32, 32, generator=gen)
    torch.testing.assert_close(augment.apply(x, params),
                               prog_augment.apply_augment(x, params),
                               rtol=1e-5, atol=1e-5)


def test_planes_to_rgb_match_the_program():
    from chess_vision_tpu_torch.ops import preprocess

    pixels, _ = inputs.corpus(3, 32, 4, "cpu")
    planes = ref_train.images(pixels, 32)
    torch.testing.assert_close(augment.ycbcr420_to_rgb01(*planes),
                               preprocess.ycbcr420_to_rgb_planar(*planes) / 255.0)


def test_train_steps_match_the_program_in_f32():
    from chess_vision_tpu_torch.data_device import gather_batch
    from chess_vision_tpu_torch.train.loop import make_steps
    from chess_vision_tpu_torch.train.state import create_train_state

    tcfg = {"training": {"epochs": 2, "lr": 1e-3, "weight_decay": 0.01,
                         "grad_clip_norm": 1.0, "mixed_precision": False,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 1}}
    spec = vit.param_spec(TINY_VIT)
    params_np, params = _weights(spec, 23)
    pixels, labels = inputs.corpus(8, 64, 24, "cpu")
    cw = inputs.class_weights(labels[:, :64])
    net = _program(dict(TINY_VIT, head_dropout=0.0, drop_path_rate=0.0),
                   params_np)
    cfg = dict(tcfg, model=dict(TINY_VIT, remat=False))
    state = create_train_state(cfg, net, 2)
    step, _ = make_steps(state, cfg, cw, (0.5,) * 3, (0.5,) * 3)
    gen = torch.Generator().manual_seed(25)
    aug = [augment.draw(4, gen) for _ in range(2)]
    rows = [torch.arange(4), torch.arange(4, 8)]
    losses = [float(step(gather_batch(pixels, labels, r, torch.ones(4)), a)
                    ["step_loss"]) for r, a in zip(rows, aug)]
    ref = ref_train.steps(vit, TINY_VIT, params,
                          [(pixels[r], labels[r]) for r in rows], aug, cw,
                          tcfg, 2, (0.5,) * 3, (0.5,) * 3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    moved = {n: p for n, p in zip(state.names, state.params)}
    got = moved["backbone.blocks.0.mlp.fc1.weight"].detach().T
    want = (params["backbone"]["block0"]["mlp"]["fc1"]["kernel"]
            + ref["delta"]["backbone/block0/mlp/fc1/kernel"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_vit_b16_work_at_257_tokens():
    model = {"input_size": 256, "patch_size": 16, "embed_dim": 768,
             "depth": 12, "num_heads": 12, "mlp_ratio": 4.0}
    parts = vit.work(model)
    assert parts["embed"] == 256 * 768 * 768               # 0.151 G
    assert parts["gemm"] == 12 * 257 * 7_077_888            # 21.83 G
    assert parts["attention"] == 12 * 2 * 257 * 257 * 768   # 1.218 G
    assert 23.1e9 < sum(parts.values()) < 23.3e9
    ops, _ = work.attention_forward(1, model)
    assert ops == 2 * parts["attention"]
    b_ops, _ = work.attention_backward(1, model)
    assert b_ops == 2 * ops
    i8_ops, i8_bytes = work.int8_products(1, model)
    assert i8_ops == 2 * parts["gemm"]
    # A codes and scales, W codes, scales and bias, outputs: qkv, proj, fc1, fc2
    assert i8_bytes == 12 * (257 * (772 + 4608) + 2304 * 776
                             + 257 * 772 + 768 * 776 + 257 * 3844
                             + 257 * 772 + 3072 * 776 + 257 * 3076
                             + 257 * 3076 + 768 * 3080 + 257 * 3844)


def test_convnextv2_tiny_work_at_256_px():
    parts = convnext.work(dict(CNN, input_size=256))
    assert parts["gemm"] == sum(d * s * s * 8 * c * c for d, s, c in
                                ((3, 64, 96), (3, 32, 192), (9, 16, 384),
                                 (3, 8, 768)))
    assert 5.7e9 < sum(parts.values()) < 5.9e9


def test_fake_quant_levels():
    x = torch.linspace(-1, 1, 101)[None]
    assert torch.unique(common.fake_quant(x, 4, -1)).numel() == 15
    assert torch.unique(common.fake_quant(x, 8, -1)).numel() == 101
