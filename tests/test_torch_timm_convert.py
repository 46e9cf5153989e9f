"""The port's timm converter and pretrained loader
(chess_vision_tpu_torch/convert/timm.py, train.maybe_load_pretrained)
against the JAX package's converter (chess_vision_tpu/convert/timm_convert.py),
bit for bit, through the port's weight bridge (convert/jax_params.py).

No timm weights exist here, so the inputs are random ``state_dict``s with
timm's keys and shapes made from a seed: a narrow ViT at 224 px (a 14 x 14
``pos_embed`` that the conversion resamples to 16 x 16), a ConvNeXtV2 at
small depths with GRN's (1, 1, 1, C) weights, and the full 0.5-width
MobileNetV4 with its BatchNorm statistics and ``num_batches_tracked``. Every
comparison is exact: the two converters do the same copies and the same
bicubic resample in f32."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import sys
from unittest import mock

import numpy as np
import pytest
import torch

from chess_vision_tpu.convert import timm_convert as jconv
from chess_vision_tpu.utils import checkpoint as jckpt
from chess_vision_tpu_torch.convert import timm as tconv
from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_jax,
    tree_from_state_dict,
    variables_from_state_dict,
)
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.models.mobilenet import _CONV_SMALL_ARCH, _round_channels
from chess_vision_tpu_torch.train.__main__ import maybe_load_pretrained
from chess_vision_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

DIM, DEPTH, HEADS = 64, 2, 2
CNN_DEPTHS, CNN_DIMS = (1, 1, 2, 1), (8, 16, 24, 32)


def _randn(gen, *shape):
    return torch.from_numpy(gen.normal(size=shape).astype(np.float32))


def _vit_sd(gen, dim=DIM, depth=DEPTH, grid=14) -> dict:
    sd = {"patch_embed.proj.weight": _randn(gen, dim, 3, 16, 16),
          "patch_embed.proj.bias": _randn(gen, dim),
          "cls_token": _randn(gen, 1, 1, dim),
          "pos_embed": _randn(gen, 1, 1 + grid * grid, dim),
          "norm.weight": _randn(gen, dim), "norm.bias": _randn(gen, dim),
          "head.weight": _randn(gen, 10, dim), "head.bias": _randn(gen, 10)}
    for i in range(depth):
        b = f"blocks.{i}."
        for name, (o, k) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                             ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
            sd[b + name + ".weight"] = _randn(gen, o, k)
            sd[b + name + ".bias"] = _randn(gen, o)
        for ln in ("norm1", "norm2"):
            sd[b + ln + ".weight"] = _randn(gen, dim)
            sd[b + ln + ".bias"] = _randn(gen, dim)
    return sd


def _convnext_sd(gen, depths=CNN_DEPTHS, dims=CNN_DIMS) -> dict:
    sd = {"stem.0.weight": _randn(gen, dims[0], 3, 4, 4),
          "stem.0.bias": _randn(gen, dims[0]),
          "stem.1.weight": _randn(gen, dims[0]), "stem.1.bias": _randn(gen, dims[0]),
          "head.norm.weight": _randn(gen, dims[-1]),
          "head.norm.bias": _randn(gen, dims[-1]),
          "head.fc.weight": _randn(gen, 10, dims[-1]), "head.fc.bias": _randn(gen, 10)}
    for s in range(1, 4):
        d = f"stages.{s}.downsample."
        sd[d + "0.weight"] = _randn(gen, dims[s - 1])
        sd[d + "0.bias"] = _randn(gen, dims[s - 1])
        sd[d + "1.weight"] = _randn(gen, dims[s], dims[s - 1], 2, 2)
        sd[d + "1.bias"] = _randn(gen, dims[s])
    for s, depth in enumerate(depths):
        c = dims[s]
        for j in range(depth):
            b = f"stages.{s}.blocks.{j}."
            sd[b + "conv_dw.weight"] = _randn(gen, c, 1, 7, 7)
            sd[b + "conv_dw.bias"] = _randn(gen, c)
            sd[b + "norm.weight"] = _randn(gen, c)
            sd[b + "norm.bias"] = _randn(gen, c)
            sd[b + "mlp.fc1.weight"] = _randn(gen, 4 * c, c)
            sd[b + "mlp.fc1.bias"] = _randn(gen, 4 * c)
            sd[b + "mlp.grn.weight"] = _randn(gen, 1, 1, 1, 4 * c)
            sd[b + "mlp.grn.bias"] = _randn(gen, 1, 1, 1, 4 * c)
            sd[b + "mlp.fc2.weight"] = _randn(gen, c, 4 * c)
            sd[b + "mlp.fc2.bias"] = _randn(gen, c)
    return sd


def _mobilenet_sd(gen) -> dict:
    """timm's mobilenetv4_conv_small_050 key space, num_batches_tracked and
    the post-pool conv_head included."""
    sd = {}

    def conv_bn(conv, bn, o, i, k):
        sd[conv] = _randn(gen, o, i, k, k)
        sd[bn + ".weight"] = _randn(gen, o).abs() + 0.5
        sd[bn + ".bias"] = _randn(gen, o)
        sd[bn + ".running_mean"] = _randn(gen, o)
        sd[bn + ".running_var"] = _randn(gen, o).abs() + 0.5
        sd[bn + ".num_batches_tracked"] = torch.tensor(7)

    ch = _round_channels(16)
    conv_bn("conv_stem.weight", "bn1", ch, 3, 3)
    for si, stage in enumerate(_CONV_SMALL_ARCH):
        for bi, blk in enumerate(stage):
            t = f"blocks.{si}.{bi}"
            if blk[0] == "cn":
                out = _round_channels(blk[3] * 0.5)
                conv_bn(f"{t}.conv.weight", f"{t}.bn1", out, ch, blk[1])
            else:
                _, a, m, _, e, c = blk
                out, mid = _round_channels(c * 0.5), _round_channels(ch * e)
                subs = [("dw_start", ch, 1, a)] * bool(a) + [("pw_exp", mid, ch, 1)]
                subs += [("dw_mid", mid, 1, m)] * bool(m) + [("pw_proj", out, mid, 1)]
                for sub, o, i, k in subs:
                    conv_bn(f"{t}.{sub}.conv.weight", f"{t}.{sub}.bn", o, i, k)
            ch = out
    sd["conv_head.weight"] = _randn(gen, 1280, ch, 1, 1)
    sd["conv_head.bias"] = _randn(gen, 1280)
    return sd


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
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:8]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cfg(arch: str, **model) -> dict:
    base = {"vit": {"embed_dim": DIM, "depth": DEPTH, "num_heads": HEADS,
                    "input_size": 256},
            "cnn": {"input_size": 64},
            "square": {"input_size": 64, "square_input_size": 32}}[arch]
    return {"model": {"arch": arch, "name": "test", **base, **model},
            "training": {"mixed_precision": False}}


@pytest.mark.parametrize("arch", ("vit", "cnn", "square"))
def test_backbone_matches_the_jax_converter(arch):
    """backbone_state_dict through the bridge gives convert_vit_backbone's
    (pos_embed resampled 14 x 14 -> 16 x 16), convert_convnext_backbone's
    (GRN flattened) and convert_mobilenet_backbone's params and batch_stats,
    bit for bit; timm's classifier and num_batches_tracked are left out."""
    gen = np.random.default_rng(1)
    sd = {"vit": _vit_sd, "cnn": _convnext_sd, "square": _mobilenet_sd}[arch](gen)
    got = variables_from_state_dict(tconv.backbone_state_dict(sd, arch, 256))
    stats = {}
    if arch == "vit":
        want = jconv.convert_vit_backbone(sd, target_grid=16)
        assert got["params"]["backbone"]["pos_embed"].shape == (1, 257, DIM)
    elif arch == "cnn":
        want = jconv.convert_convnext_backbone(sd, depths=CNN_DEPTHS)
    else:
        want, stats = jconv.convert_mobilenet_backbone(sd)
    _assert_trees_equal(got["params"]["backbone"], want)
    _assert_trees_equal(got["batch_stats"].get("backbone", {}), stats)


def _reference_sd(arch: str, gen) -> dict:
    """A reference training checkpoint's ``model``: the timm backbone under
    ``backbone.``, the heads as Sequential(Dropout, Linear) (ChessCNN's
    type/color heads as 1x1 convolutions, the square model's turn/castling
    bare on global_head's 64 features) and the reference's buffers."""
    backbone = {"vit": lambda: _vit_sd(gen),
                "cnn": lambda: _convnext_sd(gen, (3, 3, 9, 3), (96, 192, 384, 768)),
                "square": lambda: _mobilenet_sd(gen)}[arch]()
    sd = {"backbone." + k: v for k, v in backbone.items()}
    feat = {"vit": DIM, "cnn": 768, "square": 480}[arch]
    for name, out in (("type_head", 7), ("color_head", 3), ("turn_head", 1),
                      ("castling_head", 4)):
        key, fan = f"{name}.1", feat
        if arch == "square" and name in ("turn_head", "castling_head"):
            key, fan = name, 64
        conv = arch == "cnn" and name in ("type_head", "color_head")
        sd[key + ".weight"] = (_randn(gen, out, fan, 1, 1) if conv
                               else _randn(gen, out, fan))
        sd[key + ".bias"] = _randn(gen, out)
    if arch == "square":
        sd["global_head.1.weight"] = _randn(gen, 64, 64 * feat)
        sd["global_head.1.bias"] = _randn(gen, 64)
    sd["class_to_type"] = torch.arange(13)
    return sd


@pytest.mark.parametrize("arch", ("vit", "cnn", "square"))
def test_reference_checkpoint_gives_the_jax_converters_model(arch):
    """reference_state_dict loads strictly into build_model(cfg) and equals
    convert_reference_model followed by state_dict_from_jax, tensor for
    tensor (the ViT at input_size 256 from 224 px weights; the full
    ConvNeXtV2-Tiny and MobileNetV4 at 0.5 width)."""
    cfg = _cfg(arch)
    sd = _reference_sd(arch, np.random.default_rng(2))
    got = tconv.reference_state_dict(sd, cfg)
    tconv.check_state_dict(got, build_model(cfg).state_dict())
    model = build_model(cfg)
    model.load_state_dict(got)
    params, stats = jconv.convert_reference_model(sd, cfg)
    jconv._verify_against_model(params, stats, cfg)
    want = state_dict_from_jax(params, cfg, stats)
    assert model.state_dict().keys() == want.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _run_both(tmp_path, argv: list[str]) -> tuple[dict, dict]:
    """The port's CLI and the JAX package's on the same flags; each output
    read by the other package's ``load_checkpoint``."""
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tconv.main(argv + ["--out", ours])
    with mock.patch.object(sys, "argv", ["timm_convert", *argv, "--out", theirs]):
        jconv.main()
    return jckpt.load_checkpoint(ours), tckpt.load_checkpoint(theirs)


@pytest.mark.parametrize("mode", ("backbone", "reference"))
def test_cli_output_is_the_jax_clis(tmp_path, mode):
    """``--torch-ckpt`` (a MobileNet, so batch_stats too, wrapped as
    ``{"model": ...}``) and ``--reference-ckpt`` (a ViT with its config,
    epoch and best_val_acc): the port's ``--out`` read by the JAX package's
    ``load_checkpoint`` equals what ``timm_convert.main`` writes, read by
    the port's."""
    gen = np.random.default_rng(3)
    path = str(tmp_path / "in.pth")
    if mode == "backbone":
        torch.save({"model": _mobilenet_sd(gen)}, path)
        argv = ["--torch-ckpt", path, "--arch", "square"]
    else:
        cfg = _cfg("vit", input_size=64)
        torch.save({"model": _reference_sd("vit", gen), "config": cfg,
                    "epoch": 5, "best_val_acc": 0.75}, path)
        argv = ["--reference-ckpt", path]
    ours, theirs = _run_both(tmp_path, argv)
    for tree in ("params", "batch_stats", "opt_state"):
        _assert_trees_equal(ours[tree], theirs[tree])
    for key in ("step", "epoch", "best_val_acc", "config"):
        assert ours[key] == theirs[key], key
    if mode == "backbone":
        assert ours["batch_stats"] and ours["config"] == {"arch": "square"}
    else:
        assert ours["epoch"] == 5 and ours["best_val_acc"] == 0.75


def _pretrained_cfg(path: str) -> dict:
    return _cfg("vit", pretrained=True, pretrained_path=path)


def test_loader_takes_a_timm_pth_and_a_converted_ckpt(tmp_path):
    """maybe_load_pretrained converts a timm .pth at model.input_size (the
    14 x 14 grid resampled to 16 x 16) and reads the CLI's .ckpt of the same
    file: both give the converter's backbone bit for bit; the heads keep
    their init."""
    sd = _vit_sd(np.random.default_rng(4))
    pth, ckpt = str(tmp_path / "vit.pth"), str(tmp_path / "vit.ckpt")
    torch.save(sd, pth)
    tconv.main(["--torch-ckpt", pth, "--arch", "vit", "--input-size", "256",
                "--out", ckpt])
    want = tconv.backbone_state_dict(sd, "vit", 256)
    for path in (pth, ckpt):
        model = build_model(_pretrained_cfg(path))
        heads = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("type_head")}
        assert maybe_load_pretrained(model, _pretrained_cfg(path))
        got = model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)
        assert all(torch.equal(got[k], v) for k, v in heads.items())
    assert not maybe_load_pretrained(
        build_model(_pretrained_cfg(str(tmp_path / "none.ckpt"))),
        _pretrained_cfg(str(tmp_path / "none.ckpt")))


def test_loader_refuses_a_partial_backbone(tmp_path):
    """A file without one block's attn.qkv.weight raises, naming it: a
    converted .ckpt (which the loader once took with strict=False, leaving
    that tensor at random init) and a timm .pth alike; so do a backbone of
    another depth and the structural check's three faults."""
    sd = _vit_sd(np.random.default_rng(5))
    tree = tree_from_state_dict(tconv.backbone_state_dict(sd, "vit", 256))
    del tree["backbone"]["block1"]["attn"]["qkv"]["kernel"]
    ckpt = str(tmp_path / "partial.ckpt")
    tckpt.write_checkpoint(ckpt, tree["backbone"], {}, step=0, epoch=0,
                           best_val_acc=0.0, config={"arch": "vit"})
    with pytest.raises(ValueError, match=r"missing 1: \['backbone.blocks.1.attn.qkv.weight'\]"):
        maybe_load_pretrained(build_model(_pretrained_cfg(ckpt)), _pretrained_cfg(ckpt))
    pth = str(tmp_path / "partial.pth")
    torch.save({k: v for k, v in sd.items() if k != "blocks.1.attn.qkv.weight"}, pth)
    with pytest.raises(ValueError, match="blocks.1.attn.qkv.weight"):
        maybe_load_pretrained(build_model(_pretrained_cfg(pth)), _pretrained_cfg(pth))
    deeper = str(tmp_path / "deeper.pth")
    torch.save(_vit_sd(np.random.default_rng(6), depth=DEPTH + 1), deeper)
    with pytest.raises(ValueError, match=r"extra 12: \['backbone.blocks.2"):
        maybe_load_pretrained(build_model(_pretrained_cfg(deeper)),
                              _pretrained_cfg(deeper))
    want = {"a": torch.zeros(2), "b": torch.zeros(3)}
    with pytest.raises(ValueError, match=r"missing 1: \['b'\]; extra 1: \['c'\]; "
                                         r"shape mismatch: \[\('a', \(2,\), \(4,\)\)\]"):
        tconv.check_state_dict({"a": torch.zeros(4), "c": torch.zeros(1)}, want)
