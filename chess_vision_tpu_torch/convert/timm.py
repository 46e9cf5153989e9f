"""Convert timm backbones and reference training checkpoints (``.pth``) to
this package's models, without JAX.

Counterpart of ``chess_vision_tpu/convert/timm_convert.py``. This package's
modules carry timm's names and PyTorch's layouts, so a timm ``state_dict``
needs no transpose: the conversion picks the tensors each model has, checks
them, and changes three things.

- ViT-B/16: ``pos_embed`` trained at 224 px (a 14 x 14 grid) is resampled
  bicubically to ``input_size // 16`` (``resample_pos_embed``, timm's
  ``resample_abs_pos_embed``), the class token kept.
- ConvNeXtV2-Tiny: GRN's weight and bias, (1, 1, 1, C) in older timm, become
  (C,).
- MobileNetV4-Conv-Small at 0.5 width: ``num_batches_tracked`` is dropped
  (this package keeps none); ``running_mean`` / ``running_var`` are the
  BatchNorm statistics; ``conv_head`` stays timm's 1x1 ``Conv2d``.

``backbone_state_dict`` converts a timm backbone to the ``backbone.*``
entries of a model; ``reference_state_dict`` a reference training
checkpoint's ``model`` (heads as ``Sequential(Dropout, Linear)``, ChessCNN's
1x1-conv heads, the square model's ``global_head.1``) to the ``state_dict``
of ``models.build_model(cfg)``; ``check_state_dict`` raises on missing keys,
extra keys and shape mismatches, naming them. Pretrained init is
load-bearing for out-of-distribution accuracy: ``train.maybe_load_pretrained``
takes a converted ``.ckpt`` or converts a timm ``.pth`` on the fly.

CLI (the flags of the JAX package's converter; ``--out`` is written in the
shared checkpoint layout, which either package reads):

    python -m chess_vision_tpu_torch.convert.timm \\
        --torch-ckpt vit_weights.pth --arch vit --out pretrained/<name>.ckpt
    python -m chess_vision_tpu_torch.convert.timm \\
        --reference-ckpt best.pth --out converted_best.ckpt

A backbone file holds the backbone as ``params`` (and ``batch_stats`` for
MobileNet) with config ``{"arch": ...}``; a reference file holds the whole
model with the reference's ``config``, ``epoch`` and ``best_val_acc``.
"""

from __future__ import annotations

import argparse
import re

import torch
import torch.nn.functional as F

from chess_vision_tpu_torch.convert.jax_params import HEADS, variables_from_state_dict
from chess_vision_tpu_torch.models import ARCHS
from chess_vision_tpu_torch.models.mobilenet import _CONV_SMALL_ARCH

_AFFINE = ("weight", "bias")
_BN = ("weight", "bias", "running_mean", "running_var")


def load_torch_file(path: str) -> dict:
    """A ``.pth`` read with ``weights_only=True`` on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_timm_file(path: str) -> dict:
    """A timm backbone ``.pth``: its ``state_dict``, unwrapped from a
    ``{"model": ...}`` dict."""
    sd = load_torch_file(path)
    return sd["model"] if isinstance(sd.get("model"), dict) else sd


def resample_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """(1, 1 + g^2, D) -> (1, 1 + new_grid^2, D): the patch positions
    resampled bicubically in f32 (no antialiasing, corners not aligned, as
    timm), the class token kept."""
    cls, patches = pos[:, :1], pos[:, 1:]
    g = int(round(patches.shape[1] ** 0.5))
    if g == new_grid:
        return pos
    x = patches.float().contiguous().reshape(1, g, g, -1).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(new_grid, new_grid), mode="bicubic",
                      antialias=False, align_corners=False)
    x = x.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, -1)
    return torch.cat([cls, x.to(pos.dtype)], dim=1)


def _count(sd: dict, pattern: str) -> int:
    """1 + the largest index the regex's group takes over sd's keys."""
    found = [int(m.group(1)) for k in sd if (m := re.match(pattern, k))]
    if not found:
        raise KeyError(f"no key matches {pattern!r}")
    return 1 + max(found)


def _take(out: dict, sd: dict, module: str, leaves=_AFFINE) -> None:
    for leaf in leaves:
        out[f"{module}.{leaf}"] = sd[f"{module}.{leaf}"]


def _vit(sd: dict, input_size: int) -> dict:
    out = {"cls_token": sd["cls_token"],
           "pos_embed": resample_pos_embed(sd["pos_embed"], input_size // 16)}
    _take(out, sd, "patch_embed.proj")
    _take(out, sd, "norm")
    for i in range(_count(sd, r"blocks\.(\d+)\.")):
        for module in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                       "mlp.fc2"):
            _take(out, sd, f"blocks.{i}.{module}")
    return out


def _convnext(sd: dict) -> dict:
    out: dict = {}
    _take(out, sd, "stem.0")
    _take(out, sd, "stem.1")
    for s in range(1, 4):
        _take(out, sd, f"stages.{s}.downsample.0")
        _take(out, sd, f"stages.{s}.downsample.1")
    for s in range(4):
        for j in range(_count(sd, rf"stages\.{s}\.blocks\.(\d+)\.")):
            b = f"stages.{s}.blocks.{j}"
            for module in ("conv_dw", "norm", "mlp.fc1", "mlp.fc2"):
                _take(out, sd, f"{b}.{module}")
            for leaf in _AFFINE:  # (1, 1, 1, C) in older timm
                out[f"{b}.mlp.grn.{leaf}"] = sd[f"{b}.mlp.grn.{leaf}"].reshape(-1)
    _take(out, sd, "head.norm")
    return out


def _mobilenet(sd: dict) -> dict:
    out = {"conv_stem.weight": sd["conv_stem.weight"]}
    _take(out, sd, "bn1", _BN)
    for si, stage in enumerate(_CONV_SMALL_ARCH):
        for bi, blk in enumerate(stage):
            t = f"blocks.{si}.{bi}"
            if blk[0] == "cn":
                out[f"{t}.conv.weight"] = sd[f"{t}.conv.weight"]
                _take(out, sd, f"{t}.bn1", _BN)
                continue
            _, dw_start, dw_mid = blk[:3]
            subs = (["dw_start"] * bool(dw_start) + ["pw_exp"]
                    + ["dw_mid"] * bool(dw_mid) + ["pw_proj"])
            for sub in subs:
                out[f"{t}.{sub}.conv.weight"] = sd[f"{t}.{sub}.conv.weight"]
                _take(out, sd, f"{t}.{sub}.bn", _BN)
    _take(out, sd, "conv_head")
    return out


def backbone_state_dict(sd: dict, arch: str, input_size: int = 256) -> dict:
    """A timm backbone ``state_dict`` (ViT-B/16 for ``arch`` vit,
    ConvNeXtV2-Tiny for cnn, MobileNetV4-Conv-Small at 0.5 width for square)
    -> the model's ``backbone.*`` entries; ``input_size`` sets the ViT's
    position grid. The tensors the model has are taken (a missing one raises
    ``ValueError`` naming it), the others left: timm's classifier,
    MobileNet's ``num_batches_tracked``."""
    convert = {"vit": lambda: _vit(sd, input_size), "cnn": lambda: _convnext(sd),
               "square": lambda: _mobilenet(sd)}
    if arch not in convert:
        raise ValueError(f"unknown arch {arch!r} (expected one of {ARCHS})")
    try:
        out = convert[arch]()
    except KeyError as err:
        raise ValueError(f"the timm state_dict lacks {err.args[0]!r}, which "
                         f"the {arch} backbone has") from None
    return {"backbone." + k: v for k, v in out.items()}


def _head(sd: dict, prefix: str) -> tuple[torch.Tensor, torch.Tensor]:
    """A reference head's Linear: ``Sequential(Dropout, Linear)`` keeps it
    at index 1, a bare Linear has no index; ChessCNN's 1x1 convolution
    becomes the Linear over the channels."""
    if prefix + ".weight" in sd:
        w, b = sd[prefix + ".weight"], sd[prefix + ".bias"]
    else:
        w, b = sd[prefix + ".1.weight"], sd[prefix + ".1.bias"]
    if w.dim() == 4:
        w = w[:, :, 0, 0].contiguous()
    return w, b


def reference_state_dict(sd: dict, cfg: dict) -> dict:
    """A reference training checkpoint's ``model`` -> the ``state_dict`` of
    ``build_model(cfg)``: the backbone by ``backbone_state_dict`` at
    ``model.input_size`` (224 when unset), the heads at index 1 of their
    ``Sequential``, the square model's ``global_head.1``."""
    arch = cfg["model"].get("arch", "vit")
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    out = backbone_state_dict(backbone, arch,
                              cfg["model"].get("input_size") or 224)
    heads = [(name, name) for name in HEADS]
    if arch == "square":
        heads.append(("global_head.1", "global_head"))
    for prefix, name in heads:
        out[f"{name}.1.weight"], out[f"{name}.1.bias"] = _head(sd, prefix)
    return out


def check_state_dict(sd: dict, want: dict, what: str = "converted weights") -> None:
    """Raise ``ValueError`` unless ``sd`` has ``want``'s keys (a model's
    ``state_dict``) and their shapes: the message names the first missing,
    extra and mismatched keys."""
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    mismatched = sorted(k for k in set(want) & set(sd)
                        if tuple(want[k].shape) != tuple(sd[k].shape))
    msg = []
    if missing:
        msg.append(f"missing {len(missing)}: {missing[:8]}")
    if extra:
        msg.append(f"extra {len(extra)}: {extra[:8]}")
    if mismatched:
        msg.append("shape mismatch: " + str([
            (k, tuple(want[k].shape), tuple(sd[k].shape)) for k in mismatched[:8]]))
    if msg:
        raise ValueError(f"{what} do not match the model: " + "; ".join(msg))


def main(argv=None) -> None:
    from chess_vision_tpu_torch.models import build_model
    from chess_vision_tpu_torch.utils.checkpoint import write_checkpoint

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--torch-ckpt", help="raw timm backbone state_dict (.pth)")
    parser.add_argument("--reference-ckpt",
                        help="reference training checkpoint (.pth with model+config)")
    parser.add_argument("--arch", choices=ARCHS, default="vit")
    parser.add_argument("--input-size", type=int, default=256)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.reference_ckpt:
        ckpt = load_torch_file(args.reference_ckpt)
        cfg = ckpt["config"]
        sd = reference_state_dict(ckpt["model"], cfg)
        check_state_dict(sd, build_model(cfg).state_dict())
        variables = variables_from_state_dict(sd)
        write_checkpoint(args.out, variables["params"], variables["batch_stats"],
                         step=0, epoch=ckpt.get("epoch", 0),
                         best_val_acc=ckpt.get("best_val_acc", 0.0), config=cfg)
        print(f"converted reference checkpoint -> {args.out}")
        return

    variables = variables_from_state_dict(backbone_state_dict(
        load_timm_file(args.torch_ckpt), args.arch, args.input_size))
    write_checkpoint(args.out, variables["params"]["backbone"],
                     variables["batch_stats"].get("backbone", {}), step=0,
                     epoch=0, best_val_acc=0.0, config={"arch": args.arch})
    print(f"converted backbone -> {args.out}")


if __name__ == "__main__":
    main()
