"""The weight bridge, both ways: the JAX package's variables (``params``
and ``batch_stats``) of ChessViT, ChessCNN and ChessSquareCNN <-> this
package's state_dict.

``state_dict_from_jax`` is the inverse of
``chess_vision_tpu/convert/timm_convert.py`` ``convert_reference_model``,
which maps timm-named torch weights (the names this package's modules use) to
the JAX trees; the tests run that existing converter on this function's
output as an independent round trip. ``tree_from_state_dict`` and
``variables_from_state_dict`` go back, for checkpoints that the JAX package
loads; the bridge also carries the AdamW moments, which share the
parameters' names and layouts.

Names: each JAX module path maps to its timm name by ``_MODULES``
(``stage2_block5/pwconv1`` <-> ``stages.2.blocks.5.mlp.fc1``); heads are
``Sequential(Dropout, Linear)``, so their keys carry index 1. Leaves: kernel
and the norms' scale <-> weight, GRN's gamma/beta <-> weight/bias,
BatchNorm's ``batch_stats`` mean/var <-> the buffers running_mean/
running_var (the port keeps no ``num_batches_tracked``). Layouts: flax conv
HWIO -> torch OIHW (a depthwise (kh, kw, 1, C) -> (C, 1, kh, kw)), Dense
kernel (in, out) -> Linear weight (out, in); MobileNet's ``conv_head`` is a
Dense in flax and a 1x1 Conv2d in timm, (in, out) <-> (out, in, 1, 1).
"""

from __future__ import annotations

import re

import numpy as np
import torch

HEADS = ("type_head", "color_head", "turn_head", "castling_head")

# (JAX module path under "backbone", timm module name): {x} matches digits,
# {tail} (a ViT block's) the rest of the path from a letter on, so that
# MobileNet's "blocks.{s}.{j}." is not a ViT block's; {p} conv or bn.
_MODULES = (
    # ViT
    ("patch_embed", "patch_embed.proj"),
    ("block{i}/{tail}", "blocks.{i}.{tail}"),
    # ConvNeXtV2
    ("stem_conv", "stem.0"),
    ("stem_norm", "stem.1"),
    ("downsample{s}_norm", "stages.{s}.downsample.0"),
    ("downsample{s}_conv", "stages.{s}.downsample.1"),
    ("stage{s}_block{j}/dwconv", "stages.{s}.blocks.{j}.conv_dw"),
    ("stage{s}_block{j}/norm", "stages.{s}.blocks.{j}.norm"),
    ("stage{s}_block{j}/pwconv1", "stages.{s}.blocks.{j}.mlp.fc1"),
    ("stage{s}_block{j}/grn", "stages.{s}.blocks.{j}.mlp.grn"),
    ("stage{s}_block{j}/pwconv2", "stages.{s}.blocks.{j}.mlp.fc2"),
    ("head_norm", "head.norm"),
    # MobileNetV4
    ("stem/conv", "conv_stem"),
    ("stem/bn", "bn1"),
    ("stage{s}_block{j}/conv", "blocks.{s}.{j}.conv"),
    ("stage{s}_block{j}/bn", "blocks.{s}.{j}.bn1"),
    ("stage{s}_block{j}/dw_start/{p}", "blocks.{s}.{j}.dw_start.{p}"),
    ("stage{s}_block{j}/pw_exp/{p}", "blocks.{s}.{j}.pw_exp.{p}"),
    ("stage{s}_block{j}/dw_mid/{p}", "blocks.{s}.{j}.dw_mid.{p}"),
    ("stage{s}_block{j}/pw_proj/{p}", "blocks.{s}.{j}.pw_proj.{p}"),
    ("conv_head", "conv_head"),
)


def _pattern(template: str) -> re.Pattern:
    out = re.escape(template)
    for name in re.findall(r"\{(\w+)\}", template):
        group = {"tail": r"[a-z].*", "p": r"conv|bn"}.get(name, r"\d+")
        out = out.replace(re.escape("{%s}" % name), f"(?P<{name}>{group})")
    return re.compile(out + "$")


_TO_TORCH = [(_pattern(j), t) for j, t in _MODULES]
_TO_JAX = [(_pattern(t), j) for j, t in _MODULES]
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "gamma": "weight",
                  "beta": "bias", "mean": "running_mean", "var": "running_var"}


def _rename(name: str, table, sep_in: str, sep_out: str) -> str | None:
    for pattern, template in table:
        m = pattern.match(name)
        if m:
            groups = {k: v.replace(sep_in, sep_out) for k, v in m.groupdict().items()}
            return template.format(**groups)
    return None


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable, contiguous copy


def _torch_key(path: tuple[str, ...]) -> str:
    """JAX tree path -> state_dict key, e.g. ("backbone", "block3", "attn",
    "qkv", "kernel") -> "backbone.blocks.3.attn.qkv.weight"."""
    *modules, leaf = path
    leaf = _LEAF_TO_TORCH.get(leaf, leaf)
    if modules and modules[0] in HEADS:
        return f"{modules[0]}.1.{leaf}"
    if modules == ["global_fc"]:
        return f"global_head.1.{leaf}"
    if not modules or modules[0] != "backbone":
        raise KeyError(f"no PyTorch counterpart for JAX parameter {path}")
    rest = "/".join(modules[1:])
    name = _rename(rest, _TO_TORCH, "/", ".") if rest else None
    if rest and name is None:  # ViT's top-level norm
        name = rest.replace("/", ".")
    return ".".join(["backbone", name, leaf] if name else ["backbone", leaf])


def _is_norm(module: str) -> bool:
    return module.startswith("norm") or module.endswith("_norm") or module == "bn"


def _jax_path(key: str) -> tuple[str, ...]:
    """state_dict key -> JAX tree path; the inverse of ``_torch_key``."""
    *modules, leaf = key.split(".")
    if modules and modules[0] in HEADS:
        path = [modules[0]]
    elif modules[:2] == ["global_head", "1"]:
        path = ["global_fc"]
    elif modules and modules[0] == "backbone":
        rest = ".".join(modules[1:])
        name = _rename(rest, _TO_JAX, ".", "/") if rest else None
        path = ["backbone", *((name or rest).split("/") if rest else [])]
    else:
        raise KeyError(f"no JAX counterpart for PyTorch parameter {key}")
    if leaf == "weight":
        leaf = ("gamma" if path[-1] == "grn" else
                "scale" if _is_norm(path[-1]) else "kernel")
    elif leaf == "bias" and path[-1] == "grn":
        leaf = "beta"
    elif leaf.startswith("running_"):
        leaf = leaf[len("running_"):]
    return (*path, leaf)


def _leaves(tree: dict, path=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def state_dict_from_tree(tree: dict) -> dict[str, torch.Tensor]:
    """Any tree in the JAX layout (the parameters, the ``batch_stats``, or
    AdamW moments of all or some of the parameters; empty sub-dicts are
    skipped) -> tensors keyed by ``state_dict`` names, in PyTorch's
    layouts."""
    sd = {}
    for path, value in _leaves(tree):
        a = np.asarray(value)
        key = _torch_key(path)
        if path[-1] == "kernel":  # HWIO -> OIHW, (in, out) -> (out, in)
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
            if key.endswith("conv_head.weight"):
                a = a[:, :, None, None]
        sd[key] = _tensor(a)
    return sd


def tree_from_state_dict(sd: dict) -> dict:
    """The inverse bridge: tensors keyed by ``state_dict`` names (all or some
    parameters and buffers, or moments) -> nested dicts of numpy arrays in the
    JAX layout. Running statistics land as mean/var leaves beside the
    parameters; ``variables_from_state_dict`` splits them off."""
    tree: dict = {}
    for key, value in sd.items():
        a = value.detach().cpu().numpy()
        path = _jax_path(key)
        if path[-1] == "kernel":  # OIHW -> HWIO, (out, in) -> (in, out)
            if key.endswith("conv_head.weight"):
                a = a[:, :, 0, 0]
            a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.array(a, order="C")  # a copy: never the tensor's memory
    return tree


def variables_from_state_dict(sd: dict) -> dict:
    """A whole model's state_dict -> {"params": ..., "batch_stats": ...} in
    the JAX layout (``batch_stats`` empty for a model without BatchNorm)."""
    params = {k: v for k, v in sd.items()
              if not k.rsplit(".", 1)[-1].startswith("running_")}
    stats = {k: v for k, v in sd.items() if k not in params}
    return {"params": tree_from_state_dict(params),
            "batch_stats": tree_from_state_dict(stats)}


def state_dict_from_jax(params: dict, cfg: dict,
                        batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """JAX params (and ``batch_stats`` for the square model's BatchNorm)
    -> the state_dict of ``cfg``'s model."""
    arch = cfg["model"].get("arch", "vit")
    if arch not in ("vit", "cnn", "square"):
        raise ValueError(f"unknown arch {arch!r}")
    sd = state_dict_from_tree(params)
    sd.update(state_dict_from_tree(batch_stats or {}))
    return sd


def int8_pack_from_jax(pack: dict, device=None) -> dict:
    """The JAX package's int8 pack (numpy arrays, ``quantize_chessvit``) ->
    the port's tensors on ``device``, for ``ops/quant.chessvit_int8_apply``.

    Each int8 ``wq`` is stored transposed, (O, K) with K contiguous: the
    B-operand layout of the int8 GEMM (K-major, as int8 ``wgmma`` and
    ``mma.sync ... row.col`` both take it). The patch
    embed kernel (P, P, C, D) becomes a (D, P*P*C) weight over patches
    flattened in (row, column, channel) order, with ``patch_size`` P. Other
    arrays keep their values and dtypes. Calibrated ``attn_shifts`` are not
    weights: pop them off the pack first and pass them to the forward."""
    t = lambda a: _tensor(a).to(device)  # noqa: E731
    pair = lambda p, a, b: {a: t(p[a]), b: t(p[b])}  # noqa: E731
    kernel = np.asarray(pack["patch_embed"]["kernel"])
    out = {
        "patch_embed": {
            "weight": t(kernel.reshape(-1, kernel.shape[-1]).T),
            "bias": t(pack["patch_embed"]["bias"]),
            "patch_size": kernel.shape[0],
        },
        "cls_token": t(pack["cls_token"]),
        "pos_embed": t(pack["pos_embed"]),
        "norm": pair(pack["norm"], "scale", "bias"),
        "heads": {name: pair(p, "kernel", "bias")
                  for name, p in pack["heads"].items()},
        "blocks": [],
    }
    for blk in pack["blocks"]:
        q = {"norm1": pair(blk["norm1"], "scale", "bias"),
             "norm2": pair(blk["norm2"], "scale", "bias")}
        for name in ("qkv", "proj", "fc1", "fc2"):
            q[name] = {"wq": t(np.asarray(blk[name]["wq"]).T),
                       "scale": t(blk[name]["scale"]),
                       "bias": t(blk[name]["bias"])}
        out["blocks"].append(q)
    return out
