"""The weight bridge, both ways: JAX ChessViT params <-> this package's
state_dict.

``state_dict_from_jax`` is the inverse of
``chess_vision_tpu/convert/timm_convert.py`` ``convert_reference_model``,
which maps timm-named torch weights (the names this package's modules use) to
the JAX parameter tree; the tests run that existing converter on this
function's output as an independent round trip. ``tree_from_state_dict`` goes
back, for checkpoints that the JAX package loads; both also carry the AdamW
moments, which share the parameters' names and layouts.
Layouts: flax conv HWIO -> torch OIHW, flax Dense kernel (in, out) -> torch
Linear weight (out, in), LayerNorm scale -> weight; heads are
``Sequential(Dropout, Linear)``, so their keys carry index 1.

``int8_pack_from_jax`` does the same for the int8 serving pack
(``quantize_chessvit``, in the JAX package or ``ops/quant.py``).
"""

from __future__ import annotations

import numpy as np
import torch

HEADS = ("type_head", "color_head", "turn_head", "castling_head")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable, contiguous copy


def _torch_key(path: tuple[str, ...]) -> str:
    """JAX tree path -> state_dict key, e.g. ("backbone", "block3", "attn",
    "qkv", "kernel") -> "backbone.blocks.3.attn.qkv.weight"."""
    *modules, leaf = path
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    if modules and modules[0] in HEADS:
        return f"{modules[0]}.1.{leaf}"
    if modules[0] != "backbone":
        raise KeyError(f"no PyTorch counterpart for JAX parameter {path}")
    rest = modules[1:]
    if rest and rest[0] == "patch_embed":
        rest = ["patch_embed", "proj"]
    elif rest and rest[0].startswith("block"):
        rest = ["blocks", rest[0][len("block"):], *rest[1:]]
    return ".".join(["backbone", *rest, leaf])


def _jax_path(key: str) -> tuple[str, ...]:
    """state_dict key -> JAX tree path; the inverse of ``_torch_key``."""
    *modules, leaf = key.split(".")
    if leaf == "weight":
        leaf = "scale" if modules[-1].startswith("norm") else "kernel"
    if modules and modules[0] in HEADS:
        return (modules[0], leaf)
    if not modules or modules[0] != "backbone":
        raise KeyError(f"no JAX counterpart for PyTorch parameter {key}")
    rest = modules[1:]
    if rest and rest[0] == "patch_embed":
        rest = ["patch_embed"]
    elif rest and rest[0] == "blocks":
        rest = [f"block{rest[1]}", *rest[2:]]
    return ("backbone", *rest, leaf)


def _leaves(tree: dict, path=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def state_dict_from_tree(tree: dict) -> dict[str, torch.Tensor]:
    """Any tree in the JAX parameter layout (the parameters, or AdamW moments
    of all or some of them; empty sub-dicts are skipped) -> tensors keyed by
    ``state_dict`` names, in PyTorch's layouts."""
    sd = {}
    for path, value in _leaves(tree):
        a = np.asarray(value)
        if path[-1] == "kernel":  # HWIO -> OIHW, (in, out) -> (out, in)
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        sd[_torch_key(path)] = _tensor(a)
    return sd


def tree_from_state_dict(sd: dict) -> dict:
    """The inverse bridge: tensors keyed by ``state_dict`` names (all or some
    parameters, or their moments) -> nested dicts of numpy arrays in the JAX
    package's layout."""
    tree: dict = {}
    for key, value in sd.items():
        a = value.detach().cpu().numpy()
        path = _jax_path(key)
        if path[-1] == "kernel":  # OIHW -> HWIO, (out, in) -> (in, out)
            a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def state_dict_from_jax(params: dict, cfg: dict) -> dict[str, torch.Tensor]:
    """JAX ChessViT params (nested dicts of arrays) -> ``ChessViT`` state_dict."""
    arch = cfg["model"].get("arch", "vit")
    if arch != "vit":
        raise NotImplementedError(
            f"arch={arch!r} is not ported to PyTorch yet (ROADMAP Queue A "
            "item 10)")
    return state_dict_from_tree(params)


def int8_pack_from_jax(pack: dict, device=None) -> dict:
    """The JAX package's int8 pack (numpy arrays, ``quantize_chessvit``) ->
    the port's tensors on ``device``, for ``ops/quant.chessvit_int8_apply``.

    Each int8 ``wq`` is stored transposed, (O, K) with K contiguous: the
    B-operand layout of the int8 GEMM (``mma.sync ... row.col``). The patch
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
