"""The weight bridge: JAX ChessViT params -> this package's state_dict.

The inverse of ``chess_vision_tpu/convert/timm_convert.py``
``convert_reference_model``, which maps timm-named torch weights (the names
this package's modules use) to the JAX parameter tree; the tests run that
existing converter on this function's output as an independent round trip.
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


def _linear(sd: dict, key: str, p: dict) -> None:
    sd[key + ".weight"] = _tensor(np.asarray(p["kernel"]).T)
    sd[key + ".bias"] = _tensor(p["bias"])


def _norm(sd: dict, key: str, p: dict) -> None:
    sd[key + ".weight"] = _tensor(p["scale"])
    sd[key + ".bias"] = _tensor(p["bias"])


def state_dict_from_jax(params: dict, cfg: dict) -> dict[str, torch.Tensor]:
    """JAX ChessViT params (nested dicts of arrays) -> ``ChessViT`` state_dict."""
    arch = cfg["model"].get("arch", "vit")
    if arch != "vit":
        raise NotImplementedError(
            f"arch={arch!r} is not ported to PyTorch yet (ROADMAP Queue A "
            "item 10)")
    bb = params["backbone"]
    sd: dict[str, torch.Tensor] = {}
    sd["backbone.patch_embed.proj.weight"] = _tensor(
        np.transpose(np.asarray(bb["patch_embed"]["kernel"]), (3, 2, 0, 1)))
    sd["backbone.patch_embed.proj.bias"] = _tensor(bb["patch_embed"]["bias"])
    sd["backbone.cls_token"] = _tensor(bb["cls_token"])
    sd["backbone.pos_embed"] = _tensor(bb["pos_embed"])
    depth = sum(1 for k in bb if k.startswith("block"))
    for i in range(depth):
        blk, pre = bb[f"block{i}"], f"backbone.blocks.{i}."
        _norm(sd, pre + "norm1", blk["norm1"])
        _linear(sd, pre + "attn.qkv", blk["attn"]["qkv"])
        _linear(sd, pre + "attn.proj", blk["attn"]["proj"])
        _norm(sd, pre + "norm2", blk["norm2"])
        _linear(sd, pre + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, pre + "mlp.fc2", blk["mlp"]["fc2"])
    _norm(sd, "backbone.norm", bb["norm"])
    for head in HEADS:
        _linear(sd, head + ".1", params[head])
    return sd


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
