"""YAML config loading, dot-notation CLI overrides and per-backbone data
configs (the port's own copy of ``chess_vision_tpu/config.py``).

`--set a.b=c` overrides are coerced to the type of the existing value
(bool/int/float); when the existing value is None the override is tried as
int, then float, then kept as a string. ``yaml`` is imported where a file is
read, so the module imports without it. A test holds the data-config table
equal to the JAX package's.
"""

from __future__ import annotations

import copy


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def apply_overrides(cfg: dict, overrides: list[str]) -> None:
    """Apply dot-notation overrides like 'training.epochs=10' in place."""
    for item in overrides:
        key, value = item.split("=", 1)
        keys = key.split(".")
        d = cfg
        for k in keys[:-1]:
            d = d[k]
        orig = d.get(keys[-1]) if isinstance(d, dict) else d[keys[-1]]
        if orig is None:
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except ValueError:
                    pass
        elif isinstance(orig, bool):
            value = value.lower() in ("true", "1", "yes")
        elif isinstance(orig, int):
            value = int(value)
        elif isinstance(orig, float):
            value = float(value)
        d[keys[-1]] = value


def merged_config(path: str, overrides: list[str] | None = None) -> dict:
    cfg = load_config(path)
    apply_overrides(cfg, overrides or [])
    return cfg


# ---------------------------------------------------------------------------
# Model data configs: mean/std/input_size of timm's pretrained_cfg, recorded
# statically (timm is not a dependency).
# ---------------------------------------------------------------------------

_DATA_CFGS = {
    # timm vit_base_patch16_224.augreg_in21k pretrained_cfg: inception-style 0.5s
    "vit_base_patch16_224.augreg_in21k": {
        "mean": (0.5, 0.5, 0.5),
        "std": (0.5, 0.5, 0.5),
        "input_size": 224,
    },
    # timm convnextv2_tiny.fcmae_ft_in22k_in1k: ImageNet mean/std
    "convnextv2_tiny.fcmae_ft_in22k_in1k": {
        "mean": (0.485, 0.456, 0.406),
        "std": (0.229, 0.224, 0.225),
        "input_size": 224,
    },
    # timm mobilenetv4_conv_small_050.e3000_r224_in1k: ImageNet mean/std
    "mobilenetv4_conv_small_050.e3000_r224_in1k": {
        "mean": (0.485, 0.456, 0.406),
        "std": (0.229, 0.224, 0.225),
        "input_size": 224,
    },
}

_DEFAULT_DATA_CFG = {
    "mean": (0.485, 0.456, 0.406),
    "std": (0.229, 0.224, 0.225),
    "input_size": 224,
}


def get_data_config(model_name: str) -> dict:
    """mean/std/native input size for a backbone name (timm pretrained_cfg parity)."""
    cfg = _DATA_CFGS.get(model_name)
    if cfg is None:
        if model_name.startswith("vit_"):
            cfg = {"mean": (0.5,) * 3, "std": (0.5,) * 3, "input_size": 224}
        else:
            cfg = _DEFAULT_DATA_CFG
    return copy.deepcopy(cfg)
