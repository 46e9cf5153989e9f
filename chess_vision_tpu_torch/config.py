"""Per-backbone data configs (mean/std/native input size).

The same table as ``chess_vision_tpu/config.py`` ``get_data_config``, kept
here because that module imports ``yaml`` at import time, which the port's
deployment does not have. A test holds the two tables equal.
"""

from __future__ import annotations

import copy

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
