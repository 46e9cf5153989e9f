"""Device selection: the port runs on a CUDA GPU unless told otherwise.

Counterpart of ``chess_vision_tpu/utils/platform.py`` in role only. There is
no silent CPU path: callers that want the CPU (the tests) pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The CUDA device, or raise when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch ops on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA device (raising without one)."""
    return cuda_device() if device is None else torch.device(device)


def default_generator(device: torch.device) -> torch.Generator:
    """The generator that dropout and ``bernoulli_`` draw from on ``device``
    (the one whose state ``torch.utils.checkpoint`` preserves)."""
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        return torch.cuda.default_generators[index]
    return torch.default_generator
