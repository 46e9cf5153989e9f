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
