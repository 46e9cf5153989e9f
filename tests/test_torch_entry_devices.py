"""The port's entry points run on the card unless the caller asks for the
CPU: with no device given and no card they raise, as ``Predictor()`` and the
trainer do (``utils/device.resolve_device``), and never fall back to the CPU
silently. Here the parallel dry run's one-device reference
(``parallel/dryrun.train_steps``) and its spawner of ranks
(``compare_ranks``), which once defaulted to the CPU."""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention  # noqa: F401 (first exp)
from chess_vision_tpu_torch.parallel import dryrun

torch.set_num_threads(2)


def test_rank_runs_take_the_card_unless_told_otherwise(monkeypatch):
    cfg = dryrun.tiny_config()
    batches = dryrun.random_batches(1, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.train_steps(cfg, batches)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # before a spawn
        dryrun.compare_ranks(2, {"dp": dict(cfg=cfg, batches=batches)})
    assert np.isfinite(dryrun.train_steps(cfg, batches, "cpu")["losses"]).all()
