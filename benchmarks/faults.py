"""Faults planted in the program under test, for the checks that show
``correct`` comes out false when the timed path is broken. Each is a
context manager that patches the program while it is open.

- ``altered_answer``: the first board of every batch is answered with
  other classes (each square's shifted by 6) where the FENs are
  assembled.
- ``unchanged_state``: the optimizer step leaves the parameters and its
  moments as they were.
- ``half_batch``: each train step sees the first half of its batch only, so
  the loss is the mean over that half.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def altered_answer():
    from chess_vision_tpu_torch import serve

    real = serve.assemble_fens_batch

    def assemble(square_ids, turn, castling):
        square_ids = square_ids.copy()
        square_ids[0] = (square_ids[0] + 6) % 13
        return real(square_ids, turn, castling)

    with mock.patch.object(serve, "assemble_fens_batch", assemble):
        yield


@contextlib.contextmanager
def unchanged_state():
    from chess_vision_tpu_torch.train.state import TrainState

    def no_step(self):
        for p in self.params:
            p.grad = None
        self.step += 1

    with mock.patch.object(TrainState, "apply_gradients", no_step):
        yield


@contextlib.contextmanager
def half_batch():
    from chess_vision_tpu_torch.train import loop

    real = loop.make_steps

    def make_steps(*args, **kwargs):
        train_step, eval_step = real(*args, **kwargs)

        def half(batch, aug_params=None):
            n = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
            if aug_params is not None:
                aug_params = {k: v[:n] for k, v in aug_params.items()}
            return train_step(batch, aug_params)

        return half, eval_step

    with mock.patch.object(loop, "make_steps", make_steps):
        yield


PLANTED = {"altered_answer": altered_answer, "unchanged_state": unchanged_state,
           "half_batch": half_batch}
