"""The port's whole int8 model without calibration under the JAX default
"bound" shift in the block, flat and fused layouts, and under
CHESS_VISION_ATTN_SOFTMAX=fixed, against the JAX package's serving path
composed by hand, as tests/test_torch_int8_layouts.py ``check_model``
states: logits within LOGITS_ATOL, the argmax FEN the same on every square
of the tests' boards."""

import pytest

from test_torch_int8_layouts import check_model, params  # noqa: F401


@pytest.mark.parametrize("layout,env", [
    ("block", {}), ("flat", {}), ("fused", {}),
    ("block", {"CHESS_VISION_ATTN_SOFTMAX": "fixed"})],
    ids=["bound", "flat-bound", "fused-bound", "fixed"])
def test_int8_model_shift_modes_match_jax(layout, env, params,  # noqa: F811
                                          monkeypatch):
    check_model(layout, env, params, monkeypatch)
