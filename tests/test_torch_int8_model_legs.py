"""The port's whole int8 model without calibration under
CHESS_VISION_ATTN_SOFTMAX=max and the int8 attention legs
(CHESS_VISION_ATTN_QK=int8 and int8pv), in the block layout,
against the JAX package's serving path composed by hand, as
tests/test_torch_int8_layouts.py ``check_model`` states: logits within
LOGITS_ATOL, the argmax FEN the same on every square of the tests' boards."""

import pytest

from test_torch_int8_layouts import check_model, params  # noqa: F401


@pytest.mark.parametrize("env", [{"CHESS_VISION_ATTN_SOFTMAX": "max"},
                                 {"CHESS_VISION_ATTN_QK": "int8"},
                                 {"CHESS_VISION_ATTN_QK": "int8pv"}],
                         ids=["max", "int8", "int8pv"])
def test_int8_model_legs_match_jax(env, params, monkeypatch):  # noqa: F811
    check_model("block", env, params, monkeypatch)
