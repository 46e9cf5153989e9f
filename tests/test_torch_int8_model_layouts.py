"""The port's whole int8 model without calibration with the bf16 exp
(CHESS_VISION_ATTN_EXP=bf16) and K8's bf16 epilogue
(CHESS_VISION_EPILOGUE=bf16), in the block layout, and in the hybrid and xla
layouts, against the JAX package's serving path composed by hand, as
tests/test_torch_int8_layouts.py ``check_model`` states: logits within
LOGITS_ATOL, the argmax FEN the same on every square of the tests' boards."""

import pytest

from test_torch_int8_layouts import check_model, params  # noqa: F401


@pytest.mark.parametrize("layout,env", [
    ("block", {"CHESS_VISION_ATTN_EXP": "bf16"}),
    ("block", {"CHESS_VISION_EPILOGUE": "bf16"}), ("hybrid", {}), ("xla", {})],
    ids=["exp-bf16", "epilogue-bf16", "hybrid", "xla"])
def test_int8_model_layouts_match_jax(layout, env, params,  # noqa: F811
                                      monkeypatch):
    check_model(layout, env, params, monkeypatch)
