"""The flat layout's quantizing attention (K5,
``fused_qkv_attention_quant_flat``: 2 images padded to 48 rows, 33 real) in
each of the JAX package's serving modes against the JAX kernel in interpret
mode, as tests/test_torch_int8_modes.py holds the block layout's (K4) and
states the tolerance: within one int8 level of the row, on the real rows."""

import pytest

from test_torch_int8_modes import (LEGS, check_int8_legs, check_overshoot_row,
                                   check_shift_mode)


@pytest.mark.parametrize("exp", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["bound", "fixed", "max"])
def test_flat_shift_modes_match_jax(mode, exp, monkeypatch):
    check_shift_mode("flat", mode, exp, monkeypatch)


@pytest.mark.parametrize("legs", **LEGS)
def test_flat_int8_legs_match_jax(legs, monkeypatch):
    check_int8_legs("flat", legs, monkeypatch)


def test_flat_planted_overshoot_row_reads_zeros(monkeypatch):
    check_overshoot_row("flat", monkeypatch)
