"""The plain LayerNorm's inverse standard deviation, rounded as the kernels'
(chess_vision_tpu_torch/ops/rowquant.py ``layernorm_f32``), and the per-row
bounds ``chip_smoke.py`` holds the card's logits and quantizing attention to
(its ``logits_reading``, ``path_op_failures``), on the CPU."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import chess_vision_tpu_torch.ops  # noqa: F401  (the first exp on one thread)
from chess_vision_tpu_torch.ops import rowquant

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def test_layernorm_rounds_its_inverse_std_as_the_kernel():
    """IEEE f32 sqrt, then IEEE f32 division (``__fdiv_rn(1,
    __fsqrt_rn(var + eps))``), then (x - mu) * inv * g + b: numpy's f32
    operations are each correctly rounded."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4096, 96)) * rng.uniform(1e-3, 30, (4096, 1))
         ).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    b = rng.normal(size=96).astype(np.float32)
    got = rowquant.layernorm_f32(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.from_numpy(b)).numpy()
    xt = torch.from_numpy(x)
    mu = xt.mean(dim=-1, keepdim=True)
    cen = (xt - mu).numpy()
    var = torch.from_numpy(cen).square().mean(dim=-1, keepdim=True).numpy()
    inv = np.float32(1) / np.sqrt(var + np.float32(1e-6))
    np.testing.assert_array_equal(got, cen * inv * g + b)


def _logits(rows, scale, seed):
    rng = np.random.default_rng(seed)
    return {"squares": (rng.normal(size=(rows, 832)) * scale).astype(np.float32),
            "turn": rng.normal(size=(rows, 1)).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.8, 10.0])
def test_logits_bound_follows_each_rows_scale(scale):
    """A difference of k units of a row's scale passes k units whatever the
    logits' scale; at the random model's scale (~0.8) the per-row bound is
    under the absolute 5e-2 it replaced, at a trained one's (~10) above it."""
    ref = _logits(6, scale, 1)
    unit = chip_smoke.row_unit(ref["squares"])
    np.testing.assert_allclose(
        unit, np.sqrt((ref["squares"].astype(np.float64) ** 2).mean(1)) / 256)
    near = {**ref, "squares": ref["squares"] + (11.5 * unit)[:, None].astype(np.float32)}
    far = {**ref, "squares": ref["squares"].copy()}
    far["squares"][3, 7] += 13 * unit[3]
    ok = chip_smoke.logits_reading(near, ref, 12)
    bad = chip_smoke.logits_reading(far, ref, 12)
    assert ok["ok"] and 11 < ok["ulps"] <= 12 and not bad["ok"]
    assert (ok["bound"].max() <= 5e-2) == (scale < 1)


def test_attention_levels_bound_and_planted_scale():
    """K4 on the path: one flipped code plus a small scale difference passes
    ATTN_LEVELS; scales 2% off fail it."""
    s = torch.full((4, 1), 0.01)
    q = torch.randint(-127, 128, (4, 64), generator=torch.Generator().manual_seed(0),
                      dtype=torch.int32).to(torch.int8)
    flipped = q.clone()
    flipped[1, 5] = flipped[1, 5] - 1 if flipped[1, 5] > -127 else 1

    def worst(q2, s2):
        deq = (q.float() * s - q2.float() * s2).abs()
        step = torch.maximum(s, s2)
        return {"fused_qkv_attention_quant": {
            "calls": 1, "levels": int((q.int() - q2.int()).abs().max()),
            "flips": 1e-4, "scale_rel": 0.0, "deq": deq.max().item(),
            "deq_levels": (deq / step).max().item(),
            "deq_bound": (chip_smoke.ATTN_LEVELS * step).max().item(),
            "nonfinite": 0.0}}

    assert not chip_smoke.path_op_failures(worst(flipped, s * (1 + 1e-3)))
    assert chip_smoke.path_op_failures(worst(q, s * 1.02))
