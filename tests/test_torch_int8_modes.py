"""The port's quantizing attention in each of the JAX package's serving modes
(chess_vision_tpu_torch/ops/attention.py ``fused_qkv_attention_quant``, K4,
and ``fused_qkv_attention_quant_flat``, K5) against the JAX kernels, on the
same inputs made with numpy: the softmax shift (``shift_mode``, the JAX
package's CHESS_VISION_ATTN_SOFTMAX: "bound", its default, "fixed" and
"max"), the bf16 exp (CHESS_VISION_ATTN_EXP) and the int8 legs
(CHESS_VISION_ATTN_QK, the ``qk_int8`` / ``pv_int8`` keywords). The port
runs its plain PyTorch versions, which is what a CPU tensor takes; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_attention.py
does. The CUDA kernels are held against the plain versions on the card
(``chip_smoke.py`` phase 27). The flat layout's cases are
tests/test_torch_int8_modes_flat.py's; the shift rules and the CPU path
tests/test_torch_int8_layouts.py's.

Tolerance: within one int8 level of the row. Codes at most one level apart
in under 1e-3 of the elements, scales within rtol 1e-5. The bound's sums of
squares are added in another order than XLA's, so no bit-equality is asked
of it. At these shapes (2 images of 33 tokens, 4 heads of 64; the flat
layout padded to 48 rows) no code differs in any mode (read on the CPU); the
int8 P V leg without the QK leg moves 6e-5 of the codes by one level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import attention as jax_attn
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

B, N, NP, H, DH = 2, 33, 48, 4, 64
D = H * DH


def _qkv(seed, rows=N, q_gain=4.0):
    qkv = np.random.default_rng(seed).normal(size=(B, rows, 3 * D))
    qkv[:, :, :D] *= q_gain  # logits of O(10), as a trained checkpoint
    return qkv.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run(layout, qkv, monkeypatch, env, **kw):
    """(port codes, port scales, JAX codes, JAX scales) on the real rows."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if layout == "block":
        jq = jnp.asarray(qkv).astype(jnp.bfloat16)
        ref = jax_attn.fused_qkv_attention_quant(jq, H, interpret=True, **kw)
        ours = attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), H, **_port(kw, env))
        return (*(t.numpy() for t in ours), *(np.asarray(r) for r in ref))
    flat = qkv.reshape(B * NP, 3 * D)
    jq = jnp.asarray(flat).astype(jnp.bfloat16)
    ref = jax_attn.fused_qkv_attention_quant_flat(jq, B, N, H, interpret=True,
                                                  **kw)
    ours = attn.fused_qkv_attention_quant_flat(_t(flat).bfloat16(), B, N, H,
                                               **_port(kw, env))
    real = lambda a: np.asarray(a).reshape(B, NP, -1)[:, :N]  # noqa: E731
    return (*(real(t.numpy()) for t in ours), *(real(r) for r in ref))


def _port(kw, env):
    """The port's keywords for the JAX call's keywords and variables."""
    out = dict(kw)
    out["shift_mode"] = env.get("CHESS_VISION_ATTN_SOFTMAX", "bound")
    out["exp_bf16"] = env.get("CHESS_VISION_ATTN_EXP", "f32") == "bf16"
    return out


def _assert_within_a_level(q, s, rq, rs, share=1e-3):
    levels = np.abs(q.astype(np.int32) - np.asarray(rq, np.int32))
    assert levels.max() <= 1, levels.max()
    assert (levels > 0).mean() < share, (levels > 0).mean()
    np.testing.assert_allclose(s, rs, rtol=1e-5)
    return (levels > 0).mean()


def check_shift_mode(layout, mode, exp, monkeypatch):
    qkv = _qkv(seed=1, rows=N if layout == "block" else NP)
    env = {"CHESS_VISION_ATTN_SOFTMAX": mode, "CHESS_VISION_ATTN_EXP": exp}
    q, s, rq, rs = _run(layout, qkv, monkeypatch, env)
    assert _assert_within_a_level(q, s, rq, rs) == 0.0


def check_int8_legs(layout, legs, monkeypatch):
    """The JAX package's legacy path: no fold, the exact row max, q and k
    quantized per row (and p per row, V per column over all of the image's
    rows, the flat layout's padded ones too)."""
    qkv = _qkv(seed=2, rows=N if layout == "block" else NP)
    qk, pv = legs
    q, s, rq, rs = _run(layout, qkv, monkeypatch, {}, qk_int8=qk, pv_int8=pv)
    _assert_within_a_level(q, s, rq, rs)


def _overshooting(rows):
    """Keys of head 0 in the first 32 of its 64 columns; q rows 0-3 of image
    0 in the other 32, of a norm that puts |q| max_j |k_j| / 8 at 200: their
    scores are 0 and the bound overshoots their max by 155."""
    qkv = _qkv(seed=3, rows=rows, q_gain=1.0)
    qkv[0, :, D + 32:D + DH] = 0
    kmax = np.sqrt(np.square(qkv[0, :N, D:D + DH]).sum(-1)).max()
    qkv[0, :4, :DH] = 0
    qkv[0, :4, 32:DH] = 200.0 / (0.125 * kmax) / np.sqrt(32)
    return qkv


def check_overshoot_row(layout, monkeypatch):
    """Where the bound overshoots a row's true max by more than ~132 the
    whole row underflows, and the row-sum floor turns it into zeros, in both
    packages; the exact row max gives that row its softmax."""
    qkv = _overshooting(N if layout == "block" else NP)
    q, s, rq, rs = _run(layout, qkv, monkeypatch, {})
    assert (q[0, :4, :DH] == 0).all() and (rq[0, :4, :DH] == 0).all()
    assert (q[0, 4:, :DH] != 0).any() and np.isfinite(s).all()
    _assert_within_a_level(q, s, rq, rs)
    mq, ms, jq_, js = _run(layout, qkv, monkeypatch,
                           {"CHESS_VISION_ATTN_SOFTMAX": "max"})
    assert (mq[0, :4, :DH] != 0).any() and (jq_[0, :4, :DH] != 0).any()
    _assert_within_a_level(mq, ms, jq_, js)


LEGS = {"argvalues": [(True, False), (True, True), (False, True)],
        "ids": ["int8", "int8pv", "pv-only"]}


@pytest.mark.parametrize("exp", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["bound", "fixed", "max"])
def test_shift_modes_match_jax(mode, exp, monkeypatch):
    check_shift_mode("block", mode, exp, monkeypatch)


@pytest.mark.parametrize("legs", **LEGS)
def test_int8_legs_match_jax(legs, monkeypatch):
    check_int8_legs("block", legs, monkeypatch)


def test_planted_overshoot_row_reads_zeros(monkeypatch):
    check_overshoot_row("block", monkeypatch)
