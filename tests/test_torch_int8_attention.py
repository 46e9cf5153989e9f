"""The port's quantizing attention (chess_vision_tpu_torch/ops/attention.py
``fused_qkv_attention_quant``) against the JAX package's (K4), on the same
inputs made with numpy. The port runs its plain PyTorch version, which is
what a CPU tensor takes; the JAX side runs its Pallas kernel in interpret
mode, as its own tests do. The CUDA kernel is held against the plain version
on the card (test_torch_int8_kernels_cuda.py).

Tolerances, those of the JAX package's own tests: dequantized attention
within 0.02 of the same softmax mode and 0.04 across modes
(tests/test_attention.py test_fixed_shift_softmax_matches_max_shift);
scales rtol 1e-5. Without a calibrated shift both take the JAX default
"bound" shift; ``shift_mode="max"`` names the exact row max
(tests/test_torch_int8_modes.py holds every mode within one int8 level).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import attention as jax_attn
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)


def assert_scales_close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(B, N, H, Dh, seed, q_gain=4.0):
    qkv = np.random.default_rng(seed).normal(size=(B, N, 3 * H * Dh))
    qkv[:, :, :H * Dh] *= q_gain  # logits of O(10), as a trained checkpoint
    return qkv.astype(np.float32)


def _deq(q, s):
    return np.asarray(q, np.float32) * np.asarray(s, np.float32)


@pytest.mark.parametrize("B,N,H,Dh", [(2, 257, 2, 64), (2, 33, 4, 64),
                                      (1, 40, 2, 32)])
def test_attention_quant_matches_jax_modes(B, N, H, Dh, monkeypatch):
    qkv = _qkv(B, N, H, Dh, seed=N)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    oq, os_ = attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), H)
    assert oq.dtype == torch.int8 and os_.shape == (B, N, 1)
    ours = _deq(oq.numpy(), os_.numpy())
    ours_max = _deq(*(t.numpy() for t in attn.fused_qkv_attention_quant(
        _t(qkv).bfloat16(), H, shift_mode="max")))
    ref_bound = _deq(*jax_attn.fused_qkv_attention_quant(jq, H, interpret=True))
    monkeypatch.setenv("CHESS_VISION_ATTN_SOFTMAX", "max")
    ref_max = _deq(*jax_attn.fused_qkv_attention_quant(jq, H, interpret=True))
    np.testing.assert_allclose(ours_max, ref_max, atol=0.02)
    np.testing.assert_allclose(ours, ref_bound, atol=0.02)
    np.testing.assert_allclose(ours_max, ref_bound, atol=0.04)


@pytest.mark.parametrize("N", [257, 33])
def test_attention_quant_fixed_shift_matches_jax(N):
    B, H, Dh = 2, 2, 64
    qkv = _qkv(B, N, H, Dh, seed=N + 1)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    s = np.einsum("bqhd,bkhd->bhqk",
                  *(qkv.reshape(B, N, 3, H, Dh)[:, :, i] for i in (0, 1))) / 8
    shift = float(s.max()) - 40.0  # as calibrate_attn_shifts sets it
    ref = _deq(*jax_attn.fused_qkv_attention_quant(jq, H, interpret=True,
                                                   softmax_shift=shift))
    ours = _deq(*attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), H, shift))
    np.testing.assert_allclose(ours, ref, atol=0.02)


def test_attention_quant_underflowed_rows_give_zeros():
    """A shift far above every logit underflows each row's exponentials: the
    rowsum floor turns that into zero attention, codes 0 and scale 1e-8/127,
    as in the JAX kernel; never NaN."""
    B, N, H, Dh = 1, 17, 2, 64
    qkv = _qkv(B, N, H, Dh, seed=9, q_gain=1.0)
    oq, os_ = attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), H, 1000.0)
    ref_q, ref_s = jax_attn.fused_qkv_attention_quant(
        jnp.asarray(qkv).astype(jnp.bfloat16), H, interpret=True,
        softmax_shift=1000.0)
    assert (oq == 0).all() and torch.isfinite(os_).all()
    np.testing.assert_array_equal(oq.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(os_.numpy(), np.full((B, N, 1), 1e-8 / 127),
                               rtol=1e-6)
    assert_scales_close(os_.numpy(), ref_s)


def test_attention_quant_cpu_tensor_takes_plain_path():
    qkv = _t(_qkv(2, 17, 2, 16, seed=3)).bfloat16()
    before = attn.QUANT_LAUNCHES
    oq, os_ = attn.fused_qkv_attention_quant(qkv, 2, 1.5)
    assert attn.QUANT_LAUNCHES == before
    ref_q, ref_s = attn.reference_attention_quant(qkv, 2, 1.5)
    assert torch.equal(oq, ref_q) and torch.equal(os_, ref_s)
