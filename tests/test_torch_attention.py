"""The port's attention (chess_vision_tpu_torch/ops/attention.py) against the
JAX package's: the plain PyTorch version, which is what a CPU tensor runs,
against the Pallas kernel in interpret mode and the plain-XLA reference. The
CUDA kernel is held against the plain version on the card
(test_torch_kernels_cuda.py).

Tolerances: bf16 atol 2e-2, the JAX package's own bound for its kernel
(tests/test_attention.py), since bf16 scores and probabilities round at other
points in the two; f32 atol 1e-5 (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops.attention import _kernel_attention, _reference_attention
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

SHAPES = [(2, 257, 12, 64), (3, 17, 1, 32), (1, 64, 4, 16)]


def _qkv(B, N, H, Dh, seed=0):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * H * Dh)).astype(
        np.float32)


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_reference_matches_jax_bf16(B, N, H, Dh):
    x = _qkv(B, N, H, Dh)
    jx = jnp.asarray(x, jnp.bfloat16)
    ours = attn.reference_attention(torch.from_numpy(x).bfloat16(), H)
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, N, H * Dh)
    ours = ours.float().numpy()
    kernel = np.asarray(_kernel_attention(jx, H, interpret=True), np.float32)
    plain = np.asarray(_reference_attention(jx, H), np.float32)
    np.testing.assert_allclose(ours, kernel, atol=2e-2)
    np.testing.assert_allclose(ours, plain, atol=2e-2)


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_reference_matches_jax_f32(B, N, H, Dh):
    x = _qkv(B, N, H, Dh, seed=1)
    ours = attn.reference_attention(torch.from_numpy(x), H).numpy()
    kernel = np.asarray(_kernel_attention(jnp.asarray(x), H, interpret=True))
    plain = np.asarray(_reference_attention(jnp.asarray(x), H))
    np.testing.assert_allclose(ours, kernel, atol=1e-5)
    np.testing.assert_allclose(ours, plain, atol=1e-5)


def test_cpu_tensor_takes_plain_path():
    qkv = torch.from_numpy(_qkv(2, 17, 2, 16, seed=2))
    before = attn.LAUNCHES
    out = attn.fused_qkv_attention(qkv, 2)
    assert attn.LAUNCHES == before
    torch.testing.assert_close(out, attn.reference_attention(qkv, 2),
                               rtol=0, atol=0)
