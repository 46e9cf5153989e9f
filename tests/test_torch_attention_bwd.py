"""The port's attention backward (chess_vision_tpu_torch/ops/attention.py):
``reference_attention_bwd``, the plain PyTorch version that a CPU tensor
runs, against the JAX package's Pallas backward kernel in interpret mode, and
autograd through ``fused_qkv_attention`` against ``jax.vjp`` of the JAX
reference. The CUDA kernel is held against the plain version on the card
(test_torch_attention_bwd_cuda.py).

Tolerances: f32 1e-5 against the kernel (summation order only: both compute
every step in f32); bf16 atol 5e-2 against the f32 analytic VJP, the JAX
test's own bound for its kernel (tests/test_attention.py), and 1.6e-2 (one
bf16 ulp of values in [2, 4)) against the JAX kernel, which rounds pn and dS
to bf16 at the same points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops.attention import (
    _kernel_attention_bwd,
    _reference_attention,
)
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

# (2, 70, 1, 32): one head, and a ragged tail past a tile of 64 keys
SHAPES = [(2, 17, 4, 16), (1, 257, 2, 64), (2, 70, 1, 32)]


def _inputs(B, N, H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32),
            rng.normal(size=(B, N, H * Dh)).astype(np.float32))


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_reference_bwd_matches_jax_kernel_f32(B, N, H, Dh):
    qkv, g = _inputs(B, N, H, Dh)
    ours = attn.reference_attention_bwd(torch.from_numpy(qkv),
                                        torch.from_numpy(g), H)
    assert ours.dtype == torch.float32 and ours.shape == qkv.shape
    kernel = np.asarray(_kernel_attention_bwd(jnp.asarray(qkv), jnp.asarray(g),
                                              H, interpret=True))
    np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-5)


@pytest.mark.parametrize("B,N,H,Dh", SHAPES)
def test_reference_bwd_matches_jax_kernel_bf16(B, N, H, Dh):
    qkv, g = _inputs(B, N, H, Dh, seed=1)
    ours = attn.reference_attention_bwd(torch.from_numpy(qkv).bfloat16(),
                                        torch.from_numpy(g).bfloat16(), H)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    jq, jg = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    kernel = np.asarray(_kernel_attention_bwd(jq, jg, H, interpret=True),
                        np.float32)
    np.testing.assert_allclose(ours, kernel, atol=1.6e-2)
    _, vjp = jax.vjp(lambda t: _reference_attention(t, H),
                     jq.astype(jnp.float32))
    analytic = np.asarray(vjp(jg.astype(jnp.float32))[0])
    np.testing.assert_allclose(ours, analytic, atol=5e-2)


@pytest.mark.parametrize("B,N,H,Dh", SHAPES[:2])
def test_autograd_matches_jax_vjp(B, N, H, Dh):
    """torch.autograd through fused_qkv_attention on the CPU (the Function
    whose backward is reference_attention_bwd) against jax.vjp of the JAX
    reference, f32; the Function saves qkv and nothing else."""
    qkv, g = _inputs(B, N, H, Dh, seed=2)
    x = torch.from_numpy(qkv).requires_grad_()
    out = attn.fused_qkv_attention(x, H)
    assert out.grad_fn is not None and "FusedAttention" in type(out.grad_fn).__name__
    assert [t.shape for t in out.grad_fn.saved_tensors] == [x.shape]
    out.backward(torch.from_numpy(g))
    ref_out, vjp = jax.vjp(lambda t: _reference_attention(t, H), jnp.asarray(qkv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5)


def test_gradcheck_float64():
    x = torch.from_numpy(_inputs(1, 5, 2, 4, seed=3)[0]).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: attn.fused_qkv_attention(t, 2), (x,))


def test_backward_wrapper_checks_and_strided_cotangent():
    qkv, g = _inputs(2, 9, 2, 16, seed=4)
    x = torch.from_numpy(qkv)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_bwd(x, torch.from_numpy(g)[:, :-1], 2)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_bwd(x, torch.from_numpy(g).bfloat16(), 2)
    # autograd hands a non-contiguous cotangent: the result is the same
    strided = torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))).transpose(0, 1)
    assert not strided.is_contiguous()
    torch.testing.assert_close(attn.fused_qkv_attention_bwd(x, strided, 2),
                               attn.fused_qkv_attention_bwd(x, torch.from_numpy(g), 2))
    # without grad the wrapper is the forward alone, with no graph
    assert attn.fused_qkv_attention(x, 2).grad_fn is None
    # the plain versions count no kernel launch
    assert attn.LAUNCHES == 0 and attn.BWD_LAUNCHES == 0
