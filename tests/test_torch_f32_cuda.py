"""The f32 attention kernels (``csrc/attention_f32.cu``: K2's forward and
K3's backward on f32 inputs, one thread-block cluster per (image, head);
above ``F32_MAX_TOKENS`` the backward's long route, the same kernel on
clusters of up to 16 CTAs) against their plain PyTorch versions on the
card. Skips without a CUDA device. On a GPU machine without JAX, run
without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f32_cuda.py -q

Tolerances, absolute on values of order 1: forward 5e-6 and backward 5e-6,
IEEE f32 on both sides with the sums in another order (partial row
statistics of warps and CTAs rescaled to the head's row max; read on the
H100: 1.2e-6 at most)."""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

ATOL = 5e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, H, Dh, device, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32)
    g = rng.normal(size=(B, N, H * Dh)).astype(np.float32)
    return torch.from_numpy(qkv).to(device), torch.from_numpy(g).to(device)


# the 64-row tiles' ragged edges with each head dim, the ViT's 257 tokens
# with its 12 heads, and past the f32 cluster's 512 (the backward's long
# route); one test case per token count, the head dims inside it
TOKENS = (1, 17, 65, 257, 577)


def _shapes(n):
    return [(3, n, 12, 64)] if n == 257 else [(2, n, 2, dh) for dh in (16, 32, 64)]


@pytest.mark.parametrize("n", TOKENS)
def test_f32_forward_kernel_matches_plain(cuda, n):
    for B, N, H, Dh in _shapes(n):
        qkv, _ = _inputs(B, N, H, Dh, cuda)
        before = attn.F32_LAUNCHES, attn.LAUNCHES
        out = attn.fused_qkv_attention(qkv, H)
        torch.cuda.synchronize()
        assert (attn.F32_LAUNCHES, attn.LAUNCHES) == (before[0] + 1, before[1])
        assert out.dtype == torch.float32 and out.shape == (B, N, H * Dh)
        torch.testing.assert_close(out, attn.reference_attention(qkv, H),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", TOKENS[1:])
def test_f32_backward_kernel_matches_plain(cuda, n):
    for B, N, H, Dh in _shapes(n):
        qkv, g = _inputs(B, N, H, Dh, cuda, seed=1)
        before = attn.F32_BWD_LAUNCHES, attn.BWD_LAUNCHES
        dqkv = attn.fused_qkv_attention_bwd(qkv, g, H)
        again = attn.fused_qkv_attention_bwd(qkv, g, H)
        torch.cuda.synchronize()
        assert (attn.F32_BWD_LAUNCHES, attn.BWD_LAUNCHES) == (before[0] + 2,
                                                              before[1])
        assert torch.equal(dqkv, again)  # no atomics: deterministic
        torch.testing.assert_close(dqkv, attn.reference_attention_bwd(qkv, g, H),
                                   rtol=0, atol=ATOL)


def test_f32_autograd_and_refusals(cuda):
    qkv, g = _inputs(2, 65, 2, 32, cuda)
    x = qkv.clone().requires_grad_()
    attn.fused_qkv_attention(x, 2).backward(g)
    torch.testing.assert_close(x.grad, attn.reference_attention_bwd(qkv, g, 2),
                               rtol=0, atol=ATOL)
    with pytest.raises(TypeError):  # the quantizing attention stays bf16
        attn.fused_qkv_attention_quant(torch.zeros((1, 17, 3 * 2 * 64),
                                                   device=cuda), 2)
    with pytest.raises(TypeError):
        attn.fused_qkv_attention(qkv.double(), 2)
