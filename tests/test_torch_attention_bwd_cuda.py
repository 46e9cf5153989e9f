"""The attention backward kernels (csrc/attention_bwd.cu, and above
BWD_MAX_TOKENS tokens csrc/attention_bwd_long.cu) against their plain
PyTorch version on the card. Skips without a CUDA device. On a GPU machine
without JAX, run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention_bwd_cuda.py -q

Tolerance 1.6e-2: both round pn and dS to bf16 and each output once, from
f32 sums taken in another order, so a value may land one bf16 ulp apart (ulp
1.6e-2 for values in [2, 4))."""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

ATOL = 1.6e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, H, Dh, device, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, N, H * Dh)).astype(np.float32))
    return qkv.bfloat16().to(device), g.bfloat16().to(device)


# the ragged edges of the kernel's 16-row blocks and 32-key steps: N = 17, 64,
# 65, 257, 264 (and the largest it takes) with each head dim; past that the
# long route's 64-row tiles at N = 289 and 577 (a 384 px ViT)
ODD = [(2, N, 2, Dh) for N in (17, 64, 65, 257, 264, attn.BWD_MAX_TOKENS,
                               attn.BWD_MAX_TOKENS + 1, 577)
       for Dh in (16, 32, 64)]


@pytest.mark.parametrize("B,N,H,Dh", [(64, 257, 12, 64), (3, 17, 1, 32),
                                      (2, 70, 2, 16), (1, 64, 4, 64),
                                      (2, 129, 3, 32), *ODD])
def test_kernel_matches_plain(cuda, B, N, H, Dh):
    qkv, g = _inputs(B, N, H, Dh, cuda)
    before = attn.BWD_LAUNCHES
    out = attn.fused_qkv_attention_bwd(qkv, g, H)
    torch.cuda.synchronize()
    assert attn.BWD_LAUNCHES == before + 1
    ref = attn.reference_attention_bwd(qkv, g, H)
    assert out.shape == qkv.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=0)
    # deterministic: no atomics
    assert torch.equal(out, attn.fused_qkv_attention_bwd(qkv, g, H))


def test_large_logits_stay_finite(cuda):
    """Scores near 100 (trained models reach them): the max shift keeps the
    recomputed softmax finite, padded rows included."""
    qkv, g = _inputs(2, 257, 2, 64, cuda, seed=1)
    qkv = (qkv.float() * 3.5).bfloat16()
    out = attn.fused_qkv_attention_bwd(qkv, g, 2)
    ref = attn.reference_attention_bwd(qkv, g, 2)
    assert torch.isfinite(out).all()
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * max(scale, 1.0)


def test_autograd_launches_the_kernels(cuda):
    qkv, g = _inputs(4, 257, 12, 64, cuda, seed=2)
    x = qkv.clone().requires_grad_()
    fwd, bwd = attn.LAUNCHES, attn.BWD_LAUNCHES
    out = attn.fused_qkv_attention(x, 12)
    # a strided cotangent, as autograd may hand one
    out.backward(g.transpose(0, 1).contiguous().transpose(0, 1))
    assert (attn.LAUNCHES, attn.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    torch.testing.assert_close(x.grad.float(),
                               attn.reference_attention_bwd(qkv, g, 12).float(),
                               atol=ATOL, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    qkv, g = _inputs(2, 17, 2, 16, cuda)
    with pytest.raises(TypeError):
        attn.fused_qkv_attention_bwd(qkv.float(), g.float(), 2)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_bwd(qkv[:, :, :90], g[:, :, :30], 3)  # head dim 10
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_bwd(qkv.transpose(0, 1), g.transpose(0, 1), 2)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_bwd(qkv, g.cpu(), 2)
    empty = attn.fused_qkv_attention_bwd(qkv[:0], g[:0], 2)
    assert empty.shape == (0, 17, 96)
    # past BWD_MAX_TOKENS tokens the long route takes the call, counted as such
    long_qkv, long_g = _inputs(1, attn.BWD_MAX_TOKENS + 1, 1, 16, cuda)
    before = attn.BWD_LONG_LAUNCHES
    out = attn.fused_qkv_attention_bwd(long_qkv, long_g, 1)
    assert attn.BWD_LONG_LAUNCHES == before + 1
    torch.testing.assert_close(
        out.float(), attn.reference_attention_bwd(long_qkv, long_g, 1).float(),
        atol=ATOL, rtol=0)
