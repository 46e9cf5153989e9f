"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. They skip without a CUDA device. On a GPU machine without JAX,
run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import preprocess as pp

pytestmark = pytest.mark.cuda

VIT = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("shape", [(4, 64, 64, 3), (3, 17, 5, 3), (2, 7, 9, 4)])
@pytest.mark.parametrize("norm", [VIT, IMAGENET])
def test_preprocess_kernel_matches_plain(cuda, shape, norm):
    # one (mean, std) per channel: cycle the 3-channel table for C = 4
    mean, std = ((v * 2)[: shape[-1]] for v in norm)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=g)
    before = pp.LAUNCHES
    out = pp.preprocess_u8(x, mean, std, torch.bfloat16)
    f32 = pp.preprocess_u8(x, mean, std, torch.float32)
    torch.cuda.synchronize()
    assert pp.LAUNCHES == before + 2
    assert _bf16_ulps(out, pp.preprocess_u8_plain(x, mean, std)) <= 1.0
    # fma vs a separate multiply and add: the multiply's rounding (half an
    # f32 ulp of x * scale <= 4.5) plus the final one
    torch.testing.assert_close(
        f32, pp.preprocess_u8_plain(x, mean, std, torch.float32),
        rtol=0, atol=1e-6)


def test_preprocess_kernel_unaligned_view(cuda):
    """A view whose data starts off a 16-byte boundary takes the scalar path."""
    flat = torch.randint(0, 256, (1 + 2 * 8 * 8 * 3,), dtype=torch.uint8,
                         device=cuda)
    x = flat[1:].view(2, 8, 8, 3)
    assert x.data_ptr() % 16
    out = pp.preprocess_u8(x, *VIT)
    assert _bf16_ulps(out, pp.preprocess_u8_plain(x, *VIT)) <= 1.0


@pytest.mark.parametrize("B,N,H,Dh", [(2, 257, 12, 64), (3, 17, 1, 32),
                                      (1, 64, 4, 16), (2, 300, 2, 64),
                                      (2, 5, 3, 64)])
def test_attention_kernel_matches_plain(cuda, B, N, H, Dh):
    qkv = torch.from_numpy(
        np.random.default_rng(0).normal(size=(B, N, 3 * H * Dh)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    before = attn.LAUNCHES
    out = attn.fused_qkv_attention(qkv, H)
    torch.cuda.synchronize()
    assert attn.LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, H * Dh)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(),
                               attn.reference_attention(qkv, H).float(),
                               rtol=0, atol=2e-2)


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    qkv = torch.zeros((2, 17, 3 * 2 * 64), device=cuda)
    with pytest.raises(TypeError):
        attn.fused_qkv_attention(qkv, 2)  # f32
    with pytest.raises(ValueError):
        attn.fused_qkv_attention(qkv.bfloat16(), 3)  # does not split into heads
    with pytest.raises(ValueError):
        attn.fused_qkv_attention(qkv.bfloat16()[:, ::2], 2)  # not contiguous
