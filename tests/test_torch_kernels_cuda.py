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


def _every_byte(device) -> torch.Tensor:
    """(3, 16, 16, 3) uint8 images that hold every byte value in every
    channel."""
    values = torch.arange(256, dtype=torch.uint8, device=device)
    x = values.repeat_interleave(3).reshape(1, 16, 16, 3)
    return torch.cat([x, x.roll(1, dims=-1), x.roll(2, dims=-1)])


@pytest.mark.parametrize("shape", [(4, 64, 64, 3), (3, 17, 5, 3), (2, 7, 9, 4),
                                   "every byte"])
@pytest.mark.parametrize("norm", [VIT, IMAGENET])
def test_preprocess_kernel_matches_plain(cuda, shape, norm):
    """Bit for bit in bf16 and f32: the kernel rounds the multiply and the
    add apart, as the plain version does. A fused multiply-add put bf16
    outputs one ulp off, and on a trained ViT-B/16 that alone moved a square
    whose int8 top-2 margin was 2.3e-3."""
    if shape == "every byte":
        x = _every_byte(cuda)
    else:
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                          generator=g)
    # one (mean, std) per channel: cycle the 3-channel table for C = 4
    mean, std = ((v * 2)[: x.shape[-1]] for v in norm)
    before = pp.LAUNCHES
    for dtype in (torch.bfloat16, torch.float32):
        out = pp.preprocess_u8(x, mean, std, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, pp.preprocess_u8_plain(x, mean, std, dtype)), dtype
    assert pp.LAUNCHES == before + 2


def test_preprocess_kernel_unaligned_view(cuda):
    """A view whose data starts off a 16-byte boundary takes the scalar
    path, bit for bit as the vector path."""
    x = _every_byte(cuda)
    flat = torch.cat([torch.zeros(1, dtype=torch.uint8, device=cuda),
                      x.reshape(-1)])
    x = flat[1:].view(x.shape)
    assert x.data_ptr() % 16
    for norm in (VIT, IMAGENET):
        for dtype in (torch.bfloat16, torch.float32):
            out = pp.preprocess_u8(x, *norm, dtype)
            assert torch.equal(out, pp.preprocess_u8_plain(x, *norm, dtype))


@pytest.mark.parametrize("B,N,H,Dh", [(2, 257, 12, 64), (3, 17, 1, 32),
                                      (1, 64, 4, 16), (2, 300, 2, 64),
                                      (2, 5, 3, 64), (2, 577, 2, 64),
                                      (1, 1025, 2, 16)])
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
