"""K2 and K3 at every head dim the JAX kernels take, on the card: the
any-head-dim kernels of ``csrc/attention_any.cu`` at head dims that are not
a multiple of 8 (1, 3, 12, 20, 36, 100) or are above 128 (136, 192, 256,
384, 768), at 257 tokens and, for 12 and 256, at 17, 577 and 1,100; a qkv
view that starts off a 16-byte boundary at head dim 64; and the gradient of
``fused_qkv_attention`` through autograd at 64 heads of 12. bf16 and f32,
against ``reference_attention`` and ``reference_attention_bwd``, every
backward the same twice bit for bit, every call counted. Skips without a
CUDA device. On a GPU machine without JAX, run without the JAX test
configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_head_dims_any_cuda.py -q

Tolerances are those the kernels keep at a head dim of 64: the forward 2e-2
in bf16 (the JAX package's bound for its own kernel) and 5e-6 in f32; the
backward 1.6e-2 in bf16 (one bf16 ulp of values in [2, 4): both sides round
pn and dS to bf16 and each output once, from f32 sums taken in another
order) and 5e-6 in f32. The scores' scale is 1 / sqrt(head dim), so inputs
normal with unit variance give scores of the same spread at every head
dim."""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

FWD_ATOL = {torch.bfloat16: 2e-2, torch.float32: 5e-6}
BWD_ATOL = {torch.bfloat16: 1.6e-2, torch.float32: 5e-6}
DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIMS = (1, 3, 12, 20, 36, 100, 136, 192, 256, 384, 768)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, H, Dh, dtype, device, seed=0, offset=0):
    """qkv (a view ``offset`` elements into its storage) and g."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=offset + B * N * 3 * H * Dh).astype(np.float32)
    qkv = torch.from_numpy(flat).to(dtype).to(device)[offset:]
    g = torch.from_numpy(rng.normal(size=(B, N, H * Dh)).astype(np.float32))
    return qkv.view(B, N, 3 * H * Dh), g.to(dtype).to(device)


def _counts():
    return (attn.LAUNCHES, attn.F32_LAUNCHES, attn.ANY_LAUNCHES,
            attn.BWD_LAUNCHES, attn.F32_BWD_LAUNCHES, attn.ANY_BWD_LAUNCHES,
            attn.BWD_LONG_LAUNCHES, attn.F32_BWD_LONG_LAUNCHES)


def _check(B, N, H, dh, dtype, device, offset=0):
    qkv, g = _inputs(B, N, H, dh, dtype, device, seed=N + dh, offset=offset)
    before = _counts()
    out = attn.fused_qkv_attention_fwd(qkv, H)
    dqkv = attn.fused_qkv_attention_bwd(qkv, g, H)
    again = attn.fused_qkv_attention_bwd(qkv, g, H)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_counts(), before)]
    f32 = dtype == torch.float32
    assert moved == ([0, 1, 1, 0, 2, 2, 0, 0] if f32 else [1, 0, 1, 2, 0, 2, 0, 0]), \
        (dh, N, moved)
    assert torch.equal(dqkv, again), (dh, N)
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    torch.testing.assert_close(out.float(), attn.reference_attention(qkv, H).float(),
                               rtol=0, atol=FWD_ATOL[dtype], msg=f"{dh} {N}")
    torch.testing.assert_close(dqkv.float(),
                               attn.reference_attention_bwd(qkv, g, H).float(),
                               rtol=0, atol=BWD_ATOL[dtype], msg=f"{dh} {N}")


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_every_head_dim_matches_plain(cuda, dtype):
    for dh in HEAD_DIMS:
        assert attn.head_dim_route(dh) == "any"
        _check(2, 257, 2, dh, dtype, cuda)


# 17: one ragged tile; 577: ViT at 384 px; 1,100: past the 1,024 tokens
# where the instantiated kernels' long routes split a head over clusters
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_token_counts_match_plain(cuda, dtype):
    for dh in (12, 256):
        for n in (17, 577, 1100):
            _check(2, n, 3, dh, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_unaligned_qkv_takes_the_any_kernels(cuda, dtype):
    """A qkv view one element into its storage at head dim 64: not 16-byte
    aligned, so the any-head-dim kernels run it (the instantiated ones copy
    16 bytes at a time)."""
    qkv, _ = _inputs(1, 65, 2, 64, dtype, cuda, offset=1)
    assert qkv.data_ptr() % 16
    _check(1, 65, 2, 64, dtype, cuda, offset=1)


def test_autograd_at_64_heads_of_12(cuda):
    """ViT-B/16's width on 64 heads of 12 through ``fused_qkv_attention``
    and autograd: one any-head-dim forward and backward, the gradient held
    to the plain backward's."""
    qkv, g = _inputs(2, 257, 64, 12, torch.bfloat16, cuda, seed=12)
    x = qkv.clone().requires_grad_()
    before = _counts()
    out = attn.fused_qkv_attention(x, 64)
    out.backward(g)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == [1, 0, 1, 1, 0, 1, 0, 0]
    torch.testing.assert_close(x.grad.float(),
                               attn.reference_attention_bwd(qkv, g, 64).float(),
                               rtol=0, atol=BWD_ATOL[torch.bfloat16])
