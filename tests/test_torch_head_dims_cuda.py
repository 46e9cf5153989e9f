"""K2 and K3 at head dims other than 16, 32 and 64, on the card: 80 and 128
(their own instantiations: ViT-Huge's 80) and 48 (a head dim between two,
run by the 64 instantiation with its extra columns zero), bf16 and f32,
forward and backward, every route, against ``reference_attention`` and
``reference_attention_bwd``; 12, 136 and 4, which the any-head-dim kernels
run (``tests/test_torch_head_dims_any_cuda.py`` takes them further). Skips
without a CUDA device. On a GPU machine
without JAX, run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_head_dims_cuda.py -q

Tolerances are those the kernels keep at a head dim of 64: the forward 2e-2
in bf16 (the JAX package's bound for its own kernel) and 5e-6 in f32;
the backward 1.6e-2 in bf16 (one bf16 ulp of values in [2, 4): both sides
round pn and dS to bf16 and each output once, from f32 sums taken in
another order) and 5e-6 in f32 (``chip_smoke.py``'s F32_ATOL). The scores'
scale at each head dim is 1 / sqrt(head dim), so the inputs, normal with
unit variance, give scores of the same spread at every head dim. Every
backward is the same twice, bit for bit."""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

FWD_ATOL = {torch.bfloat16: 2e-2, torch.float32: 5e-6}
BWD_ATOL = {torch.bfloat16: 1.6e-2, torch.float32: 5e-6}
DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIMS = (48, 80, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, H, Dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, N, H * Dh)).astype(np.float32))
    return qkv.to(dtype).to(device), g.to(dtype).to(device)


def _fwd_count(dtype):
    return attn.F32_LAUNCHES if dtype == torch.float32 else attn.LAUNCHES


def _bwd_counts():
    return (attn.BWD_LAUNCHES, attn.BWD_LONG_LAUNCHES, attn.F32_BWD_LAUNCHES,
            attn.F32_BWD_LONG_LAUNCHES)


# 17: one ragged row chunk; 257: ViT at 256 px (ViT-Huge's 16 heads of 80);
# 577: 384 px, where the f32 forward walks its CTAs' ranges in windows
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_forward_matches_plain(cuda, dtype):
    for dh in HEAD_DIMS:
        for n in (17, 257, 577):
            qkv, _ = _inputs(2, n, 2, dh, dtype, cuda, seed=n + dh)
            before = _fwd_count(dtype)
            out = attn.fused_qkv_attention_fwd(qkv, 2)
            torch.cuda.synchronize()
            assert _fwd_count(dtype) == before + 1
            ref = attn.reference_attention(qkv, 2)
            assert torch.isfinite(out).all()
            torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                       atol=FWD_ATOL[dtype], msg=f"{dh} {n}")


# bf16: 257 takes the short route at 48 and the cluster route above 64 at
# every count; 577 one cluster; 1100 two clusters (the split through the f32
# scratches). f32: 257 one cluster of 5; 577 the long route, one cluster of
# 10 at 48 and, above 64, two of 5 (the split).
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_backward_matches_plain_and_repeats(cuda, dtype):
    f32 = dtype == torch.float32
    for dh in HEAD_DIMS:
        for n in ((257, 577) if f32 else (257, 577, 1100)):
            qkv, g = _inputs(2, n, 2, dh, dtype, cuda, seed=3 * n + dh)
            route = attn.bwd_route(n, dtype, dh)
            before = _bwd_counts()
            out = attn.fused_qkv_attention_bwd(qkv, g, 2)
            again = attn.fused_qkv_attention_bwd(qkv, g, 2)
            torch.cuda.synchronize()
            moved = [a - b for a, b in zip(_bwd_counts(), before)]
            long = route in ("long", "f32_long")
            want = [0, 0, 2, 2 * long] if f32 else [2, 2 * long, 0, 0]
            assert moved == want, (dh, n, route, moved)
            assert torch.equal(out, again), (dh, n, route)
            ref = attn.reference_attention_bwd(qkv, g, 2)
            assert torch.isfinite(out).all()
            torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                       atol=BWD_ATOL[dtype],
                                       msg=f"{dh} {n} {route}")


@pytest.mark.parametrize("dh", (12, 136, 4))
def test_other_head_dims_raise(cuda, dh):
    """A head dim that is not a multiple of 8 up to 128 no longer raises:
    ``csrc/attention_any.cu`` runs it, forward and backward, held to the
    plain versions at head dim 64's bounds, each call counted in its dtype's
    counter and in the any-head-dim ones; nothing falls back to the plain
    version. A head dim below 1 still raises, naming it."""
    for dtype in DTYPES:
        qkv, g = _inputs(1, 17, 2, dh, dtype, cuda)
        before = (_fwd_count(dtype), attn.ANY_LAUNCHES, _bwd_counts(),
                  attn.ANY_BWD_LAUNCHES)
        out = attn.fused_qkv_attention_fwd(qkv, 2)
        dqkv = attn.fused_qkv_attention_bwd(qkv, g, 2)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        assert _fwd_count(dtype) == before[0] + 1
        assert attn.ANY_LAUNCHES == before[1] + 1
        moved = [a - b for a, b in zip(_bwd_counts(), before[2])]
        assert moved == ([0, 0, 1, 0] if f32 else [1, 0, 0, 0])
        assert attn.ANY_BWD_LAUNCHES == before[3] + 1
        torch.testing.assert_close(out.float(),
                                   attn.reference_attention(qkv, 2).float(),
                                   rtol=0, atol=FWD_ATOL[dtype])
        torch.testing.assert_close(dqkv.float(),
                                   attn.reference_attention_bwd(qkv, g, 2).float(),
                                   rtol=0, atol=BWD_ATOL[dtype])
    qkv, _ = _inputs(1, 17, 2, dh, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim 0 "):
        attn.fused_qkv_attention_fwd(qkv[:, :, :0], 2)


def test_quantizing_attention_keeps_its_head_dims(cuda):
    """K4 takes 16, 32 and 64 alone, as the JAX int8 path."""
    qkv, _ = _inputs(1, 17, 2, 80, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim 80"):
        attn.fused_qkv_attention_quant(qkv, 2)
