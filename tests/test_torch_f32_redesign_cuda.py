"""The f32 attention kernels on their thread-block cluster
(``csrc/attention_f32.cu``: K2 and K3 on f32 inputs, one cluster per (image,
head) holding the head's keys, ``ops/attention.f32_plan``) and the backward's
long route above ``F32_MAX_TOKENS`` (the same kernel on clusters of up to
16 CTAs, ``ops/attention.long_plan``), against
their plain PyTorch versions on the card. Skips without a CUDA device. On a
GPU machine without JAX, run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f32_redesign_cuda.py -q

Tolerance: 5e-6 absolute on values of order 1, as ``chip_smoke.py``'s
F32_ATOL: IEEE f32 on both sides, the sums in another order (warps' and
CTAs' partial row statistics rescaled to the head's row max, split sums of
the products over keys). The backward is the same twice, bit for bit: the
cluster's partials are added in rank order, with no atomics."""

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


def _check(qkv, g, H):
    """Forward and backward against plain, the backward twice bit for bit,
    one counted call each on the route ``bwd_route`` names (the long one
    past ``F32_MAX_TOKENS``)."""
    N = qkv.shape[1]
    long_route = N > attn.F32_MAX_TOKENS
    assert attn.bwd_route(N, torch.float32) == ("f32_long" if long_route else "f32")
    counts = (attn.F32_LAUNCHES, attn.F32_BWD_LAUNCHES, attn.F32_BWD_LONG_LAUNCHES)
    out = attn.fused_qkv_attention_fwd(qkv, H)
    dqkv = attn.fused_qkv_attention_bwd(qkv, g, H)
    again = attn.fused_qkv_attention_bwd(qkv, g, H)
    torch.cuda.synchronize()
    assert (attn.F32_LAUNCHES, attn.F32_BWD_LAUNCHES, attn.F32_BWD_LONG_LAUNCHES) == (
        counts[0] + 1, counts[1] + 2, counts[2] + 2 * long_route)
    assert torch.equal(dqkv, again)
    torch.testing.assert_close(out, attn.reference_attention(qkv, H), rtol=0, atol=ATOL)
    torch.testing.assert_close(dqkv, attn.reference_attention_bwd(qkv, g, H),
                               rtol=0, atol=ATOL)


# the route's edges: one key, a ragged 16-key step and a 16-row tail tile,
# two CTAs past a 64-row tile; a five-CTA cluster with ragged ranges; the
# cluster at its limit, 8 CTAs (449 tokens: the first such count, the last
# CTA 33 keys; 512: 64 keys each); past it (the forward's 80-key ranges in
# 64-key windows, the backward's long route); each head dim
@pytest.mark.parametrize("ns", ((1, 17, 65), (300,), (449, 512), (577,)),
                         ids=("tails", "ragged", "eight_ctas", "long"))
def test_f32_kernels_match_plain_at_the_edges(cuda, ns):
    for n in ns:
        for dh in (16, 32, 64):
            qkv, g = _inputs(2, n, 2, dh, cuda, seed=n + dh)
            _check(qkv, g, 2)


def test_f32_kernels_at_the_vit_shape_and_one_backward_launch(cuda):
    """257 tokens, 12 heads of 64: a cluster of 5 CTAs of 64 keys (the
    last holds one); the backward is one kernel launch a call."""
    from torch.profiler import ProfilerActivity, profile

    qkv, g = _inputs(4, 257, 12, 64, cuda, seed=3)
    assert attn.f32_plan(257) == ("f32", 5)
    _check(qkv, g, 12)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attn.fused_qkv_attention_bwd(qkv, g, 12)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "mem" not in e.name.lower()]
    assert len(names) == 1 and "attention_bwd_f32_kernel" in names[0], names


def test_f32_kernels_with_six_heads(cuda):
    """A tensor-parallel rank's head count (12 heads over 2 ranks)."""
    qkv, g = _inputs(3, 257, 6, 64, cuda, seed=6)
    _check(qkv, g, 6)


def test_f32_remat_attn_out_runs_the_kernels(cuda):
    """``attention_recomputing_qkv`` (``remat="attn_out"``) on f32: the
    forward once, the backward once, the gradient of x and of the qkv
    weight equal to plain attention's."""
    torch.manual_seed(0)
    B, N, D, H = 2, 65, 128, 2
    x = torch.randn((B, N, D), device=cuda)
    w = (torch.randn((3 * D, D), device=cuda) * D ** -0.5).requires_grad_()
    g = torch.randn((B, N, D), device=cuda)

    def make_qkv(x_):
        return x_ @ w.t()

    xk = x.clone().requires_grad_()
    counts = (attn.F32_LAUNCHES, attn.F32_BWD_LAUNCHES)
    attn.attention_recomputing_qkv(xk, make_qkv, [w], H).backward(g)
    torch.cuda.synchronize()
    assert (attn.F32_LAUNCHES, attn.F32_BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    grads = xk.grad.clone(), w.grad.clone()
    w.grad = None
    xp = x.clone().requires_grad_()
    attn.reference_attention(make_qkv(xp), H).backward(g)
    torch.testing.assert_close(grads[0], xp.grad, rtol=0, atol=2e-5)
    torch.testing.assert_close(grads[1], w.grad, rtol=0, atol=2e-5)


def test_f32_refusals(cuda):
    """The C entries refuse a cluster that does not fit the tokens: more
    than 8 CTAs, a CTA without a key, or (the backward) more than a CTA's
    64 keys."""
    from chess_vision_tpu_torch.ops import _build

    lib = _build.library()
    qkv, g = _inputs(1, 257, 2, 64, cuda)
    out = torch.empty((1, 257, 128), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for n, ctas in ((257, 9), (257, 0), (17, 3)):
        assert lib.cvt_attention_fwd_f32(qkv.data_ptr(), out.data_ptr(), 1, n, 2, 64,
                                         ctas, 0.125, 1.0, stream) != 0
    # 257 tokens over 4 CTAs: one would hold 80 keys
    assert lib.cvt_attention_bwd_f32(qkv.data_ptr(), g.data_ptr(), qkv.data_ptr(), 1, 257,
                                     2, 64, 4, 0.125, stream) != 0
