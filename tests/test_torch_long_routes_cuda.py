"""K3's long routes on the card: the bf16 backward above ``BWD_MAX_TOKENS``
(``csrc/attention_bwd_cluster.cu``) and the f32 backward above
``F32_MAX_TOKENS`` (``csrc/attention_f32.cu`` on clusters of up to 16 CTAs),
each on ``ops/attention.long_plan``'s thread-block clusters, against
``reference_attention_bwd``. Skips without a CUDA device. On a GPU machine
without JAX, run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_long_routes_cuda.py -q

Tolerances: bf16 1.6e-2, as ``tests/test_torch_attention_bwd_cuda.py`` (both
sides round pn and dS to bf16 and each output once, from f32 sums taken in
another order: one bf16 ulp of values in [2, 4)); f32 5e-6, as
``chip_smoke.py``'s F32_ATOL (IEEE f32 on both sides, sums in another
order). Every call is the same twice, bit for bit: partials are added in
rank order and, where a head's keys split over several clusters, in
cluster order, with no atomics."""

import ctypes

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

ATOL = {torch.bfloat16: 1.6e-2, torch.float32: 5e-6}


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


def _counts():
    return (attn.BWD_LAUNCHES, attn.BWD_LONG_LAUNCHES, attn.F32_BWD_LAUNCHES,
            attn.F32_BWD_LONG_LAUNCHES)


def _check(qkv, g, H):
    """Twice through the wrapper: one counted call each on the long route
    of qkv's dtype, bit-identical, within the tolerance of plain."""
    N = qkv.shape[1]
    f32 = qkv.dtype == torch.float32
    assert attn.bwd_route(N, qkv.dtype) == ("f32_long" if f32 else "long")
    before = _counts()
    out = attn.fused_qkv_attention_bwd(qkv, g, H)
    again = attn.fused_qkv_attention_bwd(qkv, g, H)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == ([0, 0, 2, 2] if f32 else [2, 2, 0, 0]), moved
    assert torch.equal(out, again)
    ref = attn.reference_attention_bwd(qkv, g, H)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=ATOL[qkv.dtype])
    return out


# 289: the first long count (3 CTAs of 8 warps); 577: a 384 px ViT (5 CTAs
# of 8 warps); 1024: one cluster's reach (8 CTAs of 8 warps); 1025: a 512 px
# ViT, past it (2 clusters of 5 CTAs of 8 warps)
@pytest.mark.parametrize("n", (289, 577, 1024, 1025))
def test_bf16_long_route_matches_plain(cuda, n):
    for dh in (16, 32, 64):
        qkv, g = _inputs(2, n, 2, dh, torch.bfloat16, cuda, seed=n + dh)
        _check(qkv, g, 2)


# 513: the first long count (9 CTAs); 577: 10 CTAs; 1025: past one
# cluster's 1,024 tokens (2 clusters of 9 CTAs)
@pytest.mark.parametrize("n", (513, 577, 1025))
def test_f32_long_route_matches_plain(cuda, n):
    for dh in (16, 32, 64):
        qkv, g = _inputs(2, n, 2, dh, torch.float32, cuda, seed=n + dh)
        _check(qkv, g, 2)


def test_long_routes_at_the_384px_training_shape(cuda):
    """577 tokens, 12 heads of 64, as a ViT-B/16 at input_size 384 trains."""
    for dtype, batch in ((torch.bfloat16, 8), (torch.float32, 4)):
        qkv, g = _inputs(batch, 577, 12, 64, dtype, cuda, seed=7)
        _check(qkv, g, 12)


def _entry_call(qkv, g, H, clusters, ctas, warps):
    """The long route's C entry on a plan of the caller's."""
    from chess_vision_tpu_torch.ops import _build

    lib = _build.library()
    B, N, C3 = qkv.shape
    dh = C3 // 3 // H
    dqkv = torch.empty_like(qkv)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    stats = torch.empty((B, H, clusters, 3, N), **f32)
    parts = torch.empty((B, H, clusters, N, dh), **f32)
    scratch = ([stats.data_ptr(), parts.data_ptr()] if clusters > 1
               else [None, None])
    plan = [clusters, ctas] + ([] if qkv.dtype == torch.float32 else [warps])
    entry = (lib.cvt_attention_bwd_f32_long if qkv.dtype == torch.float32
             else lib.cvt_attention_bwd_long)
    rc = entry(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), *scratch, B, N, H,
               dh, *plan, dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    return rc, dqkv


def test_a_head_split_over_clusters_matches_one_cluster(cuda):
    """At 577 tokens the entries take a head split over 2 and 3 clusters
    (statistics pass, main pass, dQ sum) as well as the wrapper's one."""
    for dtype, plans in ((torch.bfloat16, ((2, 4, 5), (3, 4, 4))),
                         (torch.float32, ((2, 5, 4), (3, 4, 4)))):
        qkv, g = _inputs(2, 577, 2, 64, dtype, cuda, seed=11)
        ref = attn.reference_attention_bwd(qkv, g, 2)
        for plan in plans:
            rc, out = _entry_call(qkv, g, 2, *plan)
            torch.cuda.synchronize()
            assert rc == 0, (dtype, plan, rc)
            torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                       atol=ATOL[dtype])
            assert torch.equal(out, _entry_call(qkv, g, 2, *plan)[1])


def test_long_entries_refuse_plans_that_do_not_fit(cuda):
    """More CTAs than a cluster may have, more keys a CTA than its warps
    hold, more CTAs than 16-key steps, a split without its scratches."""
    qkv, g = _inputs(1, 577, 2, 64, torch.bfloat16, cuda)
    for plan in ((1, 9, 5), (1, 8, 4), (1, 8, 10), (5, 8, 1)):
        assert _entry_call(qkv, g, 2, *plan)[0] != 0, plan
    qkv, g = _inputs(1, 577, 2, 64, torch.float32, cuda)
    for plan in ((1, 17, 4), (1, 9, 4), (10, 4, 4)):
        assert _entry_call(qkv, g, 2, *plan)[0] != 0, plan
    from chess_vision_tpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(qkv)
    assert lib.cvt_attention_bwd_f32_long(
        qkv.data_ptr(), g.data_ptr(), out.data_ptr(), None, None, 1, 577, 2, 64, 2, 5,
        0.125, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) != 0
