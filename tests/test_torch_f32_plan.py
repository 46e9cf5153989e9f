"""The f32 attention kernels' plan (``ops/attention.f32_plan``: the route
and the thread-block cluster's CTAs; ``f32_key_ranges``: their keys) and the
kernels' arithmetic emulated in plain PyTorch, on the CPU. The kernels
themselves run on the card only (``tests/test_torch_f32_redesign_cuda.py``).

The emulations follow ``csrc/attention_f32.cu`` step by step: each CTA of a
cluster holds a range of keys, each warp 16 of them; the backward's row
statistics go from warps to CTAs to the head, each level rescaled by
exp(m_part - m); the forward's CTAs add unnormalized P V partials rescaled to
the head's row max, with one division. Tolerance against the plain versions
(which ``tests/test_torch_f32_attention.py`` holds to the JAX kernels): 2e-6
absolute on values of order 1, f32 sums in another order."""

import os

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

NS = range(1, 2049)


@pytest.mark.parametrize("backward", (True, False))
def test_key_ranges_partition_the_tokens(backward):
    """Every CTA's range is whole 16-key steps (the last may be short),
    none is empty, and they tile [0, N); on the backward's routes (one
    cluster up to 512 tokens, ``long_plan``'s clusters above) none holds
    more than a CTA's 64 keys."""
    for n in NS:
        route, ctas = attn.f32_plan(n, backward)
        if route == "f32_long":  # over the long plan's clusters
            ctas *= attn.long_plan(n, torch.float32)[0]
        ranges = attn.f32_key_ranges(n, ctas)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a < b for a, b in ranges), (n, ranges)  # none empty
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(ctas - 1))
        assert all(a % attn.F32_KEY_STEP == 0 for a, _ in ranges)
        if backward or n <= attn.F32_MAX_TOKENS:
            assert max(b - a for a, b in ranges) <= attn.F32_CTA_KEYS


def test_cluster_size_and_the_long_route():
    """At most 8 CTAs a cluster, the fewest that hold the keys at 64 a CTA;
    the backward's cluster route takes exactly the counts up to 512 tokens,
    its long route clusters of up to 16 CTAs of 64 keys (the fewest
    clusters, then the fewest CTAs); the forward takes every count on the
    cluster (64-key windows above)."""
    for n in NS:
        route, ctas = attn.f32_plan(n)
        assert route == attn.bwd_route(n, torch.float32)
        assert route == ("f32" if n <= attn.F32_MAX_TOKENS else "f32_long")
        if route == "f32":
            assert ctas == -(-n // attn.F32_CTA_KEYS) <= attn.F32_MAX_CTAS
        else:
            clusters = -(-n // (attn.F32_LONG_MAX_CTAS * attn.F32_CTA_KEYS))
            per = -(-(-(-n // 16)) // clusters)  # a cluster's 16-key steps
            assert ctas == -(-per // 4) <= attn.F32_LONG_MAX_CTAS
        route, ctas = attn.f32_plan(n, backward=False)
        assert route == "f32" and ctas == min(-(-n // 64), attn.F32_MAX_CTAS)
    assert attn.f32_plan(257) == ("f32", 5)
    assert attn.f32_key_ranges(257, 5) == [(0, 64), (64, 128), (128, 176),
                                           (176, 224), (224, 257)]
    assert attn.f32_plan(449) == ("f32", 8)  # the first 8-CTA cluster
    assert attn.bwd_route(512, torch.float32) == "f32"
    assert attn.bwd_route(513, torch.float32) == "f32_long"
    with pytest.raises(ValueError):
        attn.f32_plan(0)


def test_plan_constants_and_shared_memory_match_the_kernel_source():
    """The Python plan's constants are the header's, whose static_assert
    holds a CTA's shared memory, forward and backward, to the 232,448 bytes
    a Hopper block may have at the largest instantiated head dim, 128 (the
    header owns the layout and its bytes)."""
    text = open(os.path.join(_build.CSRC_DIR, "attention_f32.cuh")).read()
    for line in ("constexpr int kThreads = 128;",
                 "constexpr int kWarps = kThreads / 32;",
                 f"constexpr int kWarpKeys = {attn.F32_KEY_STEP};",
                 "constexpr int kCtaKeys = kWarps * kWarpKeys;",
                 f"constexpr int kMaxCtas = {attn.F32_MAX_CTAS};",
                 "constexpr int kMaxSmemBytes = 232448;",
                 f"static_assert(bwd_smem_bytes<{attn.HEAD_DIMS[-1]}>() <= "
                 f"kMaxSmemBytes && fwd_smem_bytes<{attn.HEAD_DIMS[-1]}>() <= "
                 "kMaxSmemBytes,"):
        assert line in text, line
    assert attn.F32_CTA_KEYS == 128 // 32 * attn.F32_KEY_STEP
    # the long route's plan: the same CTAs, clusters of up to 16
    assert f"constexpr int kMaxLongCtas = {attn.F32_LONG_MAX_CTAS};" in text
    assert "ctas > kMaxLongCtas" in open(
        os.path.join(_build.CSRC_DIR, "attention_f32.cu")).read()


def _heads(x, H, parts):
    """(B, N, parts * H * Dh) -> ``parts`` tensors (B, H, N, Dh)."""
    B, N, C = x.shape
    return [t.permute(0, 2, 1, 3)
            for t in x.reshape(B, N, parts, H, C // parts // H).unbind(2)]


def _by_warp(x, ranges, keys_per_cta):
    """(..., n) scores over keys -> (..., CTAs, warps, 16), -inf padded: each
    CTA's range padded to ``keys_per_cta``, its warps' 16-key steps."""
    parts = []
    for a, b in ranges:
        pad = keys_per_cta - (b - a)
        part = torch.nn.functional.pad(x[..., a:b], (0, pad), value=-float("inf"))
        parts.append(part.reshape(*x.shape[:-1], keys_per_cta // 16, 16))
    return torch.stack(parts, dim=-3)


def _combine(m_part, sums, dim):
    """The kernel's combine of partial statistics along ``dim``: m = max,
    each sum rescaled by exp(m_part - m) (0 for a part with no keys)."""
    m = m_part.amax(dim=dim, keepdim=True)
    f = torch.exp(m_part - m)
    return m.squeeze(dim), [(s * f).sum(dim=dim) for s in sums]


def _emulate_bwd(qkv, g, H):
    q, k, v = _heads(qkv, H, 3)
    (gh,) = _heads(g, H, 1)
    N, Dh = q.shape[-2:]
    scale = 1.0 / np.sqrt(Dh)
    ranges = attn.f32_key_ranges(N, attn.f32_plan(N)[1])
    keys = attn.F32_CTA_KEYS  # each CTA's 4 warps, those past its range empty
    s = (q @ k.transpose(-1, -2)) * scale
    dp = gh @ v.transpose(-1, -2)
    sw = _by_warp(s, ranges, keys)
    dpw = torch.nan_to_num(_by_warp(dp, ranges, keys), neginf=0.0)
    m_w = sw.amax(-1)                     # per warp; -inf for one without keys
    p = torch.exp(sw - torch.nan_to_num(m_w, neginf=0.0)[..., None])
    l_w, r_w = p.sum(-1), (dpw * p).sum(-1)
    m_c, (l_c, r_c) = _combine(m_w, [l_w, r_w], dim=-1)    # per CTA
    m, (l, ra) = _combine(m_c, [l_c, r_c], dim=-1)         # per head
    r = ra / l
    f = torch.exp(m_w - m[..., None, None]) / l[..., None, None]
    pn = (p * f[..., None]).flatten(-2)  # (..., CTAs, keys_per_cta)
    pn = torch.cat([pn[..., c, :b - a] for c, (a, b) in enumerate(ranges)], -1)
    ds = pn * (dp - r[..., None]) * scale
    dq = torch.zeros_like(q)
    for a, b in ranges:  # the CTAs' partials in rank order
        dq = dq + ds[..., a:b] @ k[..., a:b, :]
    dk = ds.transpose(-1, -2) @ q
    dv = pn.transpose(-1, -2) @ gh
    B, _, C3 = qkv.shape
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, N, C3)


def _emulate_fwd(qkv, H):
    q, k, v = _heads(qkv, H, 3)
    N, Dh = q.shape[-2:]
    scale = 1.0 / np.sqrt(Dh)
    _, ctas = attn.f32_plan(N, backward=False)
    s = (q @ k.transpose(-1, -2)) * scale
    out, m_c, l_c = [], [], []
    for a, b in attn.f32_key_ranges(N, ctas):
        sl = slice(a, b)
        m = s[..., sl].amax(-1, keepdim=True)             # the CTA's row max
        p = torch.exp(s[..., sl] - m)
        out.append(p @ v[..., sl, :])
        m_c.append(m)
        l_c.append(p.sum(-1, keepdim=True))
    m_c, l_c = torch.stack(m_c), torch.stack(l_c)
    m = m_c.amax(0)
    f = torch.exp(m_c - m)
    o = sum(out[c] * f[c] for c in range(ctas)) / (l_c * f).sum(0).clamp_min(1e-30)
    B = qkv.shape[0]
    return o.permute(0, 2, 1, 3).reshape(B, N, -1)


def _qkv_g(B, N, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, N, H * Dh)).astype(np.float32)))


@pytest.mark.parametrize("emulate", ("forward", "backward"))
def test_the_kernels_arithmetic_matches_plain(emulate):
    """257 tokens (5 CTAs: 64, 64, 48, 48 and 33 keys) and 300 (5: 64
    each, the last 44)."""
    for B, N, H, Dh in ((2, 257, 2, 32), (1, 300, 1, 16)):
        qkv, g = _qkv_g(B, N, H, Dh, seed=N)
        if emulate == "forward":
            ours, ref = _emulate_fwd(qkv, H), attn.reference_attention(qkv, H)
        else:
            ours, ref = _emulate_bwd(qkv, g, H), attn.reference_attention_bwd(qkv, g, H)
        torch.testing.assert_close(ours, ref, rtol=0, atol=2e-6)


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    counters = ("F32_LAUNCHES", "F32_BWD_LAUNCHES", "F32_BWD_LONG_LAUNCHES",
                "LAUNCHES", "BWD_LAUNCHES")
    for N in (17, attn.F32_MAX_TOKENS + 1):  # a cluster count and a long one
        qkv, g = _qkv_g(1, N, 1, 16, seed=1)
        before = [getattr(attn, c) for c in counters]
        out = attn.fused_qkv_attention(qkv, 1)
        dqkv = attn.fused_qkv_attention_bwd(qkv, g, 1)
        assert [getattr(attn, c) for c in counters] == before
        assert torch.equal(out, attn.reference_attention(qkv, 1))
        assert torch.equal(dqkv, attn.reference_attention_bwd(qkv, g, 1))
