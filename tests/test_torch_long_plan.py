"""K3's long routes on the CPU: their layout (``ops/attention.long_plan``:
clusters, CTAs and warps per (image, head); ``f32_key_ranges``: each CTA's
keys; ``long_smem_bytes``: a CTA's shared memory) and their arithmetic
emulated in plain PyTorch, held to ``reference_attention_bwd`` and to the
JAX package's kernel. The kernels run on the card only
(``tests/test_torch_long_routes_cuda.py``).

The emulation follows ``csrc/attention_bwd_cluster.cu`` (bf16) and the long
modes of ``csrc/attention_f32.cu`` (f32): each warp's 16 keys give partial
row statistics (max, sum of exp, sum of dP exp), combined by the CTA, then
over the cluster's CTAs in rank order, then (a head split over several
clusters) over the clusters in order, each level rescaled by exp(m_part -
m); pn and dS round to bf16 where the kernel rounds them; the CTAs' dQ
partials add in rank order, the clusters' in cluster order. Tolerances
against plain: bf16 1.6e-2 (one bf16 ulp of values in [2, 4), as the card's
test), f32 2e-6 (sums in another order, as ``tests/test_torch_f32_plan.py``)."""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops.attention import _kernel_attention_bwd
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

NS = {torch.bfloat16: range(attn.BWD_MAX_TOKENS + 1, 2050),
      torch.float32: range(attn.F32_MAX_TOKENS + 1, 2050)}
MOST_CTAS = {torch.bfloat16: attn.LONG_MAX_CTAS, torch.float32: attn.F32_LONG_MAX_CTAS}
ATOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-6}
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plan_covers_the_tokens_within_a_clusters_reach(dtype):
    """The clusters * ctas CTAs' ranges tile [0, N) in whole 16-key steps
    (the last may be short), none empty, none more than its warps hold, a
    cluster's CTAs on consecutive ranges. At most 8 CTAs a cluster in bf16
    (the portable size), 8 warps a CTA; at most 16 in f32 (non-portable), 4
    warps; one cluster a head up to the reach (1,024 tokens either way), the
    fewest clusters past it; the routes hand over at 288 / 289 and 512 /
    513 tokens."""
    reach = {torch.bfloat16: 8 * 8 * 16, torch.float32: 16 * 64}[dtype]
    for n in NS[dtype]:
        clusters, ctas, warps = attn.long_plan(n, dtype)
        ranges = attn.f32_key_ranges(n, clusters * ctas)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a < b for a, b in ranges), (n, ranges)
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
        assert all(a % 16 == 0 for a, _ in ranges)
        assert max(b - a for a, b in ranges) <= 16 * warps, (n, ranges)
        assert 1 <= ctas <= MOST_CTAS[dtype]
        assert 1 <= warps <= (attn.LONG_MAX_WARPS if dtype == torch.bfloat16 else 4)
        assert clusters == -(-n // reach), n
        if dtype == torch.float32:
            assert warps == 4 and attn.f32_plan(n) == ("f32_long", ctas)
    assert attn.long_plan(577) == (1, 5, 8)
    assert attn.long_plan(1024) == (1, 8, 8)
    assert attn.long_plan(1025) == (2, 5, 8)
    assert attn.long_plan(577, torch.float32) == (1, 10, 4)
    assert attn.long_plan(1025, torch.float32) == (2, 9, 4)
    assert [attn.bwd_route(n) for n in (288, 289)] == ["short", "long"]
    assert [attn.bwd_route(n, torch.float32) for n in (512, 513)] == ["f32", "f32_long"]


def test_shared_memory_fits_and_matches_the_sources():
    """Every long plan from 289 (bf16) or 513 (f32) to 2,049 tokens fits the
    232,448 bytes a Hopper block may have at every instantiated head dim (16,
    32, 64, 80 and 128); the Python mirror is the kernels' formula (the
    sources' static_asserts, at the largest head dim, and their stated
    sizes)."""
    for dtype in DTYPES:
        for n in NS[dtype]:
            for dh in attn.HEAD_DIMS:
                warps = attn.long_plan(n, dtype, dh)[2]
                assert attn.long_smem_bytes(dh, warps, dtype) <= 232448, (n, dh)
    src = open(os.path.join(_build.CSRC_DIR, "attention_bwd_cluster.cu")).read()
    assert "static_assert(smem_bytes<128>(kMaxWarps) <= cvt_f32::kMaxSmemBytes," in src
    assert "76,544 bytes at Dh = 64 and 5 warps" in src and "99,584 at 8 warps" in src
    assert attn.long_smem_bytes(64, 5, torch.bfloat16) == 76544
    assert attn.long_smem_bytes(64, 8, torch.bfloat16) == 99584
    for line in (f"constexpr int kMaxWarps = {attn.LONG_MAX_WARPS};",
                 f"constexpr int kMaxCtas = {attn.LONG_MAX_CTAS};",
                 "constexpr int kWarpKeys = 16;"):
        assert line in src, line
    header = open(os.path.join(_build.CSRC_DIR, "attention_f32.cuh")).read()
    assert f"constexpr int kMaxLongCtas = {attn.F32_LONG_MAX_CTAS};" in header
    assert "111 KB at Dh = 64" in header
    assert attn.long_smem_bytes(64, 4, torch.float32) == 111104


def _heads(x, H, parts):
    B, N, C = x.shape
    return [t.permute(0, 2, 1, 3).float()
            for t in x.reshape(B, N, parts, H, C // parts // H).unbind(2)]


def _combine(m_part, sums, dim, base):
    """m = max over ``dim``; each sum rescaled by base^(m_part - m) (0 for
    a part without keys), added over ``dim``."""
    m = m_part.amax(dim=dim, keepdim=True)
    f = torch.pow(base, m_part - m)
    return m.squeeze(dim), [(s * f).sum(dim=dim) for s in sums]


def _partial_stats(s, dp, ranges, warps, base, log_scale):
    """Per CTA (..., CTAs) the statistics of its range: the warps' (max,
    sum of exp, sum of dP exp) over their 16 keys, combined in the CTA."""
    keys = 16 * warps
    parts_s, parts_dp = [], []
    for a, b in ranges:
        pad = keys - (b - a)
        parts_s.append(torch.nn.functional.pad(s[..., a:b], (0, pad), value=-math.inf))
        parts_dp.append(torch.nn.functional.pad(dp[..., a:b], (0, pad)))
    sw = torch.stack(parts_s, -2).unflatten(-1, (warps, 16))   # (..., CTAs, warps, 16)
    dpw = torch.stack(parts_dp, -2).unflatten(-1, (warps, 16))
    m_w = sw.amax(-1)
    p = torch.pow(base, (sw - torch.nan_to_num(m_w, neginf=0.0)[..., None]) * log_scale)
    return _combine(m_w, [p.sum(-1), (dpw * p).sum(-1)], -1, base ** log_scale)


def _emulate_long(qkv, g, H, plan=None):
    """The long route of qkv's dtype on ``plan`` (clusters, ctas, warps;
    ``long_plan``'s by default), step by step."""
    bf16 = qkv.dtype == torch.bfloat16
    q, k, v = _heads(qkv, H, 3)
    (gh,) = _heads(g, H, 1)
    N, Dh = q.shape[-2:]
    scale = 1.0 / math.sqrt(Dh)
    clusters, ctas, warps = plan or attn.long_plan(N, qkv.dtype)
    ranges = attn.f32_key_ranges(N, clusters * ctas)
    s = q @ k.transpose(-1, -2)
    if not bf16:  # the f32 kernel scales the scores, then takes exp
        s = s * scale
    dp = gh @ v.transpose(-1, -2)
    # bf16: exp2 with scale * log2(e) folded, on raw scores
    base, log_scale = (2.0, scale / math.log(2.0)) if bf16 else (math.e, 1.0)
    m_c, (l_c, r_c) = _partial_stats(s, dp, ranges, warps, base, log_scale)
    m_c, l_c, r_c = (x.unflatten(-1, (clusters, ctas)) for x in (m_c, l_c, r_c))
    m_g, (l_g, r_g) = _combine(m_c, [l_c, r_c], -1, base ** log_scale)  # rank order
    m, (l, ra) = _combine(m_g, [l_g, r_g], -1, base ** log_scale)      # cluster order
    pn = torch.pow(base, (s - m[..., None]) * log_scale) / l[..., None]
    ds = pn * (dp - (ra / l)[..., None]) * scale
    if bf16:
        ds = ds.bfloat16().float()
    dq = torch.zeros_like(q)
    for c in range(clusters):  # each cluster's CTAs in rank order, then clusters
        part = torch.zeros_like(q)
        for a, b in ranges[c * ctas:(c + 1) * ctas]:
            part = part + ds[..., a:b] @ k[..., a:b, :]
        dq = dq + part
    dk = ds.transpose(-1, -2) @ q
    dv = (pn.bfloat16().float() if bf16 else pn).transpose(-1, -2) @ gh
    B, _, C3 = qkv.shape
    out = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, N, C3)
    return out.to(qkv.dtype)


def _qkv_g(B, N, H, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32)).to(dtype),
            torch.from_numpy(rng.normal(size=(B, N, H * Dh)).astype(np.float32)).to(dtype))


@pytest.mark.parametrize("dtype,n,plan", [
    (torch.bfloat16, 289, None), (torch.bfloat16, 577, None),
    (torch.bfloat16, 1025, None), (torch.float32, 577, None),
    (torch.float32, 1025, None), (torch.bfloat16, 577, (3, 4, 4))],
    ids=("bf16_289", "bf16_577", "bf16_1025_split", "f32_577", "f32_1025_split",
         "bf16_577_three_clusters"))
def test_the_kernels_arithmetic_matches_plain(dtype, n, plan):
    """One cluster, and a head split over 2 or 3 clusters (the statistics
    pass's partials combined in cluster order, the dQ partials summed)."""
    qkv, g = _qkv_g(1, n, 2, 16, dtype, seed=n)
    ours = _emulate_long(qkv, g, 2, plan)
    ref = attn.reference_attention_bwd(qkv, g, 2)
    torch.testing.assert_close(ours.float(), ref.float(), rtol=0, atol=ATOL[dtype])


def test_bf16_routes_agree_across_288_and_289_tokens():
    """At 288 tokens (the short route's last) and 289 (the long route's
    first), plain (which the CPU runs on either route) and the long route's
    emulated arithmetic are both within one bf16 ulp of the JAX kernel
    (interpret mode), which rounds pn and dS at the same two points."""
    for n in (288, 289):
        qkv, g = _qkv_g(1, n, 2, 32, torch.bfloat16, seed=3)
        jax_out = np.asarray(_kernel_attention_bwd(
            jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
            jnp.asarray(g.float().numpy(), jnp.bfloat16), 2, interpret=True), np.float32)
        plain = attn.reference_attention_bwd(qkv, g, 2).float().numpy()
        long_route = _emulate_long(qkv, g, 2, attn.long_plan(n)).float().numpy()
        np.testing.assert_allclose(plain, jax_out, atol=1.6e-2, rtol=0)
        np.testing.assert_allclose(long_route, jax_out, atol=1.6e-2, rtol=0)
    assert re.search(r"exp2f\(fmaf\(s\[h\]\[e\], c\.scale_log2, -c\.fin\[r\]\)\)",
                     open(os.path.join(_build.CSRC_DIR, "attention_bwd_cluster.cu")).read())
