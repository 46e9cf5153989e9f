"""K2 and K3 at head dims that the instantiated kernels do not take: not a
multiple of 8 (3, 12, 20) and above 128 (136, 256, 384), on the CPU. The
port's plain versions (``reference_attention``, ``reference_attention_bwd``,
which a CPU tensor runs) against the JAX package's Pallas kernels in
interpret mode; the arithmetic of ``csrc/attention_any.cu``, which runs
those head dims on the card, emulated tile by tile against the same JAX
kernels; tiny ChessViTs on 2 heads of 136 and on 4 heads of 12 against the
JAX model through the weight bridge; and the kernel's plan (output chunks,
shared memory) and the route by head dim and alignment pinned to the
constants of its source. The kernels themselves run on the card
(``tests/test_torch_head_dims_any_cuda.py``).

Tolerances: as at head dim 64 (tests/test_torch_head_dims.py): the forward
1e-5 in f32 and 2e-2 in bf16 (the JAX package's bound for its own kernel);
the backward 1e-5 in f32 and 1.6e-2 in bf16 (one bf16 ulp of values in
[2, 4): pn and dS round to bf16 at the same points on both sides); the model
1e-4 in f32, as tests/test_torch_model.py."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.ops.attention import _kernel_attention, _kernel_attention_bwd
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

# (images, tokens, heads, head dim): 17 tokens, one ragged tile of rows
SHAPES = [(2, 17, 2, 3), (1, 17, 4, 12), (1, 17, 3, 20), (1, 17, 2, 136),
          (1, 17, 3, 256), (1, 17, 1, 384)]
FWD_ATOL = {"f32": 1e-5, "bf16": 2e-2}
BWD_ATOL = {"f32": 1e-5, "bf16": 1.6e-2}
SMEM_LIMIT = 232448
LOG2E = np.float32(1.4426950408889634)


def _inputs(B, N, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32),
            rng.normal(size=(B, N, H * Dh)).astype(np.float32))


def _cast(x: np.ndarray, dtype: str):
    if dtype == "f32":
        return torch.from_numpy(x), jnp.asarray(x)
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


def _jax_kernels(jq, jg, H):
    out = np.asarray(_kernel_attention(jq, H, interpret=True), np.float32)
    dqkv = np.asarray(_kernel_attention_bwd(jq, jg, H, interpret=True), np.float32)
    return out, dqkv


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_plain_forward_matches_the_jax_kernel(dtype):
    for B, N, H, Dh in SHAPES:
        qkv, _ = _inputs(B, N, H, Dh, seed=Dh)
        tq, jq = _cast(qkv, dtype)
        ours = attn.fused_qkv_attention(tq, H).float().numpy()
        kernel = np.asarray(_kernel_attention(jq, H, interpret=True), np.float32)
        np.testing.assert_allclose(ours, kernel, atol=FWD_ATOL[dtype],
                                   err_msg=f"{B, N, H, Dh}")


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_plain_backward_matches_the_jax_kernel(dtype):
    for B, N, H, Dh in SHAPES:
        qkv, g = _inputs(B, N, H, Dh, seed=Dh + 1)
        (tq, jq), (tg, jg) = _cast(qkv, dtype), _cast(g, dtype)
        ours = attn.fused_qkv_attention_bwd(tq, tg, H).float().numpy()
        kernel = np.asarray(_kernel_attention_bwd(jq, jg, H, interpret=True),
                            np.float32)
        np.testing.assert_allclose(ours, kernel, atol=BWD_ATOL[dtype],
                                   err_msg=f"{B, N, H, Dh}")


def _p(v, sh, c, bf16):
    """The kernels' exponential of a score v (raw in bf16, fl(s scale) in
    f32) against a row's shift sh: bf16 exp2f(fmaf(v, c, -sh)) (the fmaf
    exact, then one f32 rounding), f32 expf(v - sh)."""
    if bf16:
        return torch.exp2((v.double() * float(c) - sh.double()).float())
    return torch.exp(v - sh)


def stage_keys(dh: int, dtype: torch.dtype) -> int:
    """The forward's keys a ring stage at head dim ``dh`` (``fwd_keys`` of
    ``csrc/attention_any.cuh`` at ``any_cols``): the online max's step."""
    cols = attn.any_cols(dh)
    if dtype == torch.bfloat16:
        return 64 if cols <= 128 else 32
    return 64 if cols <= 64 else 32 if cols == 128 else 16


def tile_rows(dh: int, dtype: torch.dtype) -> int:
    """The backward's query rows a tile (``bwd_rows`` at ``any_cols``)."""
    cols = attn.any_cols(dh)
    if dtype == torch.float32:
        return 64 if cols <= 64 else 16
    return 128 if cols <= 16 else 64 if cols <= 64 else 32


def _scores(a, b):
    """a b^T summed over the depth's windows of 256 columns in order (one
    window up to a head dim of 256)."""
    return sum(a[:, w:w + 256] @ b[:, w:w + 256].T for w in range(0, a.shape[1], 256))


def _factor(m_part, m, c, bf16):
    """exp(m_part - m) in score units: bf16 exp2f((m_part - m) c)."""
    return torch.exp2((m_part - m) * float(c)) if bf16 else torch.exp(m_part - m)


def _combine(parts, c, bf16):
    """Row statistics (m, l, ra) taken over parts of the keys, combined in
    order (key blocks in a CTA, CTAs in a cluster by rank, clusters): the
    max, then each part's sums brought to it; a part without keys (m =
    -inf) adds nothing."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l, ra = torch.zeros_like(m), torch.zeros_like(m)
    for mp, lp, rp in parts:
        f = torch.where(mp == -math.inf, 0.0, _factor(mp, m, c, bf16))
        l, ra = lp * f + l, rp * f + ra
    return m, l, ra


def emulate_any(qkv: torch.Tensor, g: torch.Tensor, heads: int, plan=None):
    """``csrc/attention_any.cu`` and ``attention_any_bwd.cu`` in torch, tile
    by tile, S and dP summed over the depth's windows of 256 in order.
    Forward: the keys in ring stages of ``stage_keys``, the last one ragged, the online max rescaled once a stage, p (rounded in
    bf16, the row sum adding the rounded p), P V over the whole head dim,
    divided by the row sum floored at 1e-30. Backward on ``any_bwd_plan``'s
    (clusters, ctas, keys), or ``plan``: each CTA's keys from
    ``f32_key_ranges``, the row statistics over each 16-key block, combined
    over a CTA's blocks, the cluster's CTAs in rank order and the clusters
    in order; pn = p / l, r = ra / l, dS = pn (dP - r) scale rounded as the
    input; dK and dV by each CTA over the query tiles of ``tile_rows``
    rows in order, dQ as each CTA's partial added in rank order, then the
    clusters'. Products in f32 (the kernels sum in another order). Returns
    (out, dqkv) in the input dtype."""
    bf16 = qkv.dtype == torch.bfloat16
    B, N, C3 = qkv.shape
    D = C3 // 3
    dh = D // heads
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    c = np.float32(scale) * LOG2E
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    score = (lambda s: s) if bf16 else (lambda s: s * scale)
    shift = (lambda m: (m * float(c)).float()) if bf16 else (lambda m: m)
    keys_a_stage = stage_keys(dh, qkv.dtype)
    clusters, ctas, _ = plan or attn.any_bwd_plan(N, dh)
    rows = tile_rows(dh, qkv.dtype)
    ranges = [(a, max(a, e)) for a, e in attn.f32_key_ranges(N, clusters * ctas)]
    x = qkv.float().reshape(B, N, 3, heads, dh)
    gx = g.float().reshape(B, N, heads, dh)
    out = torch.zeros((B, N, heads, dh))
    dqkv = torch.zeros((B, N, 3, heads, dh))
    for b in range(B):
        for h in range(heads):
            q, k, v = x[b, :, 0, h], x[b, :, 1, h], x[b, :, 2, h]
            gh = gx[b, :, h]
            m = torch.full((N, 1), -math.inf)
            l, o = torch.zeros((N, 1)), torch.zeros((N, dh))
            for k0 in range(0, N, keys_a_stage):
                vs = score(_scores(q, k[k0:k0 + keys_a_stage]))
                mx = torch.maximum(m, vs.amax(-1, keepdim=True))
                alpha = _factor(m, mx, c, bf16)
                p = rnd(_p(vs, shift(mx), c, bf16))
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + p @ v[k0:k0 + keys_a_stage]
                m = mx
            out[b, :, h] = o / l.clamp_min(1e-30)

            s, dp = score(_scores(q, k)), _scores(gh, v)
            per_cluster = []
            for cl in range(clusters):
                per_cta = []
                for a, e in ranges[cl * ctas:(cl + 1) * ctas]:
                    blocks = []
                    for k0 in range(a, e, 16):
                        sb, db = s[:, k0:min(k0 + 16, e)], dp[:, k0:min(k0 + 16, e)]
                        mb = sb.amax(-1, keepdim=True)
                        pb = _p(sb, shift(mb), c, bf16)
                        blocks.append((mb, pb.sum(-1, keepdim=True),
                                       (db * pb).sum(-1, keepdim=True)))
                    zeros = torch.zeros((N, 1))
                    per_cta.append(_combine(blocks, c, bf16) if blocks
                                   else (zeros - math.inf, zeros, zeros))
                per_cluster.append(_combine(per_cta, c, bf16))
            m, l, ra = _combine(per_cluster, c, bf16)
            inv = 1.0 / l
            r = ra * inv
            pn = _p(s, shift(m), c, bf16) * inv
            ds = rnd(pn * (dp - r) * scale)
            pr = rnd(pn)
            dq = torch.zeros((N, dh))
            for cl in range(clusters):
                part = torch.zeros((N, dh))
                for a, e in ranges[cl * ctas:(cl + 1) * ctas]:
                    part = part + ds[:, a:e] @ k[a:e]
                    dk, dv = torch.zeros((e - a, dh)), torch.zeros((e - a, dh))
                    for r0 in range(0, N, rows):
                        dk = dk + ds[r0:r0 + rows, a:e].T @ q[r0:r0 + rows]
                        dv = dv + pr[r0:r0 + rows, a:e].T @ gh[r0:r0 + rows]
                    dqkv[b, a:e, 1, h], dqkv[b, a:e, 2, h] = dk, dv
                dq = dq + part
            dqkv[b, :, 0, h] = dq
    return (out.reshape(B, N, D).to(qkv.dtype),
            dqkv.reshape(B, N, C3).to(qkv.dtype))


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_kernel_arithmetic_matches_the_jax_kernel(dtype):
    """The any-head-dim kernels' tiles, online max, masks, statistics and
    rounding points (``emulate_any``) at 70 tokens (a ragged last stage and
    tile) and head dims 12 (16 columns; also on a plan of two clusters of
    two CTAs, the split's combine) and 136 (256 columns, two CTAs) against
    the JAX package's kernels and the port's plain versions."""
    for B, N, H, Dh, plan in ((2, 70, 3, 12, None), (2, 70, 3, 12, (2, 2, 32)),
                              (1, 70, 2, 136, None)):
        qkv, g = _inputs(B, N, H, Dh, seed=7 * Dh)
        (tq, jq), (tg, jg) = _cast(qkv, dtype), _cast(g, dtype)
        out, dqkv = emulate_any(tq, tg, H, plan)
        kernel, dkernel = _jax_kernels(jq, jg, H)
        np.testing.assert_allclose(out.float().numpy(), kernel,
                                   atol=FWD_ATOL[dtype], err_msg=f"{Dh} forward")
        np.testing.assert_allclose(dqkv.float().numpy(), dkernel,
                                   atol=BWD_ATOL[dtype], err_msg=f"{Dh} backward")
        plain = attn.reference_attention_bwd(tq, tg, H).float()
        torch.testing.assert_close(dqkv.float(), plain, rtol=0,
                                   atol=BWD_ATOL[dtype])


@pytest.mark.parametrize("heads,embed", ((2, 272), (4, 48)), ids=("136", "12"))
def test_vit_matches_jax(heads, embed):
    """ChessViT with 2 heads of 136 (above 128) and with 4 heads of 12 (not
    a multiple of 8), depth 2, at 64 px in f32: the JAX model and the port
    on the same weights."""
    cfg = {"model": {"arch": "vit", "input_size": 64, "embed_dim": embed,
                     "depth": 2, "num_heads": heads},
           "training": {"mixed_precision": False}}
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, 64, seed=5)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), cfg))
    assert model.backbone.blocks[0].attn.num_heads == heads
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for k in ("squares", "turn", "castling"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def _source(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def test_any_plan_is_the_source():
    """``any_plan`` and ``any_bwd_plan`` against the constants of
    ``csrc/attention_any.cuh``: one CTA over all output columns up to 256
    (16, 32, 64, 128 or 256 by ``any_cols``), chunks of 256 above, the
    tiles then holding the depth 256 columns at a time (``any_window``);
    clusters of up to 16 CTAs of at most 128 keys, 64 at 256 columns; every
    CTA's shared memory within a Hopper block's at every head dim (the
    header's static_assert) and the two figures its comment gives; both
    entries bound with as many arguments as they take."""
    src = _source("attention_any.cuh")
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kMaxCols"], const["kMaxCtas"], const["kSmemLimit"]) == (
        attn.ANY_MAX_COLS, attn.ANY_MAX_CTAS, SMEM_LIMIT)
    assert ("return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : kMaxCols;"
            in src)
    assert "constexpr int any_window(int depth) { return depth < kMaxCols ? depth : kMaxCols; }" \
        in src
    assert "constexpr int bwd_max_keys(int dp) { return dp >= 256 ? 64 : 128; }" in src
    assert 'static_assert(every_plan_fits(2) && every_plan_fits(4), "a CTA' in src
    plans = {dh: attn.any_plan(dh) for dh in
             (1, 3, 12, 16, 17, 20, 36, 100, 128, 136, 192, 256, 257, 384, 768, 1100)}
    assert plans == {1: (1, 16), 3: (1, 16), 12: (1, 16), 16: (1, 16),
                     17: (1, 32), 20: (1, 32), 36: (1, 64), 100: (1, 128),
                     128: (1, 128), 136: (1, 256), 192: (1, 256),
                     256: (1, 256), 257: (2, 256), 384: (2, 256), 768: (3, 256),
                     1100: (5, 256)}
    for dh, (chunks, cols) in plans.items():
        assert (chunks - 1) * cols < dh <= chunks * cols
    assert "163,968 bytes in bf16 at 256\n// columns and 64 keys with one set, 214,400 with two" in src
    assert "bwd_smem_bytes(4, 256, 256, 64, 1) == 211136" in src
    assert attn.any_bwd_plan(257, 256) == (1, 5, 64)
    assert attn.any_bwd_plan(257, 12) == (1, 3, 96)
    assert attn.any_bwd_plan(257, 1100) == (1, 5, 64)
    assert _build._SIGNATURES["cvt_attention_fwd_any"][-2:] == [
        _build.ctypes.c_float, _build.ctypes.c_void_p]
    assert len(_build._SIGNATURES["cvt_attention_bwd_any"]) == 15


def test_route_by_head_dim_and_alignment():
    """The instantiated kernels keep the multiples of 8 up to 128 at a
    16-byte aligned qkv; every other head dim from 1, and those at another
    address, take the any-head-dim kernels, in either dtype and at every
    token count (the bf16 and f32 routes of the instantiated kernels do not
    apply to them); a head dim below 1 raises."""
    bf16, f32 = torch.bfloat16, torch.float32
    for dh in range(1, 800):
        flash = dh % 8 == 0 and dh <= 128
        assert attn.head_dim_route(dh) == ("flash" if flash else "any"), dh
        assert attn.head_dim_route(dh, aligned=False) == "any"
        assert bool(attn.kernel_head_dim(dh)) == flash
    for dh in (1, 3, 12, 20, 36, 100, 136, 192, 256, 384, 768, 1100):
        for dtype in (bf16, f32):
            assert {attn.bwd_route(n, dtype, dh) for n in (1, 17, 257, 577, 1100)} \
                == {"any"}
    assert attn.bwd_route(257, bf16, 64, aligned=False) == "any"
    assert attn.bwd_route(257, bf16, 64) == "short"
    assert attn.bwd_route(257, f32, 128) == "f32"
    for dh in (0, -8):
        with pytest.raises(ValueError, match=f"head dim {dh} is below 1"):
            attn.head_dim_route(dh)
    # the int8 kernels keep their head dims (the JAX int8 path's)
    assert attn.QUANT_HEAD_DIMS == (16, 32, 64)
