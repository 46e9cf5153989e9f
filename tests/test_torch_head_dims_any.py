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


def _p(s, sh, scale, c, bf16):
    """The kernel's exponential of scores s against a row's shift sh: bf16
    exp2f(fmaf(s, c, -sh)) (the fmaf exact, then one f32 rounding), f32
    expf(fl(s scale) - m)."""
    if bf16:
        return torch.exp2((s.double() * float(c) - sh.double()).float())
    return torch.exp(s * scale - sh)


def emulate_any(qkv: torch.Tensor, g: torch.Tensor, heads: int):
    """``csrc/attention_any.cu`` in torch, tile by tile: 64-row tiles of
    queries and of keys (the last one ragged, its rows zero and masked), the
    output's columns in ``any_plan``'s chunks; the forward's row shift from
    a first pass, p (rounded in bf16, the row sum adding the rounded p), P V
    divided by the row sum floored at 1e-30; the backward's statistics
    (shift, l, r = rowsum(dP pn)) into a scratch, then dQ by query tiles and
    dK, dV by key tiles against it, dS = pn (dP - r) scale rounded as the
    input. Scores in f32 (the kernel's slices of 16 columns sum in another
    order). Returns (out, dqkv) in the input dtype."""
    bf16 = qkv.dtype == torch.bfloat16
    B, N, C3 = qkv.shape
    D = C3 // 3
    dh = D // heads
    chunks, cols = attn.any_plan(dh)
    T = attn.ANY_TILE
    NP = -(-N // T) * T
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    c = np.float32(scale) * LOG2E
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    x = torch.zeros((B, NP, 3, heads, dh))
    x[:, :N] = qkv.float().reshape(B, N, 3, heads, dh)
    gp = torch.zeros((B, NP, heads, dh))
    gp[:, :N] = g.float().reshape(B, N, heads, dh)
    key_ok = torch.arange(NP) < N
    out = torch.zeros((B, NP, heads, dh))
    dqkv = torch.zeros((B, NP, 3, heads, dh))
    for b in range(B):
        for h in range(heads):
            q, k, v = x[b, :, 0, h], x[b, :, 1, h], x[b, :, 2, h]
            gh = gp[b, :, h]
            stats = torch.zeros((3, NP))
            for r0 in range(0, NP, T):  # a query tile: the forward, the statistics
                s = q[r0:r0 + T] @ k.T
                dp = gh[r0:r0 + T] @ v.T
                ss = s if bf16 else s * scale
                m = ss.masked_fill(~key_ok, -math.inf).amax(-1, keepdim=True)
                sh = (m * float(c)).float() if bf16 else m
                p = _p(s, sh, scale, c, bf16) * key_ok
                pr = rnd(p)
                for c0 in range(0, chunks * cols, cols):
                    o = pr @ v[:, c0:c0 + cols]
                    out[b, r0:r0 + T, h, c0:c0 + cols] = o / pr.sum(
                        -1, keepdim=True).clamp_min(1e-30)
                l = p.sum(-1, keepdim=True)
                pn = p / l
                r = (dp * pn).sum(-1, keepdim=True)
                stats[:, r0:r0 + T] = torch.cat([sh, l, r], 1).T
            sh, l, r = (t[:, None] for t in stats)
            s, dp = q @ k.T, gh @ v.T
            pn = _p(s, sh, scale, c, bf16) / l * key_ok
            ds = rnd((pn * (dp - r)) * scale) * key_ok
            pn = pn * key_ok[:, None]
            ds = ds * key_ok[:, None]
            for t0 in range(0, NP, T):  # dQ by query tiles, dK and dV by key tiles
                for c0 in range(0, chunks * cols, cols):
                    dqkv[b, t0:t0 + T, 0, h, c0:c0 + cols] = (
                        ds[t0:t0 + T] @ k[:, c0:c0 + cols])
                    dqkv[b, t0:t0 + T, 1, h, c0:c0 + cols] = (
                        ds[:, t0:t0 + T].T @ q[:, c0:c0 + cols])
                    dqkv[b, t0:t0 + T, 2, h, c0:c0 + cols] = (
                        rnd(pn[:, t0:t0 + T]).T @ gh[:, c0:c0 + cols])
    return (out[:, :N].reshape(B, N, D).to(qkv.dtype),
            dqkv[:, :N].reshape(B, N, C3).to(qkv.dtype))


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_kernel_arithmetic_matches_the_jax_kernel(dtype):
    """The any-head-dim kernel's tiles, chunks, masks and rounding points
    (``emulate_any``) at 70 tokens (a ragged second tile) and head dims 12
    (one chunk of 16 columns) and 136 (two chunks of 128, the second ragged)
    against the JAX package's kernels and the port's plain versions."""
    for B, N, H, Dh in ((2, 70, 3, 12), (1, 70, 2, 136)):
        qkv, g = _inputs(B, N, H, Dh, seed=7 * Dh)
        (tq, jq), (tg, jg) = _cast(qkv, dtype), _cast(g, dtype)
        out, dqkv = emulate_any(tq, tg, H)
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
    """``any_plan`` and ``any_smem_bytes`` against the constants of
    ``csrc/attention_any.cu``: 64-row tiles, 16-column slices, chunks of at
    most 128 columns (16, 32, 64 or 128 by ``any_cols``), every kernel's
    shared memory within a Hopper block's, the two figures its comment
    gives; both entries bound with as many arguments as they take."""
    src = _source("attention_any.cu")
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kTile"], const["kSlice"], const["kMaxCols"]) == (
        attn.ANY_TILE, attn.ANY_SLICE, attn.ANY_MAX_COLS)
    assert "constexpr int kLdT = kTile + 4;" in src
    assert attn._ANY_LD == attn.ANY_TILE + 4
    assert "return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : kMaxCols;" in src
    assert "return 4 * (kSliceFloats + tiles * (kTile * kLdT + kTile * cols));" in src
    assert "constexpr int kSliceFloats = 2 * kSlice * kLdT;" in src
    plans = {dh: attn.any_plan(dh) for dh in
             (1, 3, 12, 16, 17, 20, 36, 100, 128, 136, 192, 256, 384, 768)}
    assert plans == {1: (1, 16), 3: (1, 16), 12: (1, 16), 16: (1, 16),
                     17: (1, 32), 20: (1, 32), 36: (1, 64), 100: (1, 128),
                     128: (1, 128), 136: (2, 128), 192: (2, 128),
                     256: (2, 128), 384: (3, 128), 768: (6, 128)}
    for dh, (chunks, cols) in plans.items():
        assert (chunks - 1) * cols < dh <= chunks * cols
        for backward in (False, True):
            assert attn.any_smem_bytes(dh, backward) <= SMEM_LIMIT
    assert (attn.any_smem_bytes(256, False), attn.any_smem_bytes(256, True)) == (
        58880, 109056)
    assert "at 128 columns 58,880 and 109,056" in src
    # two CTAs of 256 threads an SM (128 registers a thread), every kernel
    assert src.count("__launch_bounds__(kThreads, 2)") == 4
    assert _build._SIGNATURES["cvt_attention_fwd_any"][-2:] == [
        _build.ctypes.c_float, _build.ctypes.c_void_p]
    assert len(_build._SIGNATURES["cvt_attention_bwd_any"]) == 11


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
    for dh in (1, 3, 12, 20, 36, 100, 136, 192, 256, 384, 768):
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
