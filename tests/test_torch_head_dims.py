"""K2 and K3 at head dims other than 16, 32 and 64, on the CPU: the port's
plain versions (``reference_attention``, ``reference_attention_bwd``, which
a CPU tensor runs) at head dims 80 (ViT-Huge's) and 128 against the JAX
package's Pallas kernels in interpret mode, a tiny ChessViT with 2 heads of
80 against the JAX model through the weight bridge, and the layout the
kernels take at head dims 48, 80 and 128 (the instantiation, the backward's
route, the long routes' plans and their shared memory) pinned to the
constants of the CUDA sources. The kernels themselves run on the card
(``tests/test_torch_head_dims_cuda.py``).

Tolerances: as at head dim 64 (tests/test_torch_attention.py,
tests/test_torch_attention_bwd.py): the forward 1e-5 in f32 and 2e-2 in
bf16 (the JAX package's bound for its own kernel); the backward 1e-5 in f32
and 1.6e-2 in bf16 (one bf16 ulp of values in [2, 4): pn and dS round to
bf16 at the same points on both sides); the model 1e-4 in f32, as
tests/test_torch_model.py."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

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

# (images, tokens, heads, head dim): 17 (one ragged 16-row block past the
# first), 40 tokens
SHAPES = [(2, 17, 2, 80), (1, 40, 2, 128)]
FWD_ATOL = {"f32": 1e-5, "bf16": 2e-2}
BWD_ATOL = {"f32": 1e-5, "bf16": 1.6e-2}
SMEM_LIMIT = 232448


def _inputs(B, N, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3 * H * Dh)).astype(np.float32),
            rng.normal(size=(B, N, H * Dh)).astype(np.float32))


def _cast(x: np.ndarray, dtype: str):
    if dtype == "f32":
        return torch.from_numpy(x), jnp.asarray(x)
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


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


def test_vit_with_heads_of_80_matches_jax():
    """ChessViT with ViT-Huge's head dim (embed 160, 2 heads of 80, depth 2)
    at 64 px in f32: the JAX model and the port on the same weights."""
    cfg = {"model": {"arch": "vit", "input_size": 64, "embed_dim": 160,
                     "depth": 2, "num_heads": 2},
           "training": {"mixed_precision": False}}
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, 64, seed=3)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), cfg))
    assert model.backbone.blocks[0].attn.num_heads == 2
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for k in ("squares", "turn", "castling"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def _source(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def test_instantiations_are_the_sources():
    """``HEAD_DIMS`` is ``cvt::flash_head_dim``'s set, and every entry of
    K2 and K3 switches on all of it; the bf16 backward's short route takes up
    to 64 (its entry refuses more); the quantizing kernels keep 16, 32, 64."""
    loop = _source("attention_loop.cuh")
    body = loop[loop.index("constexpr int flash_head_dim"):]
    body = body[:body.index(";")]
    pairs = re.findall(r"dh <= (\d+)\s+\? (\d+)", body)
    assert [int(a) for a, b in pairs] == [int(b) for a, b in pairs]
    assert (*[int(a) for a, _ in pairs], int(re.findall(r": (\d+)$", body)[0])) \
        == attn.HEAD_DIMS
    assert "dh < 8 || dh > 128 || dh % 8 ? 0" in body
    for name in ("attention.cu", "attention_bwd_cluster.cu", "attention_f32.cu"):
        src = _source(name)
        for d in attn.HEAD_DIMS:
            assert f"case {d}:" in src, (name, d)
        assert "flash_head_dim(" in src, name
    short = _source("attention_bwd.cu")
    assert (f"if (dh < 8 || dh > {attn.BWD_SHORT_MAX_HEAD_DIM} || dh % 8) "
            "return (int)cudaErrorInvalidValue;") in short
    assert f"constexpr int kMaxN = 16 * kBlocksPerWarp * kWarps;  // {attn.BWD_MAX_TOKENS}" in short
    assert attn.QUANT_HEAD_DIMS == (16, 32, 64)
    assert "case 80:" not in _source("attention_quant.cu")


def test_head_dims_routes_and_plans():
    """Each multiple of 8 from 8 to 128 runs the smallest instantiation
    that holds it; another head dim from 1 takes ``csrc/attention_any.cu``
    (``head_dim_route`` "any", forward and backward at every count, either
    dtype); only a head dim below 1 raises, naming it. At 48 the bf16 backward keeps
    its short route up to 288 tokens; above 64 it takes the cluster route at
    every count, whose CTAs (8 warps) fit one an SM; f32 above 64 keeps to
    clusters of the portable 8 CTAs, so 577 tokens split over 2 clusters of
    5 (64 there: 1 of 10)."""
    for dh in range(8, 129, 8):
        assert attn.kernel_head_dim(dh) == min(d for d in attn.HEAD_DIMS if d >= dh)
    bf16, f32 = torch.bfloat16, torch.float32
    for dh in (4, 12, 100, 136, 256):
        assert attn.kernel_head_dim(dh) == 0
        assert attn.head_dim_route(dh) == "any"
        for dtype in (bf16, f32):
            assert {attn.bwd_route(n, dtype, dh) for n in (17, 257, 577, 1100)} \
                == {"any"}
    with pytest.raises(ValueError, match="head dim 0 "):
        attn.kernel_head_dim(0)
    assert [attn.bwd_route(n, bf16, 48) for n in (17, 288, 289)] == [
        "short", "short", "long"]
    for dh in (72, 80, 96, 128):
        assert {attn.bwd_route(n, bf16, dh) for n in (17, 257, 288)} == {"long"}
        assert attn.long_plan(257, bf16, dh) == (1, 3, 8)
        assert attn.long_plan(577, bf16, dh) == (1, 5, 8)
        assert attn.long_plan(1100, bf16, dh) == (2, 5, 8)
        assert attn.long_plan(577, f32, dh) == (2, 5, 4)
        assert attn.f32_plan(577, True, dh) == ("f32_long", 5)
        assert attn.f32_plan(257, True, dh) == ("f32", 5)
    assert attn.long_plan(577, f32, 48) == (1, 10, 4)
    # shared memory: the short route at its largest (288 tokens, 64), and
    # what would not fit (257 tokens at 80: the four tiles alone 191,488)
    short = lambda n, dh: 2 * (-(-n // 16) * 16) * (4 * (dh + 8) + 2 * 40)  # noqa: E731
    assert short(288, 64) == 211968 <= SMEM_LIMIT < short(257, 80)
    assert 4 * 272 * 88 * 2 == 191488
    for dh in (80, 128):
        for dtype in (bf16, f32):
            assert attn.long_smem_bytes(dh, 8, dtype) <= SMEM_LIMIT
    assert attn.long_smem_bytes(80, 8, bf16) == 116352
    assert attn.long_smem_bytes(128, 8, bf16) == 166656
    assert attn.long_smem_bytes(80, 4, f32) == 129536
    assert attn.long_smem_bytes(128, 4, f32) == 190976
    cluster = _source("attention_bwd_cluster.cu")
    assert "116,352 at Dh = 80 and\n// 166,656 at Dh = 128" in cluster
    header = _source("attention_f32.cuh")
    assert "129,536\n// bytes at Dh = 80 and 190,976 at 128" in header
