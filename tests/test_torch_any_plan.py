"""The plan of the any-head-dim attention kernels (``csrc/attention_any.cu``,
``attention_any_bwd.cu``, ``attention_any.cuh``), on the CPU: the header's
formulas pinned (keys a forward ring stage, query rows a backward tile, keys
a CTA, the head dim's padding, each CTA's shared memory) and evaluated here;
a plan within a Hopper block's shared memory for every head dim from 1 to
768, and at 1,024, 1,100 and 2,048, at 1, 257, 577 and 1,100 tokens, the
forward and the backward taking the same head dims; no score product
computed for a second column chunk up to a head dim of 256; one backward
launch up to 1,024 tokens; and the kernels' tile order (``emulate_any``:
the online max a ring stage, S and dP summed over the depth's windows of
256, the row statistics combined over key blocks, CTAs in rank order and
clusters, the dQ partials added in rank order) against the JAX package's
kernels in interpret mode at head dims 12, 20, 136, 256 and 300 with a
ragged last tile, within the tolerances of
``tests/test_torch_head_dims_any.py``."""

import chess_vision_tpu_torch.ops  # noqa: F401  (before the first exp)

import os
import re

import numpy as np
import pytest
import torch
from test_torch_head_dims_any import (BWD_ATOL, FWD_ATOL, _cast, _inputs,
                                      _jax_kernels, emulate_any, stage_keys,
                                      tile_rows)

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

SMEM_LIMIT = 232448
DTYPES = (torch.bfloat16, torch.float32)
TOKENS = (1, 257, 577, 1100)
HEAD_DIMS = (*range(1, 769), 1024, 1100, 2048)


def _source(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def _body(src: str, name: str) -> str:
    """The one-line or multi-line body of the constexpr function ``name``."""
    found = re.search(rf"constexpr int {name}\([^)]*\) \{{(.*?)\n?\}}", src, re.S)
    return " ".join(found.group(1).split())


def _es(dtype):
    return 4 if dtype == torch.float32 else 2


def _depth(dh):
    return -(-dh // 16) * 16


def _fwd_smem(es, dh):
    """``fwd_smem_bytes`` at head dim dh (its body pinned below)."""
    dp, depth, keys, pad = attn.any_cols(dh), _depth(dh), stage_keys(dh, _DT[es]), 16 // es
    window, stages = min(depth, 256), 1 if depth > 256 else 2
    return (es * (16 * 4 * (window + pad) + stages * keys * (window + min(dp, depth) + 2 * pad))
            + (4 * 4 * 16 * (keys + 4) if es == 4 else 0))


def _bwd_smem(es, dh, keys, bufs):
    """``bwd_smem_bytes`` at head dim dh (its body pinned below)."""
    dp, depth, rows, pad = attn.any_cols(dh), _depth(dh), tile_rows(dh, _DT[es]), 16 // es
    window = min(depth, 256)
    return (es * (2 * keys * (window + pad) + 2 * rows * (window + pad) + 2 * keys * (rows + pad))
            + 4 * (bufs * (rows + attn.ANY_MAX_CTAS) * (dp + 4) + 4 * bufs * rows
                   + 3 * (keys // 16) * rows + 3 * rows
                   + (16 * 32 * (keys // 16) * (rows // 16) if depth > 256 else 0)))


_DT = {2: torch.bfloat16, 4: torch.float32}


def test_formulas_are_the_source():
    """The plan's formulas as the header writes them: keys a forward ring
    stage and query rows a backward tile (the emulation's ``stage_keys`` and
    ``tile_rows``), keys a CTA, dK / dV columns a warp, dQ columns a unit,
    the head dim's padding to 16 and a row's to 16 bytes, the window of 256
    depth columns a tile holds, each shared-memory sum; then the figures of
    its static_asserts from those sums evaluated here."""
    src = _source("attention_any.cuh")
    assert _body(src, "fwd_keys") == (
        "return es == 2 ? (dp <= 128 ? 64 : 32) : (dp <= 64 ? 64 : dp == 128 ? 32 : 16);")
    assert _body(src, "bwd_rows") == (
        "return es == 4 ? (dp <= 64 ? 64 : 16) : dp <= 16 ? 128 : dp <= 64 ? 64 : 32;")
    assert _body(src, "bwd_max_keys") == "return dp >= 256 ? 64 : 128;"
    assert _body(src, "bwd_warp_cols") == "return dp < 128 ? dp : 128;"
    assert _body(src, "bwd_dq_cols") == "return dp < 64 ? dp : 64;"
    assert _body(src, "any_depth") == "return (dh + 15) / 16 * 16;"
    assert _body(src, "any_window") == "return depth < kMaxCols ? depth : kMaxCols;"
    assert _body(src, "row_pad") == "return 16 / es;"
    assert _body(src, "fwd_smem_bytes") == (
        "return es * (16 * kFwdWarps * (any_window(depth) + row_pad(es)) + (depth > kMaxCols "
        "? 1 : 2) * fwd_keys(es, dp) * (any_window(depth) + (dp < depth ? dp : depth) + 2 * "
        "row_pad(es))) + (es == 4 ? 4 * kFwdWarps * 16 * (fwd_keys(es, dp) + 4) : 0);")
    assert _body(src, "bwd_smem_bytes") == (
        "return es * (2 * keys * (any_window(depth) + row_pad(es)) + 2 * bwd_rows(es, dp) * "
        "(any_window(depth) + row_pad(es)) + 2 * keys * (bwd_rows(es, dp) + row_pad(es))) + "
        "4 * (bufs * (bwd_rows(es, dp) + kMaxCtas) * (dp + 4) + 4 * bufs * bwd_rows(es, dp) + "
        "3 * (keys / 16) * bwd_rows(es, dp) + 3 * bwd_rows(es, dp) + (depth > kMaxCols ? 16 * "
        "32 * (keys / 16) * (bwd_rows(es, dp) / 16) : 0));")
    assert _body(src, "smem_ctas") == "return 233472 / (bytes + 1024);"
    assert re.search(r"constexpr int kFwdWarps = 4;", src)
    for dh in (12, 20, 100, 136, 256):
        for dtype in DTYPES:
            es, dp = _es(dtype), attn.any_cols(dh)
            assert stage_keys(dh, dtype) == (
                (64 if dp <= 128 else 32) if es == 2 else 64 if dp <= 64 else 32 if dp == 128 else 16)
            assert tile_rows(dh, dtype) == (
                (64 if dp <= 64 else 16) if es == 4 else 128 if dp <= 16 else 64 if dp <= 64 else 32)
    assert "bwd_smem_bytes(2, 256, 256, 64, 1) == 163968" in src
    assert (_bwd_smem(2, 256, 64, 1), _bwd_smem(2, 256, 64, 2),
            _bwd_smem(4, 256, 64, 1)) == (163968, 214400, 211136)
    assert _fwd_smem(2, 256) == 101376


def test_every_head_dim_and_token_count_has_a_plan():
    """Head dims 1-768, 1,024, 1,100 and 2,048 at 1, 257, 577 and 1,100
    tokens, bf16 and f32: the forward's and the backward's chunks the same,
    the backward's warps (16 keys by up to 128 columns each) at most 8, a
    cluster of at most 16 CTAs, keys a CTA a multiple of 16 within its cap,
    the key ranges covering the tokens, the head dim padded to a multiple of
    16 and the columns to the CTA's width, the shared memory of a forward
    CTA and of a backward CTA (with two sets where they fit, ``bwd_bufs``)
    within a block's."""
    for dh in HEAD_DIMS:
        chunks, cols = attn.any_plan(dh)
        assert cols % 16 == 0 and cols >= min(dh, 256) and cols < 2 * max(dh, 16)
        assert chunks == -(-dh // 256) or chunks == 1
        assert _depth(dh) % 16 == 0 and 0 <= _depth(dh) - dh < 16
        for dtype in DTYPES:
            es = _es(dtype)
            assert _fwd_smem(es, dh) <= SMEM_LIMIT
            for n in TOKENS:
                clusters, ctas, keys = attn.any_bwd_plan(n, dh)
                assert 1 <= ctas <= attn.ANY_MAX_CTAS and keys % 16 == 0
                assert keys <= (64 if cols >= 256 else 128)
                assert keys // 16 * (cols // min(cols, 128)) <= 8
                assert _bwd_smem(es, dh, keys, 1) <= SMEM_LIMIT
                ranges = attn.f32_key_ranges(n, clusters * ctas)
                held = [max(0, e - a) for a, e in ranges]
                assert sum(held) == n and max(held) <= keys
                if n <= 1024:
                    assert clusters == 1, (dh, n, dtype)


def test_main_shapes_plans():
    """The plans of the shapes the main paths run: ViT-B/16's width on 3
    heads of 256 (one CTA of 4 warps over 64 rows by 256 columns, 32-key
    stages; a cluster of 5 CTAs of 64 keys at 257 tokens, 10 at 577, two
    clusters of 9 at 1,100) and on 64 heads of 12 (16 columns, 64-key
    stages; 3 CTAs of up to 96 keys); ViT-L's width on one head of 1,024
    and a head of 1,100 (chunks of 256, the depth in windows of 256)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert attn.any_plan(256) == (1, 256) and stage_keys(256, bf16) == 32
    assert stage_keys(256, f32) == 16 and stage_keys(12, f32) == 64
    assert attn.any_bwd_plan(257, 256) == (1, 5, 64)
    assert [e - a for a, e in attn.f32_key_ranges(257, 5)] == [64, 64, 48, 48, 33]
    assert attn.any_bwd_plan(577, 256) == (1, 10, 64)
    assert attn.any_bwd_plan(1100, 256) == (2, 9, 64)
    assert tile_rows(256, bf16) == 32 and tile_rows(256, f32) == 16
    assert attn.any_bwd_plan(257, 12) == (1, 3, 96)
    assert attn.any_bwd_plan(1100, 12) == (1, 9, 128)
    assert tile_rows(12, f32) == 64 and tile_rows(12, bf16) == 128
    assert attn.any_plan(1024) == (4, 256) and attn.any_plan(1100) == (5, 256)
    assert attn.any_bwd_plan(257, 1024) == attn.any_bwd_plan(257, 1100) == (1, 5, 64)
    assert (_bwd_smem(2, 1100, 64, 2), _bwd_smem(4, 1024, 64, 1)) == (230784, 219328)


def test_no_score_product_for_a_second_chunk_up_to_256():
    """Up to a head dim of 256 one CTA (forward) or cluster (backward) keeps
    all of a head's output columns, so the grid has one chunk a head and S
    and dP are computed once per (query, key) pair a pass; above, chunks of
    256 in both, whose tiles hold the depth a window of 256 at a time (the
    kernels' kDeep form, dispatched above a depth of 256), as the entries
    size their grids."""
    fwd = _source("attention_any.cu")
    bwd = _source("attention_any_bwd.cu")
    assert "a.chunks = any_chunks(head_dim);" in fwd
    assert "a.heads * a.chunks, batch);" in fwd
    assert "const int chunks = any_chunks(head_dim);" in bwd
    assert "dim3(a.ctas * a.clusters, a.heads * a.chunks, batch)" in bwd
    assert "a.depth > kMaxCols ? launch_fwd<T, 256, true>(a, batch, s)" in fwd
    assert "a.depth > kMaxCols ? launch_bwd<T, 256, true>(a, batch, s)" in bwd
    assert "__host__ __device__ constexpr int any_chunks(int dh) { return (dh + kMaxCols - 1) / kMaxCols; }" \
        in _source("attention_any.cuh")
    for dh in range(1, 257):
        assert attn.any_plan(dh)[0] == 1
    assert [attn.any_plan(dh)[0] for dh in (257, 384, 768, 2048)] == [2, 2, 3, 8]


def test_entries_take_what_the_bindings_pass():
    """The C entries' parameters, as the ctypes bindings type them: the
    backward takes the split's two scratches and the plan (clusters, ctas,
    keys), no statistics scratch of its own."""
    types = {"void*": _build.ctypes.c_void_p, "const void*": _build.ctypes.c_void_p,
             "int": _build.ctypes.c_int, "float": _build.ctypes.c_float}
    for name, source in (("cvt_attention_fwd_any", "attention_any.cu"),
                         ("cvt_attention_bwd_any", "attention_any_bwd.cu")):
        text = re.sub(r"//[^\n]*", "", _source(source))
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
        kinds = [" ".join(p.split()[:-1]).replace(" *", "*") for p in params.split(",")]
        assert [types[k] for k in kinds] == _build._SIGNATURES[name], name
    names = re.search(r'extern "C" int cvt_attention_bwd_any\(([^)]*)\)',
                      _source("attention_any_bwd.cu")).group(1)
    assert "clusters, int ctas, int keys" in " ".join(names.split())


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_tile_order_matches_the_jax_kernel(dtype):
    """``emulate_any`` at 70 tokens (a ragged last stage and tile) and head
    dims 12, 20, 136, 256 and 300 (two windows of the depth, the second
    ragged) on each one's plan, 20 also on two clusters of three CTAs (the
    split's statistics and dQ partials), against the JAX package's kernels
    in interpret mode."""
    for B, N, H, Dh, plan in ((1, 70, 2, 12, None), (1, 70, 2, 20, (2, 3, 16)),
                              (1, 70, 1, 136, None), (1, 70, 1, 256, None),
                              (1, 70, 1, 300, None)):
        qkv, g = _inputs(B, N, H, Dh, seed=11 * Dh)
        (tq, jq), (tg, jg) = _cast(qkv, dtype), _cast(g, dtype)
        out, dqkv = emulate_any(tq, tg, H, plan)
        kernel, dkernel = _jax_kernels(jq, jg, H)
        np.testing.assert_allclose(out.float().numpy(), kernel,
                                   atol=FWD_ATOL[dtype], err_msg=f"{Dh} forward")
        np.testing.assert_allclose(dqkv.float().numpy(), dkernel,
                                   atol=BWD_ATOL[dtype], err_msg=f"{Dh} backward")
