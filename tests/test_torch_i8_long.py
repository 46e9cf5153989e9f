"""The int8 legs at any token count, checked where no card is needed.

``ops/attention.i8_plan`` sends a head to the short route
(``attention_quant_i8_kernel``: its codes held in a block's shared memory)
where they fit, else to the long route (``attention_quant_i8_long_kernel``,
``csrc/attention_quant_long.cu``: the head streamed through a ring of 64-key
tiles, coded as they land). Here:

- the plan switches route exactly where the short route's shared memory
  runs out, and its bytes are the kernels' layouts (``I8Layout``,
  ``I8LongLayout``, copied below from their C++), whose constants are read
  from the sources;
- the long route's walk 2, emulated in numpy tile by tile through the ring,
  adds each row's p in ``_row_sum_kernel_order``'s order, bit for bit, so the
  plain version holds for both routes;
- the plain version against the JAX kernel in interpret mode past a limit
  (1,057 tokens, one head of 64).

Tolerances: the row sums bit for bit. Against JAX, codes within one level in
under 1e-3 of the elements, as ``tests/test_torch_int8_modes.py`` holds the
modes at 33 tokens, and scales within rtol 2 N 2^-24: without the P V leg
the row sum of N bf16-rounded p is an f32 sum, which the JAX kernel takes in
another order (its ones column of V), and each order's relative error is
below (N - 1) 2^-24.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import attention as jax_attn
from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

F32 = np.float32
CSRC = os.path.join(os.path.dirname(attn.__file__), os.pardir, "csrc")
# the last key count of the short route, by (head dim, legs): 1 qk_int8, 2
# pv_int8, 3 both
SHORT_LIMITS = {(64, 1): 960, (64, 2): 1056, (64, 3): 1504,
                (32, 1): 1728, (32, 2): 2016, (32, 3): 2688,
                (16, 1): 2720, (16, 2): 3552, (16, 3): 4384}


def _constant(source: str, name: str) -> str:
    text = open(os.path.join(CSRC, source)).read()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def i8_layout_bytes(n_keys: int, dh: int, qk: bool, pv: bool) -> int:
    """``I8Layout<Dh, kQk8, kPv8>(n_keys).bytes``, step by step."""
    warps, rows, pad = 3, 96, 8
    kp = (n_keys + 31) // 32 * 32
    vld = kp + 32 if kp % 64 == 0 else kp
    k_scale = kp * (dh + 16) if qk else kp * (dh + pad) * 2
    v_rows = k_scale + (kp * 4 if qk else 0)
    stage = v_rows + (dh * vld if pv else kp * (dh + pad) * 2)
    v_scale = stage + rows * dh
    v_inv = v_scale + (dh * 4 if pv else 0)
    colmax = v_inv + (dh * 4 if pv else 0)
    part = colmax + (warps * dh * 4 if pv else 0)
    return part + rows * 4 + rows * 4


def i8_long_layout_bytes(dh: int, qk: bool, pv: bool) -> int:
    """``I8LongLayout<Dh, kQk8, kPv8>::bytes``: a ring of 3 stages, each a
    tile of K's codes [64][dh + 16] and scales [64] (or bf16 rows [64][dh +
    8]) and V's codes [dh][96] (or bf16 rows), then a pass's staging [128][dh]
    and the tail of I8Layout at 4 warps."""
    warps, stages, tile = 4, 3, 64
    rows = 32 * warps
    tile_k = tile * (dh + 16) + tile * 4 if qk else tile * (dh + 8) * 2
    tile_v = dh * (tile + 32) if pv else tile * (dh + 8) * 2
    v_scale = stages * (tile_k + tile_v) + rows * dh
    part = v_scale + (dh * 4 * (2 + warps) if pv else 0)
    return part + 2 * rows * 4


def test_i8_plan_switches_route_at_each_limit():
    """The short route up to its last length (the last its shared memory
    takes, at head dim 64 the measured crossover of 288 keys), the long one
    from the next key on, at head dims 16, 32 and 64 in each form; the long
    route's bytes the same at every length."""
    for (dh, legs), fits in SHORT_LIMITS.items():
        assert attn.i8_short_fits(fits, dh, legs) and not attn.i8_short_fits(fits + 1, dh, legs)
        last = min(fits, attn._I8_SHORT_LAST.get((dh, legs), fits))
        assert attn.i8_plan(last, dh, legs)[0] == "short", (dh, legs)
        route, nbytes = attn.i8_plan(last + 1, dh, legs)
        assert route == "long", (dh, legs)
        for n in (last + 33, 2 * last, 20000):
            assert attn.i8_plan(n, dh, legs) == ("long", nbytes)
    with pytest.raises(ValueError):
        attn.i8_plan(257, 64, 0)


def test_i8_plan_bytes_are_the_kernel_layouts():
    """At 257 tokens and head dim 64: 50,816 bytes with both legs, 68,096
    with pv_int8 alone, 72,576 with qk_int8 alone (the sizes the kernel's
    header states); at every length and head dim the copies of I8Layout
    (short) and I8LongLayout (long); the constants they take from the
    sources."""
    assert [attn.i8_plan(257, 64, legs)[1] for legs in (3, 2, 1)] == [
        50816, 68096, 72576]
    for dh in (16, 32, 64):
        for legs in (1, 2, 3):
            qk, pv = bool(legs & 1), bool(legs & 2)
            for n in (1, 17, 64, 257, 1000, 1601, 4385):
                route, nbytes = attn.i8_plan(n, dh, legs)
                short = i8_layout_bytes(n, dh, qk, pv)
                assert (route == "short") == (
                    short <= attn.I8_MAX_SMEM
                    and n <= attn._I8_SHORT_LAST.get((dh, legs), n))
                assert nbytes == (short if route == "short"
                                  else i8_long_layout_bytes(dh, qk, pv))
    assert i8_long_layout_bytes(64, True, True) == 45312
    assert _constant("attention_quant_i8.cuh", "kWarps") == "3"
    assert _constant("attention_quant_i8.cuh", "kRows") == "32 * kWarps"
    assert _constant("attention_quant_i8.cuh", "kStages") == str(attn._I8_STAGES)
    assert _constant("attention_loop.cuh", "kFlashKTile") == str(attn._KEY_TILE)
    assert _constant("attention_quant.cu", "kMaxSmem") == str(attn.I8_MAX_SMEM)


def test_walk2_over_key_tiles_gives_the_plain_row_sums():
    """Walk 2 of the long route at 1,601 keys: each 64-key tile lands in ring
    stage tile % 2 (zeros past the last key), and each of a row's four
    threads t adds its keys 16 hs + 8 hh + 2 t + c (c = 0, 1) of each tile's
    sub-steps hs (those wholly past the last key skipped) in f32; then the
    threads' sums two and two. Equal to ``_row_sum_kernel_order`` bit for
    bit."""
    n, rows = 1601, 48
    rng = np.random.default_rng(21)
    s = (rng.normal(size=(rows, n)) * 3).astype(F32)
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(F32)
    tile, stages = attn._KEY_TILE, attn._I8_STAGES
    ring = np.zeros((stages, rows, tile), F32)
    lsum = np.zeros((4, rows), F32)
    for k0 in range(0, n, tile):
        stage = ring[k0 // tile % stages]
        stage[:] = 0
        stage[:, :min(tile, n - k0)] = p[:, k0:k0 + tile]
        for hs in range(4):
            if k0 + 16 * hs >= n:
                continue
            for hh in range(2):
                for t in range(4):
                    for c in range(2):
                        lsum[t] = lsum[t] + stage[:, 16 * hs + 8 * hh + 2 * t + c]
    total = (lsum[0] + lsum[1]) + (lsum[2] + lsum[3])
    want = attn._row_sum_kernel_order(torch.from_numpy(p))[:, 0].numpy()
    np.testing.assert_array_equal(total, want)


@pytest.mark.parametrize("legs", [(True, False), (True, True)],
                         ids=["int8", "int8pv"])
def test_plain_matches_jax_past_the_limit(legs):
    """1 image, 1 head of 64, 1,057 tokens (past the short route's shared
    memory under qk_int8 alone, within it with both legs; on the long route
    in both, past the measured crossover): the port's plain version, which
    both routes hold to, against the JAX kernel in interpret mode."""
    n, dh = 1057, 64
    qkv = np.random.default_rng(7).normal(size=(1, n, 3 * dh))
    qkv[:, :, :dh] *= 4.0
    qkv = qkv.astype(F32)
    qk, pv = legs
    assert attn.i8_short_fits(n, dh, int(qk) | 2 * int(pv)) == pv
    assert attn.i8_plan(n, dh, int(qk) | 2 * int(pv))[0] == "long"
    jq, js = jax_attn.fused_qkv_attention_quant(
        jnp.asarray(qkv).astype(jnp.bfloat16), 1, interpret=True, qk_int8=qk,
        pv_int8=pv)
    q, s = attn.fused_qkv_attention_quant(torch.from_numpy(qkv).bfloat16(), 1,
                                          qk_int8=qk, pv_int8=pv)
    levels = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert levels.max() <= 1 and (levels > 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2 * n * 2.0 ** -24)
