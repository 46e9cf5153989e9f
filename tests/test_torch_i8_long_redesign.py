"""The int8 legs' long route as redesigned for Hopper, checked where no card
is needed.

``attention_quant_i8_long_kernel`` (``csrc/attention_quant_long.cu``) codes
its head once into a device scratch (K's codes [kp][Dh] and scales [kp], V's
codes [Dh][kp] in P's A fragment order, kp the keys rounded up to 64), then
takes the image's rows ``32 * _I8_LONG_WARPS`` at a time, each pass's walks
streaming the head's 64-key tiles from the scratch through a ring. Here:

- the scratch's bytes a head, and the constants the port copies from the
  sources;
- ``i8_plan``'s crossover between the routes where it was measured;
- walk 2 emulated in numpy, with the rows split into passes and warps and
  the K tiles copied from the scratch's layout: each row's f32 sum in
  ``_row_sum_kernel_order``'s order, bit for bit;
- ``i8_long_bytes``, the device bytes a call reads, against hand counts.

Tolerances: none; every check is exact.
"""

import os
import re

import numpy as np
import torch

from chess_vision_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

F32 = np.float32
CSRC = os.path.join(os.path.dirname(attn.__file__), os.pardir, "csrc")


def _source(name: str) -> str:
    return open(os.path.join(CSRC, name)).read()


def test_scratch_bytes_and_constants():
    """A head's scratch at 257 and 1,601 keys by hand (kp = 320 and 1,664:
    K's codes and f32 scales kp (Dh + 4), V's codes Dh kp); ViT-B/16 at 640
    px, 256 images of 12 heads under both legs, ~675 MB; the block's warps
    and ring depth as the header sets them."""
    assert attn.i8_long_scratch_bytes(257, 64, 1) == 320 * 68
    assert attn.i8_long_scratch_bytes(257, 16, 2) == 16 * 320
    assert attn.i8_long_scratch_bytes(1601, 64, 3) == 1664 * 68 + 64 * 1664
    assert attn.i8_long_scratch_bytes(1664, 32, 3) == 1664 * 36 + 32 * 1664
    assert 256 * 12 * attn.i8_long_scratch_bytes(1601, 64, 3) == 674_758_656
    header = _source("attention_quant_i8.cuh")
    warps = re.search(r"#define CVT_I8_LONG_WARPS (\d+)", header).group(1)
    stages = re.search(r"constexpr int kLongStages = (\d+);", header).group(1)
    assert (int(warps), int(stages)) == (attn._I8_LONG_WARPS, attn._I8_LONG_STAGES)
    long_src = _source("attention_quant_long.cu")
    assert "kp * (dh + 4)" in long_src and "dh * kp" in long_src


def test_i8_plan_crossover_at_the_measured_points():
    """The routes in turns at head dim 64 (257-1,504 keys): the short route
    faster at 257 keys in every form, the long one from 289 on (but for
    int8pv at 321, 513 and 641), so i8_plan takes the short route to 288
    keys, where both routes' layouts are still those of 257, and the long
    one past it, though the short one fits to 960, 1,056 and 1,504 keys.
    Head dims 16 and 32 keep the short route wherever it fits."""
    for legs in (1, 2, 3):
        assert attn.i8_plan(257, 64, legs)[0] == "short"
        assert attn.i8_plan(288, 64, legs) == attn.i8_plan(257, 64, legs)
        assert attn.i8_plan(289, 64, legs)[0] == "long"
        assert attn.i8_short_fits(960, 64, legs)
        assert attn.i8_plan(960, 64, legs)[0] == "long"
        assert attn.i8_plan(1601, 64, legs)[0] == "long"
    assert attn.i8_short_fits(1504, 64, 3) and not attn.i8_short_fits(1505, 64, 3)
    for dh, last in ((32, 1728), (16, 2720)):
        assert attn.i8_plan(last, dh, 1)[0] == "short"
        assert attn.i8_plan(last + 1, dh, 1)[0] == "long"


def test_walk2_over_passes_from_the_scratch_gives_the_plain_row_sums():
    """Walk 2 at 1,601 keys and head dim 64 under both legs: K coded once
    (``_rowq8``) into the scratch's [kp][Dh] rows and [kp] scales, zero past
    the last key; the rows in passes of 32 W (``flash_chunks``), each warp's
    row blocks w and w + W; each tile copied from the scratch as the kernel
    copies it (row r of the tile at k0: bytes (k0 + r) Dh ..), S from the
    int32 products of its codes, p = exp(s - m); each of a row's four
    threads adds keys 16 hs + 8 hh + 2 t + c of each tile's sub-steps hs
    (those wholly past the last key skipped), then the threads' sums two and
    two. Equal to ``_row_sum_kernel_order`` of the same p bit for bit, and
    the scores to those of the codes read in place."""
    n, dh, W, tile = 1601, 64, attn._I8_LONG_WARPS, attn._KEY_TILE
    rng = np.random.default_rng(22)
    q = torch.from_numpy((rng.normal(size=(n, dh)) * 3).astype(F32))
    k = torch.from_numpy(rng.normal(size=(n, dh)).astype(F32))
    qq, qs = (t.numpy() for t in attn._rowq8(q))
    kq, ks = (t.numpy() for t in attn._rowq8(k))
    kp = -(-n // tile) * tile
    codes = np.zeros(kp * dh, np.int8)
    codes[:n * dh] = kq.reshape(-1).astype(np.int8)
    scales = np.zeros(kp, F32)
    scales[:n] = ks[:, 0]
    qf = (qs[:, 0] * F32(dh ** -0.5)).astype(F32)
    blocks = -(-n // 16)
    passes = -(-blocks // (2 * W))
    per = -(-blocks // passes)
    seen = np.zeros(n, bool)
    for p0 in range(passes):
        for w in range(W):
            for rb in (w, w + W):
                if rb >= min(per, blocks - p0 * per):
                    continue
                rows = np.arange(16) + (p0 * per + rb) * 16
                rows = rows[rows < n]
                seen[rows] = True
                s = np.full((len(rows), kp), -np.inf, F32)
                for k0 in range(0, kp, tile):
                    kc = codes[k0 * dh:(k0 + tile) * dh].reshape(tile, dh)
                    acc = qq[rows].astype(np.int64) @ kc.T.astype(np.int64)
                    part = (acc.astype(F32) * qf[rows, None]).astype(F32)
                    s[:, k0:k0 + tile] = (part * scales[k0:k0 + tile]).astype(F32)
                s[:, n:] = -np.inf
                want_s = ((qq[rows].astype(np.int64) @ kq.T.astype(np.int64))
                          .astype(F32) * qf[rows, None]).astype(F32) * ks[:, 0]
                np.testing.assert_array_equal(s[:, :n], want_s.astype(F32))
                p = np.exp(s - s.max(axis=1, keepdims=True)).astype(F32)
                lsum = np.zeros((4, len(rows)), F32)
                for k0 in range(0, kp, tile):
                    for hs in range(4):
                        if k0 + 16 * hs >= n:
                            continue
                        for hh in range(2):
                            for t in range(4):
                                for c in range(2):
                                    lsum[t] = lsum[t] + p[:, k0 + 16 * hs + 8 * hh + 2 * t + c]
                total = (lsum[0] + lsum[1]) + (lsum[2] + lsum[3])
                want = attn._row_sum_kernel_order(torch.from_numpy(p[:, :n]))[:, 0].numpy()
                np.testing.assert_array_equal(total, want)
    assert seen.all() and passes == 13


def test_device_bytes_a_call_by_hand():
    """``i8_long_bytes`` against counts by hand, head dim 64, 12 heads, rows
    of 128 bytes, passes of 128 rows. 257 tokens (kp 320, 3 passes): both
    legs, Q 257 rows + K 257 + V 2 x 257 to code the head, then a pass's
    three K walks of 320 x 68 bytes and one V walk of 64 x 320; qk_int8 alone,
    Q + K's rows, two K walks and V's 257 bf16 rows a pass. 1,601 tokens (kp
    1,664, 13 passes): both legs, 256 images; pv_int8 alone, K bf16 in each
    walk."""
    row = 128
    assert attn.i8_long_bytes(1, 257, 257, 12, 64, 3) == 12 * (
        257 * row + 3 * 257 * row + 3 * (3 * 320 * 68 + 64 * 320))
    assert attn.i8_long_bytes(1, 257, 257, 12, 64, 1) == 12 * (
        2 * 257 * row + 3 * (2 * 320 * 68 + 257 * row))
    assert attn.i8_long_bytes(1, 257, 257, 12, 64, 3) == 4_666_368
    assert attn.i8_long_bytes(256, 1601, 1601, 12, 64, 3) == 256 * 12 * (
        4 * 1601 * row + 13 * (3 * 1664 * 68 + 64 * 1664))
    assert attn.i8_long_bytes(256, 1601, 1601, 12, 64, 3) == 20_327_694_336
    assert attn.i8_long_bytes(256, 1601, 1601, 12, 64, 2) == 256 * 12 * (
        3 * 1601 * row + 13 * (3 * 1601 * row + 64 * 1664))
