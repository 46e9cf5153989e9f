"""What the cluster route of K9 and K10 (``csrc/int8_matmul.cu``) is built
from, checked here where the card is not: in numpy and plain PyTorch, against
the kernel's own source and the JAX package.

- K9's LayerNorm on a cluster: the warps of one cluster row split a 64-row
  panel, and lane l's chunk c of a row (columns 256c + 8l .. + 7) is read
  from the x' tile of cluster rank c. Emulated with ``rowquant_row``'s lane
  order and its f32 sums rounded to nearest one by one (numpy float32), with
  every column of a tile past the matrix set to NaN, it gives the codes and
  scales of the emulated row pass the parent launched after the product bit
  for bit (the same values in the same lanes, summed in the same order), and
  those meet ``int8_matmul_res_ln_quant_plain`` and the JAX kernel (Pallas
  interpret mode) within the bounds of ``tests/test_torch_int8_matmul.py``:
  codes one level apart in under 1e-3 of the elements, scales rtol 1e-5 (the
  plain and JAX versions sum in another order).
- The cluster walk (``ResWalk`` in the source) covers every (panel, column
  tile) once for several grids, ragged M and ragged O.
- The route by shape (``res_route``): K9 on clusters of ceil(O/256) blocks
  up to O = 2048 (8 blocks), the two-launch route above; K10 always one
  kernel of one block per SM.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import int8_matmul as jax_mm
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import int8_matmul as mm

torch.set_num_threads(2)

F32 = np.float32
EPS = 1e-6


def _source(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def _warp_reduce(v, op):
    """The shfl_xor butterfly over the lane axis (-1): every lane ends with
    the same value (a + b == b + a in IEEE arithmetic)."""
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., np.arange(32) ^ o])
    return v[..., 0]


def rowquant_ln(load, rows: int, d: int, ch: int, g, b):
    """``rowquant_rows_with`` in mode kRowLn for ``rows`` rows at once:
    load(c) -> (rows, 32 lanes, 8) f32 of chunk c (read only where the chunk
    lies inside the row). Returns int8 codes (rows, d) and f32 scales."""
    lanes = np.arange(32)
    col = (lanes[None, :] + 32 * np.arange(ch)[:, None]) * 8   # (ch, 32)
    ok = col < d
    v = np.zeros((rows, ch, 32, 8), F32)
    for c in range(ch):
        if ok[c].any():
            v[:, c, ok[c]] = load(c)[:, ok[c]]
    s = np.zeros((rows, 32), F32)
    for c in range(ch):
        for j in range(8):
            s = (s + v[:, c, :, j]).astype(F32)
    mu = (_warp_reduce(s, np.add).astype(F32) / F32(d)).astype(F32)
    v = (v - mu[:, None, None, None]).astype(F32)
    sq = np.zeros((rows, 32), F32)
    for c in range(ch):
        for j in range(8):
            sq = np.where(ok[c], (sq + v[:, c, :, j] * v[:, c, :, j]).astype(F32), sq)
    var = (_warp_reduce(sq, np.add) / F32(d)).astype(F32)
    r = (F32(1) / np.sqrt((var + F32(EPS)).astype(F32))).astype(F32)
    gc = np.zeros((ch, 32, 8), F32)
    bc = np.zeros((ch, 32, 8), F32)
    cols = col[..., None] + np.arange(8)                       # (ch, 32, 8)
    gc[ok] = g[cols[ok]]
    bc[ok] = b[cols[ok]]
    out = ((v * r[:, None, None, None]).astype(F32) * gc).astype(F32) + bc
    out = out.astype(F32)
    amax = np.where(ok[None, :, :, None], np.abs(out), F32(0)).max(axis=(1, 3))
    amax = np.maximum(_warp_reduce(amax, np.maximum), F32(1e-8)).astype(F32)
    inv = (F32(127) / amax).astype(F32)
    q = np.clip(np.rint((out * inv[:, None, None, None]).astype(F32)), -127, 127)
    codes = np.zeros((rows, d), np.int8)
    for c in range(ch):
        for lane in range(32):
            if ok[c, lane]:
                codes[:, col[c, lane]:col[c, lane] + 8] = q[:, c, lane]
    return codes, (amax * F32(1.0 / 127.0)).astype(F32)[:, None]


def row_pass(x: np.ndarray, g, b):
    """The parent's route: ``launch_rowquant`` over the rows of x' as stored,
    its chunk count rounded up as that launcher rounds it."""
    d = x.shape[1]
    ch = next(c for c in (1, 2, 3, 4, 6, 8, 12, 16) if 256 * c >= d)

    def load(c):  # lanes past the row read a valid column; their values are not used
        cols = (np.arange(32) + 32 * c)[:, None] * 8 + np.arange(8)
        return x[:, np.minimum(cols, d - 1)]

    return rowquant_ln(load, x.shape[0], d, ch, g, b)


def cluster_ln(x: np.ndarray, g, b):
    """The cluster route: panels of 64 rows; column tile c of a panel in
    rank c's 64 x 256 tile (NaN past the matrix's rows and columns); chunk c
    of a row from rank c's tile, CH the next of 1, 2, 4, 8 at or above the
    cluster's column tiles."""
    m, d = x.shape
    tiles_n = -(-d // 256)
    ch = next(c for c in (1, 2, 4, 8) if c >= tiles_n)
    codes = np.zeros((m, d), np.int8)
    scales = np.zeros((m, 1), F32)
    for m0 in range(0, m, 64):
        tiles = np.full((tiles_n, 64, 256), np.nan, F32)
        for c in range(tiles_n):
            part = x[m0:m0 + 64, 256 * c:256 * c + 256]
            tiles[c, :part.shape[0], :part.shape[1]] = part
        rows = min(64, m - m0)
        q, s = rowquant_ln(lambda c: tiles[c, :rows, :].reshape(rows, 32, 8),
                           rows, d, ch, g, b)
        codes[m0:m0 + rows], scales[m0:m0 + rows] = q, s
    return codes, scales


def _codes_close(ours, ref):
    diff = np.abs(np.asarray(ours, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("B,N,K,O", [(2, 65, 64, 768), (3, 33, 48, 80),
                                     (1, 130, 32, 784)])
def test_cluster_ln_equals_the_row_pass(B, N, K, O):
    rng = np.random.default_rng(O)
    xq = rng.integers(-127, 128, (B, N, K)).astype(np.int8)
    xs = rng.uniform(0.005, 0.02, (B, N, 1)).astype(F32)
    wq = rng.integers(-127, 128, (K, O)).astype(np.int8)
    ws = rng.uniform(0.005, 0.02, O).astype(F32)
    bias = rng.normal(0, 0.1, O).astype(F32)
    res = rng.normal(0, 1, (B, N, O)).astype(F32)
    g = (1 + 0.1 * rng.normal(size=O)).astype(F32)
    b = (0.1 * rng.normal(size=O)).astype(F32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    x, q, s = mm.int8_matmul_res_ln_quant_plain(
        t(xq.reshape(-1, K)), t(xs.reshape(-1, 1)), t(wq.T), t(ws), t(bias),
        t(res.reshape(-1, O)).bfloat16(), t(g), t(b))
    xf = x.float().numpy()
    cq, cs = cluster_ln(xf, g, b)
    pq, ps = row_pass(xf, g, b)
    assert np.array_equal(cq, pq) and np.array_equal(cs.view(np.uint32),
                                                     ps.view(np.uint32))
    _codes_close(cq, q.numpy())
    np.testing.assert_allclose(cs, s.numpy(), rtol=1e-5)
    _, jq, js = jax_mm.int8_matmul_res_ln_quant(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws),
        jnp.asarray(bias), jnp.asarray(res).astype(jnp.bfloat16), g, b,
        interpret=True)
    _codes_close(cq, np.asarray(jq).reshape(-1, O))
    np.testing.assert_allclose(cs, np.asarray(js).reshape(-1, 1), rtol=1e-5)


def cluster_tiles(m: int, o: int, clusters: int):
    """Every block's tiles in the source's walk of K9's clusters
    (``res_walk``, ``ResWalk::panel``): (block, i, panel, column tile)."""
    tiles_n = -(-o // 256)
    panels = -(-m // 64)
    out = []
    for block in range(clusters * tiles_n):
        rank = block % tiles_n  # %cluster_ctarank of a (tiles_n, 1, 1) cluster
        first, stride = block // tiles_n, clusters
        count = (panels - first + stride - 1) // stride if first < panels else 0
        out += [(block, i, first + i * stride, rank) for i in range(count)]
    return out


@pytest.mark.parametrize("m,o", [(65792, 768), (4999, 776), (129, 8)])
def test_cluster_walk_covers_every_tile_once(m, o):
    src = _source("int8_matmul.cu")
    for line in ("return kCluster ? first + i * stride : (first + i * stride) / tiles_n;",
                 "return kCluster ? rank : (int)((first + i * stride) % tiles_n);",
                 "w.first = blockIdx.x / w.tiles_n;",
                 "w.stride = gridDim.x / w.tiles_n;",
                 "if (clusters > panels) clusters = (int)panels;"):
        assert line in src, line
    panels, tiles_n = -(-m // 64), -(-o // 256)
    want = {(p, c) for p in range(panels) for c in range(tiles_n)}
    for clusters in (1, 7, 39, 132, panels):
        clusters = min(clusters, panels)  # launch_res's grid
        tiles = cluster_tiles(m, o, clusters)
        got = [(p, c) for _, _, p, c in tiles]
        assert len(got) == len(want) and set(got) == want
        # the blocks of a cluster walk as many tiles, one panel at each step
        for q in range(clusters):
            mine = [t for t in tiles if t[0] // tiles_n == q]
            steps = {}
            for block, i, p, c in mine:
                steps.setdefault(i, set()).add(p)
            assert all(len(ps) == 1 for ps in steps.values())
            counts = {sum(1 for t in mine if t[0] == b)
                      for b in range(q * tiles_n, (q + 1) * tiles_n)}
            assert len(counts) == 1


def test_route_by_shape():
    src = _source("int8_matmul.cu")
    gemm = _source("int8_gemm.cuh")
    assert re.search(r"kClusterMax = (\d+);", src).group(1) == str(mm.CLUSTER_MAX)
    assert re.search(r"kTileN = (\d+);", gemm).group(1) == str(mm.TILE_N)
    assert re.search(r": epilogue == kEpiRes\s+\? kRouteTiles\s+"
                     r": tiles_n <= kClusterMax\s+\? kRouteCluster\s+: kRouteTwoLaunch;",
                     src)
    want = {8: 1, 80: 1, 256: 1, 264: 2, 768: 3, 776: 4, 1024: 4, 1032: 5,
            2048: 8, 2056: 0, 2304: 0, 3072: 0}
    assert {o: mm.res_cluster_blocks(o) for o in want} == want
    assert mm.ROUTES == ("two_launch", "tiles", "cluster")
    assert re.search(r"kRouteTwoLaunch = 0, kRouteTiles = 1, kRouteCluster = 2", src)
    with pytest.raises(ValueError, match="device"):
        mm.res_route(768, device="cpu")
