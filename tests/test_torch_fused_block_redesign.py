"""The whole-block int8 kernel (K14, chess_vision_tpu_torch/csrc/fused_block.cu)
on the split kernels' device code: the wgmma GEMM of int8_gemm.cuh for its
four products, K8's row-maximum exchange in its fc1 stage, and the attention
loop of attention_loop.cuh with the per-token scale exchanged between the
blocks of a team.

On the card (marker ``cuda``, skipped without one) the kernel is held bit for
bit to the chain of split kernels it replaces (``quant.block_int8``) and to a
second launch, at the shapes where the design has edges: heads not a
multiple of the block's four attention groups (a team's last block is
ragged), rows not a multiple of the 64-row panel, MLP widths not a multiple
of the 256-column tile (ragged fc1 groups), and the ViT-B block; each GELU,
with a fixed shift and with the row max. Run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_block_redesign.py -q

On the CPU: the stage names against the kernel source, the ``stage_ns``
checks, and the plain version against the JAX kernel (interpret mode) at a
shape tests/test_torch_fused_block.py does not take.
"""

import os
import re

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import fused_block as fb
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

_SOURCE = os.path.join(os.path.dirname(fb.__file__), os.pardir, "csrc",
                       "fused_block.cu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU path")
    return torch.device("cuda")


def _block(dev, D, O1, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def dense(k, o):
        return {"wq": torch.randint(-127, 128, (o, k), device=dev, generator=g,
                                    dtype=torch.int8),
                "scale": torch.rand(o, device=dev, generator=g) * 4e-4 + 2e-4,
                "bias": torch.randn(o, device=dev, generator=g) * 0.1}

    def norm():
        return {"scale": torch.rand(D, device=dev, generator=g) + 0.5,
                "bias": torch.randn(D, device=dev, generator=g) * 0.1}

    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}


def _inputs(dev, B, N, D, O1, seed):
    q, nxt = _block(dev, D, O1, seed), _block(dev, D, O1, seed + 1)["norm1"]
    x = (torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, N, D)).astype(np.float32) * 0.5)).to(dev).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"],
                               q["norm1"]["bias"])
    return x, xq, xs, q, nxt


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh,O1", [
    (2, 40, 5, 16, 320),      # 5 heads: a team of 2 blocks, the second ragged
    (3, 65, 2, 64, 512),      # M = 195: a ragged 64-row panel
    (2, 17, 1, 64, 80),       # O1 = 80: one ragged fc1 column tile
    (2, 33, 2, 64, 784),      # O1 = 784: 4 column tiles, 33 groups of them
    (2, 257, 12, 64, 3072),   # the ViT-B block: teams of 3 blocks
], ids=["heads5x16", "rows195", "o1_80", "o1_784", "vitb"])
def test_fused_block_equals_split_chain_and_itself(cuda, B, N, H, Dh, O1):
    x, xq, xs, q, nxt = _inputs(cuda, B, N, H * Dh, O1, seed=N + O1)
    for shift in (None, 1.0):
        for gelu in ("sigmoid", "erf", "hard"):
            before = fb.LAUNCHES
            out = fb.fused_vit_block(xq, xs, x, q, nxt, H, shift, gelu=gelu)
            again = fb.fused_vit_block(xq, xs, x, q, nxt, H, shift, gelu=gelu)
            split = quant.block_int8(x, xq, xs, q, nxt, H, shift, gelu)
            torch.cuda.synchronize()
            assert fb.LAUNCHES == before + 2
            for a, b, c in zip(out, again, split):
                assert torch.equal(a, b), (shift, gelu)
                assert torch.equal(a, c), (shift, gelu)


@pytest.mark.cuda
def test_fused_block_stage_clock(cuda):
    """stage_ns gets the start and one mark per stage, in order; the clock
    changes no output."""
    x, xq, xs, q, nxt = _inputs(cuda, 2, 65, 128, 512, seed=3)
    stage_ns = torch.zeros(len(fb.STAGES) + 1, dtype=torch.int64, device=cuda)
    timed = fb.fused_vit_block(xq, xs, x, q, nxt, 2, 1.0, stage_ns=stage_ns)
    plain = fb.fused_vit_block(xq, xs, x, q, nxt, 2, 1.0)
    torch.cuda.synchronize()
    assert (stage_ns > 0).all() and (stage_ns.diff() >= 0).all(), stage_ns
    for a, b in zip(timed, plain):
        assert torch.equal(a, b)


def test_stages_match_kernel_source():
    """``fused_block.STAGES`` names the kernel's stages: as many as its
    kBlockStages, which is the last clock mark, one grid barrier before each
    later stage. stage_ns is checked on every device."""
    src = open(_SOURCE).read()
    stages = int(re.search(r"constexpr int kBlockStages = (\d+);", src).group(1))
    # each grid barrier is reached by both roles, from their own code
    barriers = sorted({int(k) for k in re.findall(r"\bbarrier\((\d+)\);", src)})
    assert len(fb.STAGES) == stages == 7
    assert barriers == list(range(1, stages))
    assert len(set(fb.STAGES)) == stages

    x, xq, xs, q, nxt = _inputs(torch.device("cpu"), 1, 5, 32, 64, seed=1)
    good = torch.zeros(stages + 1, dtype=torch.int64)
    fb.fused_vit_block(xq, xs, x, q, nxt, 2, stage_ns=good)
    assert (good == 0).all()  # the plain version leaves it alone
    for bad in (torch.zeros(stages, dtype=torch.int64),
                torch.zeros(stages + 1, dtype=torch.int32),
                torch.zeros(2 * (stages + 1), dtype=torch.int64)[::2]):
        with pytest.raises(ValueError, match="stage_ns"):
            fb.fused_vit_block(xq, xs, x, q, nxt, 2, stage_ns=bad)


def _np_block(rng, D, O1):
    """One block's pack as tests/test_fused_block.py builds it (numpy, JAX
    layout: wq is (in, out))."""
    from chess_vision_tpu.ops import quant as jq

    def dense(k, o):
        wq, ws = jq._quant_weight(
            rng.normal(size=(k, o)).astype(np.float32) / np.sqrt(k))
        return {"wq": np.asarray(wq), "scale": np.asarray(ws),
                "bias": rng.normal(size=(o,)).astype(np.float32) * 0.05}

    norm = lambda: {  # noqa: E731
        "scale": 1 + 0.1 * rng.normal(size=(D,)).astype(np.float32),
        "bias": 0.1 * rng.normal(size=(D,)).astype(np.float32)}
    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}


def test_plain_block_matches_jax_fused_kernel_at_ragged_shape():
    """130 tokens (the JAX kernel's other split, 128 + 2), 3 images, 4 heads
    of 16 (the smallest head dim) and the hard GELU with a fixed shift:
    ``fused_vit_block_plain`` (what a CPU tensor runs) against the JAX
    ``fused_vit_block`` in interpret mode, held to the bounds of
    tests/test_torch_fused_block.py's ``_assert_same_block``; a block with
    another GELU falls outside them. (The GPU machine cannot import the JAX
    package: it skips there.)"""
    jq = pytest.importorskip("chess_vision_tpu.ops.quant")
    import jax.numpy as jnp

    from chess_vision_tpu.ops import fused_block as jfb

    B, N, H, D, O1 = 3, 130, 4, 64, 256
    rng = np.random.default_rng(31)
    blk, nxt = _np_block(rng, D, O1), _np_block(rng, D, O1)["norm1"]
    x = rng.normal(size=(B, N, D)).astype(np.float32) * 0.5
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jxq, jxs = jq.fused_rowquant(jx, "ln", blk["norm1"]["scale"],
                                 blk["norm1"]["bias"], interpret=True)
    ref = jfb.fused_vit_block(
        jxq, jxs, jx, {k: {n: jnp.asarray(v) for n, v in p.items()}
                       for k, p in blk.items()},
        {k: jnp.asarray(v) for k, v in nxt.items()}, num_heads=H,
        softmax_shift=2.0, approx_gelu="hard", interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tq = {k: {n: t(v.T if n == "wq" else v) for n, v in p.items()}
          for k, p in blk.items()}
    tn = {k: t(v) for k, v in nxt.items()}
    tx = t(x).bfloat16()
    txq, txs = rq.fused_rowquant(tx, "ln", tq["norm1"]["scale"],
                                 tq["norm1"]["bias"])

    def diff(out):
        ox, oq, os_ = (np.asarray(v.float() if v.dtype == torch.bfloat16
                                  else v) for v in out)
        rx, rq_, rs = (np.asarray(a, np.float32) for a in ref)
        dx = np.abs(ox - rx)
        levels = np.abs(oq.astype(np.int32) - rq_.astype(np.int32))
        return (dx.max() < 0.1 and (dx > 1e-3).mean() < 0.30
                and (np.abs(os_ - rs) > 1e-6).mean() < 0.35
                and levels.max() <= 3 and (levels > 0).mean() < 0.12,
                dx.max(), (dx > 1e-3).mean(), levels.max(),
                (levels > 0).mean())

    out = fb.fused_vit_block_plain(txq, txs, tx, tq, tn, H, 2.0, gelu="hard")
    assert out[0].shape == (B, N, D) and out[1].dtype == torch.int8
    ok, *numbers = diff(out)
    assert ok, numbers
    wrong = fb.fused_vit_block_plain(txq, txs, tx, tq, tn, H, 2.0, gelu="erf")
    ok, *numbers = diff(wrong)
    assert not ok, numbers
