"""The port's whole-block int8 kernel and its layout
(chess_vision_tpu_torch/ops/fused_block.py, K14; ops/quant.py
``chessvit_int8_apply(layout="fused")``; ``serve.Predictor`` under
``CHESS_VISION_INT8_LAYOUT``) against the JAX package's, on the same weights
and inputs made with numpy. The port runs ``fused_vit_block_plain``, which is
what a CPU tensor takes; the JAX side runs its Pallas kernels in interpret
mode, as tests/test_fused_block.py does. The CUDA kernel is held against the
plain version on the card (test_torch_layout_kernels_cuda.py).

Tolerances: for one block the distributional bounds the JAX package holds
its own fused kernel to against its split kernels
(tests/test_fused_block.py:71-78), with the shares widened as
``_assert_same_block`` states and measures: an element on a rounding boundary
moves an int8 code by one and perturbs that row's LN and GELU downstream,
which touches some rows, where a fault in the math touches nearly every
element (a planted one must fail). For the whole forward, LOGITS_ATOL of
tests/test_torch_int8_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.models.common import combine_type_color as jax_combine
from chess_vision_tpu.models.layers import adaptive_avg_pool_nhwc as jax_pool
from chess_vision_tpu.ops import fused_block as jfb
from chess_vision_tpu.ops import quant as jq
from chess_vision_tpu_torch import fen_to_labels
from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
from chess_vision_tpu_torch.ops import fused_block as fb
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

B, N, D, H = 2, 129, 128, 2  # the JAX kernel needs 128 k + 1..2 tokens
SIZE = 256
LOGITS_ATOL = 6.25e-2  # tests/test_torch_int8_model.py
CFG = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                 "input_size": SIZE, "embed_dim": D, "depth": 3,
                 "num_heads": H, "head_dropout": 0.0, "drop_path_rate": 0.0},
       "training": {"mixed_precision": False}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mkblock(rng):
    """One block's pack as tests/test_fused_block.py builds it (numpy, JAX
    layout: wq is (in, out))."""
    def dense(k, o):
        wq, ws = jq._quant_weight(
            rng.normal(size=(k, o)).astype(np.float32) / np.sqrt(k))
        return {"wq": np.asarray(wq), "scale": np.asarray(ws),
                "bias": rng.normal(size=(o,)).astype(np.float32) * 0.05}

    norm = lambda: {  # noqa: E731
        "scale": 1 + 0.1 * rng.normal(size=(D,)).astype(np.float32),
        "bias": 0.1 * rng.normal(size=(D,)).astype(np.float32)}
    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, 4 * D),
            "fc2": dense(4 * D, D)}


def _torch_blk(blk):
    return {name: {k: _t(v.T if k == "wq" else v) for k, v in p.items()}
            for name, p in blk.items()}


def _jnp_blk(blk):
    return {name: {k: jnp.asarray(v) for k, v in p.items()}
            for name, p in blk.items()}


def _input(rng, q0):
    """The residual stream and block 0's quantized LN1 of it, for both
    packages (the two row quants agree: tests/test_torch_int8_rowquant.py)."""
    x = rng.normal(size=(B, N, D)).astype(np.float32) * 0.5
    tx = _t(x).bfloat16()
    txq, txs = rq.fused_rowquant(tx, "ln", _t(q0["norm1"]["scale"]),
                                 _t(q0["norm1"]["bias"]))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jxq, jxs = jq.fused_rowquant(jx, "ln", q0["norm1"]["scale"],
                                 q0["norm1"]["bias"], interpret=True)
    return (tx, txq, txs), (jx, jxq, jxs)


@pytest.mark.parametrize("shift,gelu,mode", [(None, "sigmoid", "max"),
                                             (3.0, "sigmoid", "bound"),
                                             (3.0, "erf", "bound"),
                                             (3.0, "hard", "bound")],
                         ids=["row-max", "calibrated", "erf", "hard"])
def test_fused_block_matches_jax_fused_kernel(shift, gelu, mode):
    check_fused_block(shift, gelu, mode)


def check_fused_block(shift, gelu, mode):
    """The port's K14 (plain) with ``shift``, ``gelu`` and ``shift_mode``
    against the JAX kernel in interpret mode, which takes the calibrated
    shift or its bound (tests/test_torch_int8_layouts.py runs the bound)."""
    rng = np.random.default_rng(21)
    q, nxt = _mkblock(rng), _mkblock(rng)["norm1"]
    (tx, txq, txs), (jx, jxq, jxs) = _input(rng, q)
    ref_x, ref_q, ref_s = jfb.fused_vit_block(
        jxq, jxs, jx, _jnp_blk(q), {k: jnp.asarray(v) for k, v in nxt.items()},
        num_heads=H, softmax_shift=shift, approx_gelu=gelu, interpret=True)
    before = fb.LAUNCHES
    out_x, out_q, out_s = fb.fused_vit_block(
        txq, txs, tx, _torch_blk(q), {k: _t(v) for k, v in nxt.items()}, H,
        shift, gelu=gelu, shift_mode=mode)
    assert fb.LAUNCHES == before  # a CPU tensor: the plain version
    assert out_x.dtype == torch.bfloat16 and out_x.shape == (B, N, D)
    assert out_q.dtype == torch.int8 and out_s.shape == (B, N, 1)
    levels, bounds = _block_diff((out_x, out_q, out_s), (ref_x, ref_q, ref_s))
    if shift is None and mode == "max":
        # the port's exact row max against the JAX "bound" shift: the same
        # softmax with p rounded to bf16 at other values, which moves most
        # elements a little (as two calibrated shifts do); bounded by size
        assert bounds["max_dx"] < 0.1 and bounds["mean_dx"] < 0.01, bounds
        assert bounds["max_deq"] < 0.1, bounds  # LN outputs reach 4.6
        return
    _assert_same_block(levels, bounds)
    # a planted fault falls outside: the block with another GELU
    wrong = fb.fused_vit_block(
        txq, txs, tx, _torch_blk(q), {k: _t(v) for k, v in nxt.items()}, H,
        shift, gelu="hard" if gelu == "erf" else "erf", shift_mode=mode)
    with pytest.raises(AssertionError):
        _assert_same_block(*_block_diff(wrong, (ref_x, ref_q, ref_s)))


def _block_diff(out, ref):
    out_x, out_q, out_s = (np.asarray(t.float() if t.dtype == torch.bfloat16
                                      else t) for t in out)
    ref_x, ref_q, ref_s = (np.asarray(a, np.float32) for a in ref)
    dx = np.abs(out_x - ref_x)
    levels = np.abs(out_q.astype(np.int32) - ref_q.astype(np.int32))
    return levels, {"max_dx": dx.max(), "mean_dx": dx.mean(),
                    "share_dx": (dx > 1e-3).mean(),
                    "share_ds": (np.abs(out_s - ref_s) > 1e-6).mean(),
                    "max_deq": np.abs(out_q * out_s - ref_q * ref_s).max()}


def _assert_same_block(levels, bounds):
    """The criteria of tests/test_fused_block.py:71-78 with the shares
    widened for two frameworks: there the fused and the split kernel share
    XLA's exp and sum order, and under 5% of the elements move; here
    PyTorch's exp and sums differ in the last bit, more values cross a
    rounding boundary, and each crossing perturbs its whole 128-wide row
    through the LN. Measured: max |dx| 0.031, 20% of x past 1e-3, codes at
    most 3 apart and 8% differing; another GELU or softmax shift reads
    0.80-0.98 of x past 1e-3 and 36-86% of the codes."""
    assert bounds["max_dx"] < 0.1, bounds
    assert bounds["share_dx"] < 0.30, bounds
    assert bounds["share_ds"] < 0.35, bounds
    assert levels.max() <= 3, levels.max()
    assert (levels > 0).mean() < 0.12, (levels > 0).mean()


def test_fused_block_is_the_split_chain_and_needs_next_ln():
    """The whole block computes what ``block_int8`` computes, bit for bit (the
    JAX kernel is written against ``_block_tpu`` in the same way), and the
    last block, which has no next LayerNorm, is refused."""
    rng = np.random.default_rng(24)
    q, nxt = _torch_blk(_mkblock(rng)), _torch_blk(_mkblock(rng))["norm1"]
    x = _t(rng.normal(size=(B, 33, D)).astype(np.float32) * 0.5).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"], q["norm1"]["bias"])
    for shift in (None, 2.0):
        fused = fb.fused_vit_block(xq, xs, x, q, nxt, H, shift)
        split = quant.block_int8(x, xq, xs, q, nxt, H, shift)
        for a, b in zip(fused, split):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="next block's norm1"):
        fb.fused_vit_block(xq, xs, x, q, None, H)
    with pytest.raises(ValueError, match="unknown gelu"):
        fb.fused_vit_block(xq, xs, x, q, nxt, H, gelu="tanh")


@pytest.mark.parametrize("shifts", [[2.5, 3.0, 2.0], [None, None, None],
                                    [2.5, None, 2.0]],
                         ids=["calibrated", "row-max", "mixed"])
def test_fused_stack_equals_unrolled_blocks(shifts):
    rng = np.random.default_rng(23)
    qs = [_mkblock(rng) for _ in range(4)]
    (tx, txq, txs), (jx, jxq, jxs) = _input(rng, qs[0])
    tq = [_torch_blk(q) for q in qs]
    ux, uq, us = tx, txq, txs
    for i in range(3):
        ux, uq, us = fb.fused_vit_block(uq, us, ux, tq[i], tq[i + 1]["norm1"],
                                        H, shifts[i])
    sx, sq, ss = fb.fused_vit_stack(txq, txs, tx, tq[:3],
                                    [q["norm1"] for q in tq[1:]], shifts, H)
    assert torch.equal(sx, ux) and torch.equal(sq, uq) and torch.equal(ss, us)
    if None in shifts and shifts != [None] * 3:
        return  # the JAX stack needs one shift mode for all layers
    jqs = [_jnp_blk(q) for q in qs]
    rx, _, _ = jfb.fused_vit_stack(jxq, jxs, jx, jqs[:3],
                                   [q["norm1"] for q in jqs[1:]], shifts,
                                   num_heads=H, approx_gelu="sigmoid",
                                   interpret=True)
    r = np.asarray(rx, np.float32)
    # the JAX package's own bound for a chain (tests/test_fused_block.py:102)
    assert np.abs(sx.float().numpy() - r).max() / np.abs(r).max() < 0.02


def _jax_forward_fused(pack, images, shifts):
    """The JAX "fused" serving path composed by hand, as quant.py:567-595
    does on a TPU: fused blocks, then the last block on the split kernels."""
    x, G = jq._embed(pack, jnp.asarray(images))
    blocks = pack["blocks"]
    xq, xs = jq.fused_rowquant(x, "ln", blocks[0]["norm1"]["scale"],
                               blocks[0]["norm1"]["bias"], interpret=True)
    for i, q in enumerate(blocks[:-1]):
        x, xq, xs = jfb.fused_vit_block(
            xq, xs, x, q, blocks[i + 1]["norm1"], num_heads=H,
            softmax_shift=shifts[i], approx_gelu="sigmoid", interpret=True)
    x, _, _ = jq._block_tpu(x, xq, xs, blocks[-1], None, num_heads=H,
                            interpret=True, softmax_shift=shifts[-1])
    x = jq._layernorm(x, pack["norm"])
    Bn, _, Dm = x.shape
    pooled = jax_pool(x[:, 1:].reshape(Bn, G, G, Dm), (8, 8))
    heads = pack["heads"]
    dense = lambda t, p: jnp.dot(t, p["kernel"]) + p["bias"]  # noqa: E731
    return {
        "squares": np.asarray(jax_combine(dense(pooled, heads["type_head"]),
                                          dense(pooled, heads["color_head"])
                                          ).reshape(Bn, -1), np.float32),
        "turn": np.asarray(dense(x[:, 0], heads["turn_head"]), np.float32),
        "castling": np.asarray(dense(x[:, 0], heads["castling_head"]),
                               np.float32),
    }


@pytest.fixture(scope="module")
def params():
    p = init_variables(jax_build_model(CFG), SIZE, seed=5)["params"]
    return jax.tree.map(np.asarray, p)


def test_int8_forward_fused_layout_matches_jax(params, monkeypatch):
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    images = np.random.default_rng(6).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)  # 257 tokens
    pack = jq.quantize_chessvit(params)
    shifts = jq.calibrate_attn_shifts(pack, images, H)
    assert all(isinstance(s, float) for s in shifts)
    ref = _jax_forward_fused(pack, images, shifts)
    tp = int8_pack_from_jax(pack)
    out = quant.chessvit_int8_apply(tp, _t(images), shifts, num_heads=H,
                                    layout="fused")
    for key in ("squares", "turn", "castling"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), ref[key],
                                   atol=LOGITS_ATOL, rtol=0, err_msg=key)
    block = quant.chessvit_int8_apply(tp, _t(images), shifts, num_heads=H)
    for key in out:
        assert torch.equal(out[key], block[key]), key
    with pytest.raises(ValueError, match="unknown int8 layout"):
        quant.chessvit_int8_apply(tp, _t(images), shifts, num_heads=H,
                                  layout="nosuch")


def test_predictor_serves_flat_and_fused_layouts(params, monkeypatch):
    """``Predictor(quant="int8")`` reads CHESS_VISION_INT8_LAYOUT once, when
    it is built; flat, fused, xla and hybrid give the block layout's FENs on
    squares with a confident margin; an unknown value raises."""
    from chess_vision_tpu_torch.serve import Predictor

    boards = np.random.default_rng(9).integers(
        0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)  # a padded tail batch
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    fens, used = {}, {"flat": [], "fused": [], "block": []}
    for layout in ("block", "flat", "fused"):
        if layout == "block":
            monkeypatch.delenv("CHESS_VISION_INT8_LAYOUT", raising=False)
        else:
            monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", layout)
        predictor = Predictor((CFG, params), batch_size=2, inflight=2,
                              device="cpu", quant="int8")
        assert predictor.layout == layout
        monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", "nosuch")  # read once
        real = {"flat": quant._blocks_flat, "fused": quant._blocks_fused}
        for name, fn in real.items():
            monkeypatch.setattr(
                quant, fn.__name__,
                lambda *a, _n=name, _f=fn, _l=layout: (used[_l].append(_n),
                                                       _f(*a))[1])
        fens[layout] = predictor.predict_array(boards)
        for fn in real.values():
            monkeypatch.setattr(quant, fn.__name__, fn)
    assert used == {"block": [], "flat": ["flat"] * 2, "fused": ["fused"] * 2}

    pack = int8_pack_from_jax(quant.quantize_chessvit(params))
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.ops.preprocess import preprocess_u8

    data = get_data_config(CFG["model"]["name"])
    logits = quant.chessvit_int8_apply(
        pack, preprocess_u8(_t(boards), data["mean"], data["std"],
                            torch.bfloat16), num_heads=H)["squares"].numpy()
    top2 = np.sort(logits.reshape(-1, 64, 13), axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 2 * LOGITS_ATOL
    assert confident.mean() > 0.5
    ids = {k: np.stack([fen_to_labels(f.split()[0]) for f in v])
           for k, v in fens.items()}
    for layout in ("flat", "fused"):
        assert len(fens[layout]) == 3
        np.testing.assert_array_equal(ids[layout][confident],
                                      ids["block"][confident])

    # the JAX package's other two layouts serve too (the XLA-form scheme:
    # the same FENs on the confident squares), an unknown one raises
    for layout in ("xla", "hybrid"):
        monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", layout)
        predictor = Predictor((CFG, params), batch_size=2, device="cpu",
                              quant="int8")
        assert predictor.layout == layout
        served = np.stack([fen_to_labels(f.split()[0])
                           for f in predictor.predict_array(boards)])
        np.testing.assert_array_equal(served[confident],
                                      ids["block"][confident])
    monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", "nosuch")
    with pytest.raises(ValueError, match="unknown int8 layout"):
        Predictor((CFG, params), batch_size=2, device="cpu", quant="int8")
    # the bf16 Predictor does not read the variable
    assert Predictor((CFG, params), batch_size=2, device="cpu").layout is None
