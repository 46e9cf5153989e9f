"""The port's flat int8 layout (chess_vision_tpu_torch/ops/attention.py
``fused_qkv_attention_quant_flat``, K5; ops/quant.py ``block_int8_flat`` and
``chessvit_int8_apply(layout="flat")``) against the JAX package's, on the
same inputs made with numpy. The port runs its plain PyTorch versions, which
is what a CPU tensor takes; the JAX side runs its Pallas kernels in interpret
mode, as tests/test_int8_flat.py does. The CUDA kernel is held against the
plain version on the card (test_torch_layout_kernels_cuda.py).

Tolerances: those of tests/test_torch_int8_attention.py for the attention
(dequantized output within 0.02 of the same softmax mode, the JAX default
"bound" shift without a calibrated one or "max" where named, and 0.04
across modes), and
LOGITS_ATOL of tests/test_torch_int8_model.py for the whole forward. Only
real rows are compared: what a padded row holds is never read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.models.common import combine_type_color as jax_combine
from chess_vision_tpu.models.layers import adaptive_avg_pool_nhwc as jax_pool
from chess_vision_tpu.ops import attention as jax_attn
from chess_vision_tpu.ops import quant as jq
from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

B, NP, N_REAL, H, DH = 2, 32, 27, 2, 64
D = H * DH
SIZE = 256
LOGITS_ATOL = 6.25e-2  # tests/test_torch_int8_model.py
CFG = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                 "input_size": SIZE, "embed_dim": 128, "depth": 3,
                 "num_heads": H, "head_dropout": 0.0, "drop_path_rate": 0.0},
       "training": {"mixed_precision": False}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(seed, q_gain=4.0):
    qkv = np.random.default_rng(seed).normal(size=(B, NP, 3 * D))
    qkv[:, :, :D] *= q_gain  # logits of O(10), as a trained checkpoint
    return qkv.astype(np.float32)


def _deq(q, s):
    return np.asarray(q, np.float32) * np.asarray(s, np.float32)


def _real(a):
    return np.asarray(a).reshape(B, NP, -1)[:, :N_REAL]


def test_flat_attention_matches_jax_modes(monkeypatch):
    qkv = _qkv(seed=1)
    jqkv = jnp.asarray(qkv.reshape(B * NP, 3 * D)).astype(jnp.bfloat16)
    oq, os_ = attn.fused_qkv_attention_quant_flat(
        _t(qkv.reshape(B * NP, 3 * D)).bfloat16(), B, N_REAL, H)
    assert oq.dtype == torch.int8 and oq.shape == (B * NP, D)
    assert os_.dtype == torch.float32 and os_.shape == (B * NP, 1)
    ours = _real(_deq(oq.numpy(), os_.numpy()))
    ours_max = _real(_deq(*(t.numpy() for t in
                            attn.fused_qkv_attention_quant_flat(
                                _t(qkv.reshape(B * NP, 3 * D)).bfloat16(), B,
                                N_REAL, H, shift_mode="max"))))
    ref_bound = _real(_deq(*jax_attn.fused_qkv_attention_quant_flat(
        jqkv, B, N_REAL, H, interpret=True)))
    monkeypatch.setenv("CHESS_VISION_ATTN_SOFTMAX", "max")
    ref_max = _real(_deq(*jax_attn.fused_qkv_attention_quant_flat(
        jqkv, B, N_REAL, H, interpret=True)))
    np.testing.assert_allclose(ours_max, ref_max, atol=0.02)
    np.testing.assert_allclose(ours, ref_bound, atol=0.02)
    np.testing.assert_allclose(ours_max, ref_bound, atol=0.04)


def test_flat_attention_fixed_shift_matches_jax():
    qkv = _qkv(seed=2)
    parts = qkv.reshape(B, NP, 3, H, DH)[:, :N_REAL]
    s = np.einsum("bqhd,bkhd->bhqk", parts[:, :, 0], parts[:, :, 1]) / 8
    shift = float(s.max()) - 40.0  # as calibrate_attn_shifts sets it
    flat = qkv.reshape(B * NP, 3 * D)
    ref = _deq(*jax_attn.fused_qkv_attention_quant_flat(
        jnp.asarray(flat).astype(jnp.bfloat16), B, N_REAL, H, interpret=True,
        softmax_shift=shift))
    ours = _deq(*(t.numpy() for t in attn.fused_qkv_attention_quant_flat(
        _t(flat).bfloat16(), B, N_REAL, H, shift)))
    np.testing.assert_allclose(_real(ours), _real(ref), atol=0.02)


@pytest.mark.parametrize("shift,mode", [(None, "max"), (-30.0, "max"),
                                        (None, "bound")],
                         ids=["max", "fixed", "bound"])
def test_padded_keys_never_reach_a_real_row(shift, mode):
    """Padded key and value rows set to large finite values change no real
    row, bit for bit (the bound leaves them out of its key norms); every
    row, padded ones included, stays finite. The
    real rows are those of the unpadded attention (K4's plain version) up to
    the order of the sums: PyTorch adds 32 terms, five of them exact zeros,
    in another order than 27, so a scale may differ in its last bit and a
    code on a rounding boundary by one level. (The kernel walks the same
    tiles for both and gives the same bits; the card test holds that.)"""
    qkv = _qkv(seed=3)
    loud = qkv.copy()
    loud[:, N_REAL:, D:] = 1e4  # padded keys and values
    run = lambda a: attn.fused_qkv_attention_quant_flat(  # noqa: E731
        _t(a.reshape(B * NP, 3 * D)).bfloat16(), B, N_REAL, H, shift, mode)
    (oq, os_), (lq, ls) = run(qkv), run(loud)
    np.testing.assert_array_equal(_real(oq.numpy()), _real(lq.numpy()))
    np.testing.assert_array_equal(_real(os_.numpy()), _real(ls.numpy()))
    assert torch.isfinite(os_).all() and torch.isfinite(ls).all()
    kq, ks = attn.fused_qkv_attention_quant(
        _t(qkv[:, :N_REAL]).bfloat16(), H, shift, mode)
    np.testing.assert_allclose(_real(os_.numpy()), ks.numpy(), rtol=1e-6)
    levels = np.abs(_real(oq.numpy()).astype(np.int32) - kq.numpy())
    assert levels.max() <= 1 and (levels > 0).mean() < 1e-3


def test_flat_attention_refuses_bad_shapes():
    qkv = _t(_qkv(seed=4).reshape(B * NP, 3 * D)).bfloat16()
    with pytest.raises(ValueError, match="images"):
        attn.fused_qkv_attention_quant_flat(qkv, 3, N_REAL, H)
    with pytest.raises(ValueError, match="n_real"):
        attn.fused_qkv_attention_quant_flat(qkv, B, NP + 1, H)
    before = attn.FLAT_LAUNCHES
    attn.fused_qkv_attention_quant_flat(qkv, B, N_REAL, H)
    assert attn.FLAT_LAUNCHES == before  # a CPU tensor: the plain version


def _rand_q(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _rand_s(rng, *shape):
    return rng.uniform(0.005, 0.02, shape).astype(np.float32)


def _blk(rng, hidden=256):
    """One block's pack as tests/test_int8_flat.py builds it (numpy, JAX
    layout: wq is (in, out))."""
    n = lambda loc, sd, k: rng.normal(loc, sd, k).astype(np.float32)  # noqa: E731
    dense = lambda k, o: {"wq": _rand_q(rng, k, o), "scale": _rand_s(rng, o),  # noqa: E731
                          "bias": n(0, 0.02, o)}
    return {"norm1": {"scale": np.ones(D, np.float32),
                      "bias": np.zeros(D, np.float32)},
            "norm2": {"scale": n(1, 0.05, D), "bias": n(0, 0.05, D)},
            "qkv": dense(D, 3 * D), "proj": dense(D, D),
            "fc1": dense(D, hidden), "fc2": dense(hidden, D)}


def _blk_unit(rng, hidden=512):
    """One block's pack as tests/test_fused_block.py builds it: f32 weights
    of unit-variance outputs, quantized by the JAX package; activations stay
    O(1), so a fixed softmax shift of a few units is in range."""
    def dense(k, o):
        wq, ws = jq._quant_weight(
            rng.normal(size=(k, o)).astype(np.float32) / np.sqrt(k))
        return {"wq": np.asarray(wq), "scale": np.asarray(ws),
                "bias": rng.normal(size=(o,)).astype(np.float32) * 0.05}

    norm = lambda: {  # noqa: E731
        "scale": 1 + 0.1 * rng.normal(size=(D,)).astype(np.float32),
        "bias": 0.1 * rng.normal(size=(D,)).astype(np.float32)}
    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, hidden),
            "fc2": dense(hidden, D)}


def _torch_blk(blk):
    return {name: {k: _t(v.T if k == "wq" else v) for k, v in p.items()}
            for name, p in blk.items()}


@pytest.mark.parametrize("make,shift,gain", [(_blk, None, 1.0),
                                             (_blk_unit, 2.5, 0.5)],
                         ids=["max", "calibrated"])
def test_flat_block_chain_matches_jax_and_block_layout(make, shift, gain,
                                                       monkeypatch):
    """Two flat blocks chained: real rows against the JAX flat chain in
    interpret mode, and bit for bit against the port's per-image chain."""
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    monkeypatch.setenv("CHESS_VISION_ATTN_SOFTMAX", "max")
    rng = np.random.default_rng(7)
    q0, q1 = make(rng), make(rng)
    x3 = rng.normal(0, gain, (B, N_REAL, D)).astype(np.float32)
    xpad = np.pad(x3, ((0, 0), (0, NP - N_REAL), (0, 0))).reshape(B * NP, D)

    j = lambda tree: {n: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
                      for n, p in tree.items()}
    jx = jnp.asarray(xpad).astype(jnp.bfloat16)
    fq, fs = jq.fused_rowquant(jx, "ln", q0["norm1"]["scale"],
                               q0["norm1"]["bias"], interpret=True)
    jx, fq, fs = jq._block_tpu_flat(jx, fq, fs, j(q0), j(q1)["norm1"],
                                    images=B, n_real=N_REAL, num_heads=H,
                                    interpret=True, softmax_shift=shift)
    jx, _, _ = jq._block_tpu_flat(jx, fq, fs, j(q1), None, images=B,
                                  n_real=N_REAL, num_heads=H, interpret=True,
                                  softmax_shift=shift)

    t0, t1 = _torch_blk(q0), _torch_blk(q1)
    x = _t(xpad).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", t0["norm1"]["scale"],
                               t0["norm1"]["bias"])
    row_max = quant.Int8Modes(softmax="max")  # the JAX side's, set above
    x, xq, xs = quant.block_int8_flat(x, xq, xs, t0, t1["norm1"], B, N_REAL,
                                      H, shift, modes=row_max)
    x, none_q, none_s = quant.block_int8_flat(x, xq, xs, t1, None, B, N_REAL,
                                              H, shift, modes=row_max)
    assert none_q is None and none_s is None
    ours = _real(x.float().numpy())
    # The first pack (random int8 weights, scales up to 0.02) drives the bf16
    # residual stream to magnitudes of several hundred, where one bf16 ulp is
    # 2 to 4; the second keeps it O(1). A code one level apart (a value on a rounding boundary; the
    # row-max shift rounds p at other values than the JAX kernel's) moves its
    # row by a quantization step. So the bounds are relative, the first the
    # JAX package's own for a chain (tests/test_fused_block.py:102), and
    # distributional: few elements off by more than one bf16 ulp.
    ref = _real(np.asarray(jx, np.float32))
    diff = np.abs(ours - ref)
    assert diff.max() / np.abs(ref).max() < 0.02, diff.max() / np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (diff > ulp).mean() < 0.05, (diff > ulp).mean()

    xb = _t(x3).bfloat16()
    bq, bs = rq.fused_rowquant(xb, "ln", t0["norm1"]["scale"],
                               t0["norm1"]["bias"])
    xb, bq, bs = quant.block_int8(xb, bq, bs, t0, t1["norm1"], H, shift,
                                  modes=row_max)
    xb, _, _ = quant.block_int8(xb, bq, bs, t1, None, H, shift, modes=row_max)
    np.testing.assert_array_equal(ours, xb.float().numpy())


def _jax_forward_flat(pack, images, shifts):
    """The JAX "flat" serving path composed by hand, as quant.py:596-613
    does on a TPU (on the CPU ``chessvit_int8_apply`` takes its XLA branch)."""
    x, G = jq._embed(pack, jnp.asarray(images))
    blocks = pack["blocks"]
    Bn, N, Dm = x.shape
    NPn = -(-N // 32) * 32
    x = jnp.pad(x, ((0, 0), (0, NPn - N), (0, 0))).reshape(Bn * NPn, Dm)
    xq, xs = jq.fused_rowquant(x, "ln", blocks[0]["norm1"]["scale"],
                               blocks[0]["norm1"]["bias"], interpret=True)
    for i, q in enumerate(blocks):
        nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
        x, xq, xs = jq._block_tpu_flat(x, xq, xs, q, nxt, images=Bn, n_real=N,
                                       num_heads=H, interpret=True,
                                       softmax_shift=shifts[i])
    x = jq._layernorm(x.reshape(Bn, NPn, Dm)[:, :N], pack["norm"])
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


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["row-max", "calibrated"])
def test_int8_forward_flat_layout_matches_jax(calibrated, monkeypatch):
    import jax

    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    params = jax.tree.map(np.asarray, init_variables(
        jax_build_model(CFG), SIZE, seed=5)["params"])
    images = np.random.default_rng(6).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    pack = jq.quantize_chessvit(params)
    shifts = [None] * len(pack["blocks"])
    if calibrated:
        shifts = jq.calibrate_attn_shifts(pack, images, H)
        assert all(isinstance(s, float) for s in shifts)
    ref = _jax_forward_flat(pack, images, shifts)
    tp = int8_pack_from_jax(pack)
    out = quant.chessvit_int8_apply(tp, _t(images), shifts, num_heads=H,
                                    layout="flat")
    for key in ("squares", "turn", "castling"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), ref[key],
                                   atol=LOGITS_ATOL, rtol=0, err_msg=key)
    # the flat layout computes what the block layout computes on real rows
    block = quant.chessvit_int8_apply(tp, _t(images), shifts, num_heads=H)
    for key in out:
        assert torch.equal(out[key], block[key]), key
