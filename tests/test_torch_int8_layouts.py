"""The int8 path's serving modes and its hybrid and xla layouts
(chess_vision_tpu_torch/ops/quant.py ``Int8Modes``, ``int8_modes``,
``_block_hybrid``, ``_block``; ops/int8_matmul.py's bf16 epilogue;
``serve.Predictor``; ops/attention.py's shift rules) against the JAX
package's, on the same weights and
inputs made with numpy. The port runs its plain PyTorch versions, which is
what a CPU tensor takes; the JAX side runs its Pallas kernels in interpret
mode, composed by hand as tests/test_torch_int8_model.py does (on the CPU
the JAX ``chessvit_int8_apply`` takes its XLA branch whatever the layout).

Tolerances: K8's bf16 epilogue within one int8 level in under 1e-3 of the
codes, scales rtol 1e-5 (no code differs at these shapes, read on the CPU);
one hybrid or xla block within 2% of the output's largest magnitude and one
bf16 ulp on all but 5% of it (tests/test_torch_int8_flat.py's block-chain
bounds); the whole int8 model in each mode within LOGITS_ATOL of
tests/test_torch_int8_model.py, with the same argmax FEN on every square of
the tests' boards (``check_model``, which
tests/test_torch_int8_model_{modes,legs,layouts}.py run).
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
from chess_vision_tpu.ops import int8_matmul as jmm
from chess_vision_tpu.ops import quant as jq
from chess_vision_tpu.ops import attention as jax_attn
from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

from test_torch_fused_block import check_fused_block
from test_torch_int8_modes import NP, _assert_within_a_level, _qkv

torch.set_num_threads(2)

B, N, H, DH = 2, 33, 4, 64
D = H * DH
SIZE = 64  # 17 tokens
LOGITS_ATOL = 6.25e-2  # tests/test_torch_int8_model.py
CFG = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                 "input_size": SIZE, "embed_dim": 128, "depth": 2,
                 "num_heads": 2, "head_dropout": 0.0, "drop_path_rate": 0.0},
       "training": {"mixed_precision": False}}
MODE_VARS = ("CHESS_VISION_ATTN_SOFTMAX", "CHESS_VISION_ATTN_QK",
             "CHESS_VISION_ATTN_EXP", "CHESS_VISION_EPILOGUE")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_pack(rng, width=D):
    def dense(k, o):
        wq, ws = jq._quant_weight(
            rng.normal(size=(k, o)).astype(np.float32) / np.sqrt(k))
        return {"wq": np.asarray(wq), "scale": np.asarray(ws),
                "bias": rng.normal(size=(o,)).astype(np.float32) * 0.05}

    norm = lambda: {  # noqa: E731
        "scale": 1 + 0.1 * rng.normal(size=(width,)).astype(np.float32),
        "bias": 0.1 * rng.normal(size=(width,)).astype(np.float32)}
    return {"norm1": norm(), "norm2": norm(), "qkv": dense(width, 3 * width),
            "proj": dense(width, width), "fc1": dense(width, 4 * width),
            "fc2": dense(4 * width, width)}


def _torch_blk(blk):
    return {name: {k: _t(v.T if k == "wq" else v) for k, v in p.items()}
            for name, p in blk.items()}


def _jnp_blk(blk):
    return {name: {k: jnp.asarray(v) for k, v in p.items()}
            for name, p in blk.items()}


def test_mode_readers_take_the_jax_values(monkeypatch):
    for name in (*MODE_VARS, "CHESS_VISION_INT8_LAYOUT"):
        monkeypatch.delenv(name, raising=False)
    assert quant.int8_modes() == quant.Int8Modes("bound", "bf16", "f32", "f32")
    assert quant.int8_layout() == "block"
    values = {"CHESS_VISION_ATTN_SOFTMAX": ("bound", "fixed", "max"),
              "CHESS_VISION_ATTN_QK": ("bf16", "int8", "int8pv"),
              "CHESS_VISION_ATTN_EXP": ("f32", "bf16"),
              "CHESS_VISION_EPILOGUE": ("f32", "bf16")}
    fields = ("softmax", "attn_qk", "attn_exp", "epilogue")
    for field, name in zip(fields, MODE_VARS):
        for value in values[name]:
            monkeypatch.setenv(name, value)
            assert getattr(quant.int8_modes(), field) == value
        monkeypatch.setenv(name, "nosuch")
        with pytest.raises(ValueError, match=name):
            quant.int8_modes()
        monkeypatch.delenv(name)
    for layout in quant.LAYOUTS:
        monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", layout)
        assert quant.int8_layout() == layout
    with pytest.raises(ValueError, match="softmax"):
        quant.Int8Modes(softmax="nosuch")
    assert quant.Int8Modes(attn_qk="int8pv").attention() == (
        "bound", True, True, False)
    # the JAX package's fall-back of the fused layout (quant.py:557-566)
    assert quant.Int8Modes().fused_ok() and quant.Int8Modes("fixed").fused_ok()
    assert not quant.Int8Modes("max").fused_ok()
    assert not quant.Int8Modes(attn_qk="int8").fused_ok()


@pytest.mark.parametrize("gelu", ["sigmoid", "erf", "hard"])
def test_bf16_epilogue_matches_jax(gelu, monkeypatch):
    """K8 with CHESS_VISION_EPILOGUE=bf16: the GELU on bf16 values, the amax
    in bf16, the codes from f32 (int8_matmul.py:147-155)."""
    rng = np.random.default_rng(11)
    xq = rng.integers(-127, 128, (B, N, 128)).astype(np.int8)
    xs = (rng.random((B, N, 1)) * 0.05 + 0.01).astype(np.float32)
    wq = rng.integers(-127, 128, (128, 512)).astype(np.int8)
    ws = (rng.random(512) * 0.005).astype(np.float32)
    bias = (rng.standard_normal(512) * 0.5).astype(np.float32)
    monkeypatch.setenv("CHESS_VISION_EPILOGUE", "bf16")
    rq_, rs = jmm.int8_matmul_gelu_quant(
        *(jnp.asarray(a) for a in (xq, xs, wq, ws, bias)), interpret=True,
        approx_gelu=gelu)
    before = mm.LAUNCHES["gelu_quant"]
    q, s = mm.int8_matmul_gelu_quant(_t(xq), _t(xs), _t(wq.T), _t(ws),
                                     _t(bias), gelu, bf16_epilogue=True)
    assert mm.LAUNCHES["gelu_quant"] == before
    levels = np.abs(q.numpy().astype(np.int32) - np.asarray(rq_, np.int32))
    assert levels.max() <= 1 and (levels > 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5)
    f32 = mm.int8_matmul_gelu_quant(_t(xq), _t(xs), _t(wq.T), _t(ws),
                                    _t(bias), gelu)
    assert not torch.equal(f32[0], q)  # the epilogue changes the codes


def _block_input(rng, q0):
    x = rng.normal(size=(B, N, D)).astype(np.float32) * 0.5
    return _t(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)


def _assert_same_block(ours, ref):
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    diff = np.abs(ours - ref)
    assert diff.max() / np.abs(ref).max() < 0.02, diff.max() / np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (diff > ulp).mean() < 0.05, (diff > ulp).mean()


@pytest.mark.parametrize("gelu", ["sigmoid", "erf"])
def test_hybrid_and_xla_blocks_match_jax(gelu, monkeypatch):
    """One block of the hybrid layout against the JAX ``_block_hybrid`` (its
    row quants in interpret mode) and one of the xla layout against the JAX
    ``_block``; the hybrid block's row quants run K7 (``fused_rowquant``) in
    its ln, none and GELU forms."""
    monkeypatch.setenv("CHESS_VISION_GELU", gelu)
    rng = np.random.default_rng(12)
    q = _block_pack(rng)
    tx, jx = _block_input(rng, q)
    modes = []
    real = rq.fused_rowquant
    monkeypatch.setattr(rq, "fused_rowquant",
                        lambda x, mode="none", *a, **k: (modes.append(mode),
                                                         real(x, mode, *a, **k))[1])
    ours = quant._block_hybrid(tx, _torch_blk(q), H, gelu)
    assert modes == ["ln", "none", "ln", quant._GELU_ROWQUANT[gelu]]
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, N, D)
    _assert_same_block(ours, jq._block_hybrid(jx, _jnp_blk(q), H,
                                              interpret=True))
    xla = quant._block(tx, _torch_blk(q), H, gelu)
    _assert_same_block(xla, jq._block(jx, _jnp_blk(q), H))


@pytest.fixture(scope="module")
def params():
    p = init_variables(jax_build_model(CFG), SIZE, seed=5)["params"]
    return jax.tree.map(np.asarray, p)


def _jax_forward(pack, images, layout, env=()):
    """The JAX serving path of ``layout`` composed by hand, as quant.py:
    541-622 runs it on a TPU, under the mode variables already set (``env``
    names them, for the key of a jitted program: the JAX code reads them
    while it traces). At 17
    tokens the JAX fused layout falls back to the block layout (its kernel
    needs 128 k + 1..2 tokens): the reference of the port's fused layout,
    whose whole-block kernel computes the split chain's bits."""
    x, G = jq._embed(pack, jnp.asarray(images))
    blocks = pack["blocks"]
    heads = CFG["model"]["num_heads"]
    Bn, Nt, Dm = x.shape
    if layout in ("hybrid", "xla"):
        for q in blocks:
            x = (jq._block_hybrid(x, q, heads, interpret=True)
                 if layout == "hybrid" else jq._block(x, q, heads))
    else:
        flat = layout == "flat"
        NP = -(-Nt // 32) * 32
        if flat:
            x = jnp.pad(x, ((0, 0), (0, NP - Nt), (0, 0))).reshape(Bn * NP, Dm)
        xq, xs = jq.fused_rowquant(x, "ln", blocks[0]["norm1"]["scale"],
                                   blocks[0]["norm1"]["bias"], interpret=True)
        for i, q in enumerate(blocks):
            nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
            if flat:
                x, xq, xs = jq._block_tpu_flat(x, xq, xs, q, nxt, images=Bn,
                                               n_real=Nt, num_heads=heads,
                                               interpret=True)
            else:
                x, xq, xs = jq._block_tpu(x, xq, xs, q, nxt, num_heads=heads,
                                          interpret=True)
        if flat:
            x = x.reshape(Bn, NP, Dm)[:, :Nt]
    x = jq._layernorm(x, pack["norm"])
    pooled = jax_pool(x[:, 1:].reshape(Bn, G, G, Dm), (8, 8))
    hd = pack["heads"]
    dense = lambda t, p: jnp.dot(t, p["kernel"]) + p["bias"]  # noqa: E731
    return {"squares": jax_combine(dense(pooled, hd["type_head"]),
                                   dense(pooled, hd["color_head"])
                                   ).reshape(Bn, -1),
            "turn": dense(x[:, 0], hd["turn_head"]),
            "castling": dense(x[:, 0], hd["castling_head"])}


def check_model(layout, env, params, monkeypatch):
    """The whole int8 model under ``layout`` and the mode variables ``env``
    against the JAX composition of the same: logits within LOGITS_ATOL, the
    argmax FEN the same on every square. tests/test_torch_int8_model_*.py
    run it in every mode and layout, a few to a file.)"""
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    for name in MODE_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    images = np.random.default_rng(6).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    pack = jq.quantize_chessvit(params)
    # one jitted program: the interpret-mode kernels compile into it once
    ref = jax.jit(_jax_forward, static_argnums=(2, 3))(
        pack, images, layout, tuple(sorted(env.items())))
    ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    out = quant.chessvit_int8_apply(
        int8_pack_from_jax(pack), _t(images), None, num_heads=2,
        layout=layout, modes=quant.int8_modes())
    for key in ("squares", "turn", "castling"):
        np.testing.assert_allclose(out[key].numpy(), ref[key],
                                   atol=LOGITS_ATOL, rtol=0, err_msg=key)
    np.testing.assert_array_equal(
        out["squares"].numpy().reshape(-1, 64, 13).argmax(-1),
        ref["squares"].reshape(-1, 64, 13).argmax(-1))


def test_predictor_reads_the_modes_once(params, monkeypatch):
    """``Predictor(quant="int8")`` reads the four mode variables once, when
    it is built, and passes them down; an unknown value raises; the fused
    layout falls back to the block layout under the int8 legs or the row
    max, as in the JAX package; the flat layout's GELU kernel takes no bf16
    epilogue (the JAX K11 has none)."""
    from chess_vision_tpu_torch.serve import Predictor

    boards = np.random.default_rng(9).integers(0, 256, (2, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", "fused")
    monkeypatch.setenv("CHESS_VISION_ATTN_QK", "int8")
    predictor = Predictor((CFG, params), batch_size=2, device="cpu",
                          quant="int8")
    assert predictor.int8_modes == quant.Int8Modes(attn_qk="int8")
    monkeypatch.setenv("CHESS_VISION_ATTN_QK", "nosuch")  # read once
    fused, legs = [], []
    monkeypatch.setattr(quant, "_blocks_fused",
                        lambda *a: fused.append(1))
    real = quant.attn_ops.fused_qkv_attention_quant
    monkeypatch.setattr(quant.attn_ops, "fused_qkv_attention_quant",
                        lambda *a: (legs.append(a[4]), real(*a))[1])
    assert len(predictor.predict_array(boards)) == 2
    assert fused == [] and legs == [True, True]  # block layout, int8 legs
    with pytest.raises(ValueError, match="CHESS_VISION_ATTN_QK"):
        Predictor((CFG, params), batch_size=2, device="cpu", quant="int8")

    rng = np.random.default_rng(13)
    q0, q1 = _torch_blk(_block_pack(rng, 128)), _torch_blk(_block_pack(rng, 128))
    x = _t(rng.normal(size=(2 * 32, 128)).astype(np.float32)).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", q0["norm1"]["scale"],
                               q0["norm1"]["bias"])
    runs = [quant.block_int8_flat(x, xq, xs, q0, q1["norm1"], 2, 17, 2,
                                  modes=quant.Int8Modes(epilogue=e))
            for e in ("f32", "bf16")]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_shift_rules_follow_jax(monkeypatch):
    """A calibrated shift overrides the mode; the bound and the fixed shift
    need a power-of-two softmax scale (head dim 32 has none: the exact row
    max); the int8 legs take the exact row max whatever the mode."""
    assert attn._shift("bound", None, 64) == ("bound", 0.0)
    assert attn._shift("max", 2.5, 64) == ("fixed", 2.5)
    assert attn._shift("fixed", None, 64) == ("fixed", attn.FIXED_SHIFT)
    assert attn._shift("bound", 2.5, 32) == ("max", 0.0)
    assert attn._shift("fixed", None, 64, legacy=True) == ("max", 0.0)
    with pytest.raises(ValueError, match="softmax shift mode"):
        attn._shift("nosuch", None, 64)
    qkv = np.random.default_rng(4).normal(size=(B, 17, 3 * 2 * 32)).astype(
        np.float32)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    for mode in ("bound", "fixed"):
        monkeypatch.setenv("CHESS_VISION_ATTN_SOFTMAX", mode)
        ref = jax_attn.fused_qkv_attention_quant(jq, 2, interpret=True)
        ours = attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), 2,
                                              shift_mode=mode)
        ours_max = attn.fused_qkv_attention_quant(_t(qkv).bfloat16(), 2,
                                                  shift_mode="max")
        assert all(torch.equal(a, b) for a, b in zip(ours, ours_max))
        _assert_within_a_level(*(t.numpy() for t in ours),
                               *(np.asarray(r) for r in ref))


def test_modes_on_cpu_tensors_take_the_plain_versions():
    qkv = _t(_qkv(seed=5)).bfloat16()
    flat = _t(_qkv(seed=5, rows=NP).reshape(B * NP, 3 * D)).bfloat16()
    before = (attn.QUANT_LAUNCHES, attn.FLAT_LAUNCHES, attn.QUANT_I8_LAUNCHES)
    for kw in ({}, {"shift_mode": "fixed"}, {"exp_bf16": True},
               {"qk_int8": True}, {"qk_int8": True, "pv_int8": True}):
        ours = attn.fused_qkv_attention_quant(qkv, H, **kw)
        ref = attn.reference_attention_quant(qkv, H, **kw)
        assert all(torch.equal(a, b) for a, b in zip(ours, ref)), kw
        ours = attn.fused_qkv_attention_quant_flat(flat, B, N, H, **kw)
        ref = attn.reference_attention_quant_flat(flat, B, N, H, **kw)
        assert all(torch.equal(a, b) for a, b in zip(ours, ref)), kw
    after = (attn.QUANT_LAUNCHES, attn.FLAT_LAUNCHES, attn.QUANT_I8_LAUNCHES)
    assert after == before
    with pytest.raises(ValueError, match="softmax shift mode"):
        attn.fused_qkv_attention_quant(qkv, H, shift_mode="nosuch")


def test_fused_block_bound_matches_jax():
    """K14 without a calibrated shift takes the JAX kernel's bound
    (fused_block.py:138-142), held to the JAX fused kernel within the bounds
    of tests/test_torch_fused_block.py's calibrated cases."""
    check_fused_block(None, "sigmoid", "bound")
