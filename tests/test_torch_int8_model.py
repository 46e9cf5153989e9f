"""The port's int8 (W8A8) ChessViT (chess_vision_tpu_torch/ops/quant.py, the
int8 pack bridge in convert/jax_params.py, serve.Predictor(quant="int8"))
against the JAX package's on the same weights and inputs.

On the CPU the JAX package's ``chessvit_int8_apply`` takes its plain-XLA
``_block`` branch, not the kernel path (the choice is gated on a TPU
backend), so the reference here composes the JAX "block" path by hand:
``fused_rowquant(ln)`` and ``_block_tpu`` per block in interpret mode, then
``_layernorm``, the 8x8 pool and the heads. ``_block_tpu`` reads
``CHESS_VISION_GELU`` when called; the tests set it to the port's argument.

Tolerances: the pack is byte-identical. Calibrated shifts within 1e-3 with
the same None pattern (the same f32 math in another summation order).
Logits of the whole forward within LOGITS_ATOL, the bound the port's bf16
model is held to (tests/test_torch_model.py): int8 codes may land one level
apart where a value sits on a rounding boundary (the op tests bound that to
under 1e-3 of the elements), each such flip moves an output by one
quantization step of its row, and without calibration both take the JAX
default "bound" shift, whose sums of squares the two packages add in other
orders. Through the two blocks of the tiny model the largest difference
measured 0.039 (a castling logit; logits reach 2.6) when the port took the
exact row max there.
FENs agree on every square whose top-2 margin exceeds twice the bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.models.common import combine_type_color as jax_combine
from chess_vision_tpu.models.layers import adaptive_avg_pool_nhwc as jax_pool
from chess_vision_tpu.ops import quant as jq
from chess_vision_tpu.ops.preprocess import preprocess_u8 as jax_preprocess
from chess_vision_tpu_torch import fen_to_labels
from chess_vision_tpu_torch.config import get_data_config
from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
from chess_vision_tpu_torch.ops import quant

torch.set_num_threads(2)

SIZE = 256
HEADS = 2
LOGITS_ATOL = 6.25e-2
CFG = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                 "input_size": SIZE, "embed_dim": 128, "depth": 2,
                 "num_heads": HEADS, "head_dropout": 0.0,
                 "drop_path_rate": 0.0},
       "training": {"mixed_precision": False}}


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


@pytest.fixture(scope="module")
def params():
    p = init_variables(jax_build_model(CFG), SIZE, seed=5)["params"]
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(6).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)


def _jax_forward(pack, images, shifts, gelu, monkeypatch):
    """The JAX "block" serving path, composed by hand (see module doc)."""
    monkeypatch.setenv("CHESS_VISION_GELU", gelu)
    x, G = jq._embed(pack, jnp.asarray(images))
    blocks = pack["blocks"]
    xq, xs = jq.fused_rowquant(x, "ln", blocks[0]["norm1"]["scale"],
                               blocks[0]["norm1"]["bias"], interpret=True)
    shifts = shifts or [None] * len(blocks)
    for i, q in enumerate(blocks):
        nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
        x, xq, xs = jq._block_tpu(x, xq, xs, q, nxt, num_heads=HEADS,
                                  interpret=True, softmax_shift=shifts[i])
    x = jq._layernorm(x, pack["norm"])
    B, _, D = x.shape
    pooled = jax_pool(x[:, 1:].reshape(B, G, G, D), (8, 8))
    heads = pack["heads"]
    dense = lambda t, p: jnp.dot(t, p["kernel"]) + p["bias"]  # noqa: E731
    return {
        "squares": np.asarray(jax_combine(dense(pooled, heads["type_head"]),
                                          dense(pooled, heads["color_head"])
                                          ).reshape(B, -1), np.float32),
        "turn": np.asarray(dense(x[:, 0], heads["turn_head"]), np.float32),
        "castling": np.asarray(dense(x[:, 0], heads["castling_head"]),
                               np.float32),
    }


def _confident(logits, atol):
    top2 = np.sort(logits.reshape(-1, 64, 13), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > 2 * atol


def test_pack_matches_jax_byte_for_byte(params):
    ours, ref = _flat(quant.quantize_chessvit(params)), _flat(
        jq.quantize_chessvit(params))
    assert ours.keys() == ref.keys()
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_quant_weight_matches_jax():
    w = np.random.default_rng(7).normal(size=(96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: scale floored at 1e-8
    for a, b in zip(quant._quant_weight(w), jq._quant_weight(w)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_int8_pack_bridge_round_trips(params):
    pack = jq.quantize_chessvit(params)
    tp = int8_pack_from_jax(pack)
    pe = tp["patch_embed"]
    P = pe["patch_size"]
    back = {
        "patch_embed": {"kernel": pe["weight"].numpy().T.reshape(P, P, 3, -1),
                        "bias": pe["bias"].numpy()},
        "cls_token": tp["cls_token"].numpy(),
        "pos_embed": tp["pos_embed"].numpy(),
        "norm": {k: v.numpy() for k, v in tp["norm"].items()},
        "heads": {h: {k: v.numpy() for k, v in p.items()}
                  for h, p in tp["heads"].items()},
        "blocks": [{name: {k: (v.numpy().T if k == "wq" else v.numpy())
                           for k, v in blk[name].items()}
                    for name in blk} for blk in tp["blocks"]],
    }
    want, got = _flat(pack), _flat(back)
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for blk in tp["blocks"]:
        for name in ("qkv", "proj", "fc1", "fc2"):
            wq = blk[name]["wq"]
            assert wq.dtype == torch.int8 and wq.is_contiguous()
            assert wq.shape[0] == blk[name]["scale"].shape[0]  # (O, K)


@pytest.mark.parametrize("margin,guard", [(40.0, 80.0), (0.0, 0.0)])
def test_calibrate_attn_shifts_matches_jax(params, images, margin, guard,
                                           monkeypatch):
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    pack = jq.quantize_chessvit(params)
    ref = jq.calibrate_attn_shifts(pack, images, HEADS, margin, guard)
    ours = quant.calibrate_attn_shifts(int8_pack_from_jax(pack),
                                       torch.from_numpy(images), HEADS,
                                       margin, guard, gelu="sigmoid")
    assert [s is None for s in ours] == [s is None for s in ref]
    for a, b in zip(ours, ref):
        if b is not None:
            assert abs(a - b) < 1e-3, (a, b)


@pytest.mark.parametrize("gelu,calibrated", [("sigmoid", False),
                                             ("sigmoid", True),
                                             ("erf", False), ("hard", False)])
def test_int8_forward_matches_jax_block_path(params, images, gelu, calibrated,
                                             monkeypatch):
    pack = jq.quantize_chessvit(params)
    shifts = None
    if calibrated:
        monkeypatch.setenv("CHESS_VISION_GELU", gelu)
        shifts = jq.calibrate_attn_shifts(pack, images, HEADS)
        assert all(isinstance(s, float) for s in shifts)
    ref = _jax_forward(pack, images, shifts, gelu, monkeypatch)
    out = quant.chessvit_int8_apply(int8_pack_from_jax(pack),
                                    torch.from_numpy(images), shifts,
                                    gelu=gelu, num_heads=HEADS)
    for key in ("squares", "turn", "castling"):
        assert out[key].dtype == torch.float32
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), ref[key],
                                   atol=LOGITS_ATOL, rtol=0, err_msg=key)
    confident = _confident(ref["squares"], LOGITS_ATOL)
    assert confident.mean() > 0.5
    ours = out["squares"].numpy().reshape(-1, 64, 13).argmax(-1)
    np.testing.assert_array_equal(
        ours[confident], ref["squares"].reshape(-1, 64, 13).argmax(-1)[confident])


def _boards(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


def _fens_agree(fens, logits):
    """FENs built from ``logits`` agree with ``fens`` on confident squares
    and on turns whose logit is clear of the tolerance."""
    ids = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    confident = _confident(logits["squares"], LOGITS_ATOL)
    ref_ids = logits["squares"].reshape(-1, 64, 13).argmax(-1)
    np.testing.assert_array_equal(ids[confident], ref_ids[confident])
    turn = np.array([f.split()[1] == "b" for f in fens])
    clear = np.abs(logits["turn"][:, 0]) > 2 * LOGITS_ATOL
    np.testing.assert_array_equal(turn[clear], (logits["turn"][:, 0] > 0)[clear])


def test_predictor_int8_matches_jax_block_path(params, tmp_path, monkeypatch):
    from PIL import Image

    from chess_vision_tpu_torch.serve import Predictor

    calib_u8 = _boards(2, seed=8)
    paths = []
    for i, img in enumerate(calib_u8):
        paths.append(str(tmp_path / f"calib{i}.png"))
        Image.fromarray(img).save(paths[-1])
    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    predictor = Predictor((CFG, params), batch_size=2, inflight=2,
                          device="cpu", quant="int8", calib_paths=paths)
    assert predictor.model is None and predictor.gelu == "sigmoid"

    # calibration: host-normalized f32 images, as the JAX Predictor
    data = get_data_config(CFG["model"]["name"])
    m = np.asarray(data["mean"], np.float32) * 255.0
    sd = np.asarray(data["std"], np.float32) * 255.0
    pack = jq.quantize_chessvit(params)
    ref_shifts = jq.calibrate_attn_shifts(
        pack, (calib_u8.astype(np.float32) - m) / sd, HEADS)
    assert len(predictor.attn_shifts) == len(ref_shifts)
    for a, b in zip(predictor.attn_shifts, ref_shifts):
        assert (a is None) == (b is None)
        assert b is None or abs(a - b) < 1e-3

    boards = _boards(3, seed=9)  # a padded tail batch
    fens = predictor.predict_array(boards)
    assert len(fens) == 3
    ref = _jax_forward(pack, np.asarray(jax_preprocess(
        jnp.asarray(boards), data["mean"], data["std"], jnp.bfloat16),
        np.float32), ref_shifts, "sigmoid", monkeypatch)
    _fens_agree(fens, ref)
