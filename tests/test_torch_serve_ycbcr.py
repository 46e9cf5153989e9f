"""The port's 4:2:0 serving form (chess_vision_tpu_torch/serve.py
``mode="ycbcr420"``, ``ops/preprocess.rgb_to_ycbcr420_batch``) against the
JAX package's ``Predictor(mode="ycbcr420")``, ``make_infer_fn`` and
``make_int8_infer_fn`` on tiny checkpoints written by the JAX package
(embed 64, 2 blocks, 4 heads, 64 px).

Tolerances: the host conversion is byte-equal. At f32 the logits of the
plane path agree within 1e-4 (the conversion's two bilinear upsamples and
the model, each the same f32 math in another summation order) and the FENs
are identical. In bf16 the argmax outputs are identical wherever the JAX
logits are further than BF16_ATOL (the port's bf16 model bound,
tests/test_torch_model.py) from a tie: the two bf16 forwards round at other
points. In int8 they are identical, against the JAX package's "block"
layout composed by hand in interpret mode (on the CPU its
``chessvit_int8_apply`` takes the XLA form, another scheme), without
calibration."""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chess_vision_tpu_torch.ops  # noqa: F401  (the first exp on one thread)
from chess_vision_tpu_torch.ops import preprocess as pre

torch.set_num_threads(2)

SIZE = 64
BF16_ATOL = 6.25e-2  # the port's bf16 model against the JAX one
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


def _cfg(mixed: bool) -> dict:
    return {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                      "input_size": SIZE, "embed_dim": 64, "depth": 2,
                      "num_heads": 4, "head_dropout": 0.0,
                      "drop_path_rate": 0.0},
            "training": {"mixed_precision": mixed}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(f32 checkpoint, bf16 checkpoint, board files): 6 generated JPEGs and
    one PNG copy (which the native 4:2:0 decoder does not take)."""
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from chess_vision_tpu.datagen.generate import generate_split
    from chess_vision_tpu.models import build_model
    from chess_vision_tpu.utils.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("torch_serve_ycbcr")
    img_dir = str(d / "imgs")
    generate_split(img_dir, [("game", 4), ("random", 2)], size=SIZE, seed=8,
                   workers=1)
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.endswith(".jpg"))
    png = os.path.join(img_dir, "copy.png")
    Image.open(paths[0]).convert("RGB").save(png)
    ckpts = []
    for mixed in (False, True):
        cfg = _cfg(mixed)
        variables = build_model(cfg).init(
            {"params": jax.random.key(7), "dropout": jax.random.key(1)},
            jnp.zeros((1, SIZE, SIZE, 3)), train=False)
        path = str(d / f"ckpt_{'bf16' if mixed else 'f32'}.msgpack")
        save_checkpoint(path, variables["params"], {}, {}, step=1, epoch=0,
                        best_val_acc=0.0, config=cfg)
        ckpts.append(path)
    return ckpts[0], ckpts[1], paths + [png]


def _boards(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("native_lib", [True, False])
def test_batch_conversion_is_the_per_image_one_byte_for_byte(native_lib,
                                                             monkeypatch):
    """The native library's loop, and the per-image function without it."""
    from chess_vision_tpu.serve import rgb_to_ycbcr420 as jax_convert
    from chess_vision_tpu_torch import native

    assert native.rgb_to_ycbcr420_into(*(np.zeros(s, np.uint8) for s in (
        (1, 2, 2, 3), (1, 2, 2), (1, 1, 1), (1, 1, 1))))  # the library built
    if not native_lib:
        monkeypatch.setattr(native, "rgb_to_ycbcr420_into", lambda *a: False)
    imgs = _boards(11, 1)
    imgs[0] = 255
    imgs[1] = 0
    imgs[2, ::2] = 255
    imgs[3] = np.random.default_rng(2).integers(0, 2, imgs[3].shape) * 255
    want = [np.stack([f(img)[i] for img in imgs]) for f in
            (pre.rgb_to_ycbcr420, jax_convert) for i in range(3)]
    assert all(np.array_equal(a, b) for a, b in zip(want[:3], want[3:]))
    with ThreadPoolExecutor(3) as pool:
        for got in (pre.rgb_to_ycbcr420_batch(imgs),
                    pre.rgb_to_ycbcr420_batch(imgs, pool, chunk=3)):
            for a, b in zip(got, want[:3]):
                assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_plane_path_logits_match_jax_f32(tiny):
    """The model input rebuilt from the planes, then the f32 forward."""
    import jax.numpy as jnp

    from chess_vision_tpu.models import build_model as jax_build
    from chess_vision_tpu.ops.preprocess import (
        ycbcr420_to_normalized as jax_normalized)
    from chess_vision_tpu.utils.checkpoint import load_checkpoint
    from chess_vision_tpu_torch.serve import Predictor, model_input

    path = tiny[0]
    planes = pre.rgb_to_ycbcr420_batch(_boards(3, 2))
    ckpt = load_checkpoint(path)
    x = jax_normalized(*(jnp.asarray(p) for p in planes), MEAN, STD,
                       jnp.float32)
    want = jax_build(ckpt["config"]).apply({"params": ckpt["params"]}, x,
                                           train=False)
    model = Predictor(path, batch_size=3, device="cpu").model
    with torch.inference_mode():
        ours = model_input([torch.from_numpy(p) for p in planes], MEAN, STD,
                           torch.float32, "ycbcr420")
        got = model(ours)
    np.testing.assert_allclose(ours.numpy(), np.asarray(x), atol=1e-5, rtol=0)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_predict_array_matches_jax_f32(tiny):
    from chess_vision_tpu.serve import Predictor as JaxPredictor
    from chess_vision_tpu_torch.serve import Predictor

    path = tiny[0]
    imgs = _boards(5, 9)
    want = JaxPredictor(path, batch_size=4, mode="ycbcr420").predict_array(imgs)
    p = Predictor(path, batch_size=4, inflight=2, device="cpu",
                  mode="ycbcr420")
    assert [tuple(b.shape) for b in p._slots[0].inputs] == [
        (4, SIZE, SIZE), (4, SIZE // 2, SIZE // 2), (4, SIZE // 2, SIZE // 2)]
    got = p.predict_array(imgs)
    assert len(got) == 5 and got == want


def test_predict_files_matches_jax(tiny):
    """JPEGs decoded to planes natively, the PNG through the RGB decode and
    the host conversion."""
    from chess_vision_tpu.serve import Predictor as JaxPredictor
    from chess_vision_tpu_torch import native
    from chess_vision_tpu_torch.serve import Predictor

    path, _, paths = tiny
    assert native.decode_file_ycbcr420(paths[0], SIZE) is not None
    assert native.decode_file_ycbcr420(paths[-1], SIZE) is None
    want = JaxPredictor(path, batch_size=3, decode_workers=2,
                        mode="ycbcr420").predict_files(paths)
    p = Predictor(path, batch_size=3, decode_workers=2, inflight=2,
                  device="cpu", mode="ycbcr420")
    got = p.predict_files(paths)
    assert len(got) == len(paths) and got == want


def test_infer_fns_match_jax_bf16_and_int8(tiny, monkeypatch):
    """``make_infer_fn`` (bf16) and ``make_int8_infer_fn`` (int8, block
    layout) in ycbcr420 mode against the JAX functions on the same planes."""
    import jax
    import jax.numpy as jnp

    from chess_vision_tpu import serve as jax_serve
    from chess_vision_tpu.models import build_model as jax_build
    from chess_vision_tpu.ops import quant as jq
    from chess_vision_tpu.ops.preprocess import (
        ycbcr420_to_normalized as jax_normalized)
    from chess_vision_tpu.utils.checkpoint import load_checkpoint
    from chess_vision_tpu_torch.convert.jax_params import int8_pack_from_jax
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.serve import (Predictor, make_infer_fn,
                                              make_int8_infer_fn)

    path = tiny[1]
    ckpt = load_checkpoint(path)
    params = jax.tree.map(np.asarray, ckpt["params"])
    planes = pre.rgb_to_ycbcr420_batch(_boards(4, 3))
    ours_in = [torch.from_numpy(p) for p in planes]
    jax_in = [jnp.asarray(p) for p in planes]

    jax_model = jax_build(ckpt["config"])
    want = jax_serve.make_infer_fn(jax_model, MEAN, STD, mode="ycbcr420")(
        params, {}, *jax_in)
    model = Predictor(path, device="cpu").model
    got = make_infer_fn(model, MEAN, STD, mode="ycbcr420")(*ours_in)
    # bf16: the same outputs wherever the JAX logits are further than the
    # port's bf16 model bound (tests/test_torch_model.py) from a tie
    x = jax_normalized(*jax_in, MEAN, STD, jnp.bfloat16)
    logits = jax_model.apply({"params": params}, x, train=False)
    squares = np.asarray(logits["squares"], np.float32).reshape(-1, 64, 13)
    top2 = np.sort(squares, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > BF16_ATOL
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(got[0].numpy()[sure], np.asarray(want[0])[sure])
    for i, head in ((1, "turn"), (2, "castling")):
        head_logits = np.asarray(logits[head], np.float32)
        sure = np.abs(head_logits[:, 0] if head == "turn" else head_logits) > BF16_ATOL
        np.testing.assert_array_equal(got[i].numpy()[sure], np.asarray(want[i])[sure])

    def jax_block_apply(pack, images, attn_shifts=None):
        """The JAX "block" layout, composed as tests/test_torch_int8_model.py
        does (its kernels in interpret mode)."""
        from chess_vision_tpu.models.common import combine_type_color
        from chess_vision_tpu.models.layers import adaptive_avg_pool_nhwc

        x, G = jq._embed(pack, images)
        blocks = pack["blocks"]
        xq, xs = jq.fused_rowquant(x, "ln", blocks[0]["norm1"]["scale"],
                                   blocks[0]["norm1"]["bias"], interpret=True)
        for i, q in enumerate(blocks):
            nxt = blocks[i + 1]["norm1"] if i + 1 < len(blocks) else None
            x, xq, xs = jq._block_tpu(x, xq, xs, q, nxt, num_heads=4,
                                      interpret=True)
        x = jq._layernorm(x, pack["norm"])
        B, _, D = x.shape
        pooled = adaptive_avg_pool_nhwc(x[:, 1:].reshape(B, G, G, D), (8, 8))
        heads = pack["heads"]
        dense = lambda t, p: jnp.dot(t, p["kernel"]) + p["bias"]  # noqa: E731
        return {"squares": combine_type_color(
                    dense(pooled, heads["type_head"]),
                    dense(pooled, heads["color_head"])).reshape(B, -1),
                "turn": dense(x[:, 0], heads["turn_head"]),
                "castling": dense(x[:, 0], heads["castling_head"])}

    monkeypatch.setenv("CHESS_VISION_GELU", "sigmoid")
    monkeypatch.setattr(jq, "chessvit_int8_apply", jax_block_apply)
    jpack = jq.quantize_chessvit(params)
    want = jax_serve.make_int8_infer_fn(MEAN, STD, mode="ycbcr420")(
        jpack, {}, *jax_in)
    pack = int8_pack_from_jax(quant.quantize_chessvit(params, num_heads=4),
                              torch.device("cpu"))
    got = make_int8_infer_fn(pack, MEAN, STD, num_heads=4,
                             mode="ycbcr420")(*ours_in)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_predictor_ycbcr420_layouts_agree(tiny, monkeypatch):
    """The int8 Predictor in ycbcr420 mode, calibrated on RGB-decoded files,
    gives the same FENs in the block, flat and fused layouts, and the block
    layout's are those of its infer function on the host-converted planes."""
    from chess_vision_tpu_torch.serve import Predictor

    path, _, paths = tiny
    imgs = _boards(5, 4)
    fens = {}
    for layout in ("block", "flat", "fused"):
        monkeypatch.setenv("CHESS_VISION_INT8_LAYOUT", layout)
        p = Predictor(path, batch_size=4, inflight=2, device="cpu",
                      quant="int8", mode="ycbcr420", calib_paths=paths[:2])
        fens[layout] = p.predict_array(imgs)
        if layout == "block":
            planes = pre.rgb_to_ycbcr420_batch(imgs[:4])
            preds = p.infer(*(torch.from_numpy(a) for a in planes))[0]
            from chess_vision_tpu_torch.fen import fen_to_labels

            served = np.stack([fen_to_labels(f.split()[0]) for f in fens[layout][:4]])
            np.testing.assert_array_equal(served, preds.numpy())
    assert fens["block"] == fens["flat"] == fens["fused"]


def test_serve_cli_ycbcr420_matches_predictor(tiny, tmp_path, capsys):
    from chess_vision_tpu_torch.serve import Predictor, main

    path, _, paths = tiny
    img_dir = tmp_path / "boards"
    img_dir.mkdir()
    for f in paths:
        shutil.copy(f, img_dir)
    main(["--checkpoint", path, "--images", str(img_dir), "--mode", "ycbcr420",
          "--batch-size", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    files = sorted(os.listdir(img_dir))
    want = Predictor(path, batch_size=4, device="cpu", mode="ycbcr420"
                     ).predict_files([str(img_dir / f) for f in files])
    assert lines == [f"{f}\t{fen}" for f, fen in zip(files, want)]
