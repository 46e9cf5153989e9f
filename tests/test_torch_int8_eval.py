"""The port's int8-against-bf16 evaluation
(chess_vision_tpu_torch/experiments/int8_eval.py) against the JAX package's
experiments/int8_eval.py, its disagreement analysis (int8_gate.py) and
visualize_failures, on the CPU with a tiny ViT checkpoint written by the JAX
package (embed 64, 2 blocks, 4 heads, 64 px, f32) and 8 generated boards."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chess_vision_tpu_torch.ops  # noqa: F401  (the first exp on one thread)
from chess_vision_tpu_torch.experiments import int8_eval, int8_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}
JAX_SCRIPT = os.path.join(REPO, "experiments", "int8_eval.py")

torch.set_num_threads(2)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_int8_eval", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(checkpoint path, image dir) as tests/test_torch_serve.py's."""
    import jax
    import jax.numpy as jnp

    from chess_vision_tpu.datagen.generate import generate_split
    from chess_vision_tpu.models import build_model
    from chess_vision_tpu.utils.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("torch_int8_eval")
    img_dir = str(d / "imgs")
    generate_split(img_dir, [("game", 6), ("random", 2)], size=64, seed=5,
                   workers=1)
    cfg = {
        "model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                  "input_size": 64, "embed_dim": 64, "depth": 2,
                  "num_heads": 4},
        "training": {"mixed_precision": False},
    }
    variables = build_model(cfg).init(
        {"params": jax.random.key(4), "dropout": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), train=False)
    path = str(d / "ckpt.msgpack")
    save_checkpoint(path, variables["params"], {}, {}, step=1, epoch=0,
                    best_val_acc=0.0, config=cfg)
    return path, img_dir


def _labels(rng, n):
    from chess_vision_tpu_torch.fen import labels_to_fen, parse_full_fen

    out = []
    for i in range(n):
        squares = labels_to_fen(rng.integers(0, 13, 64).astype(np.int32))
        castling = "".join(c for c in "KQkq" if rng.random() < 0.5) or "-"
        lab = parse_full_fen(f"{squares} {'wb'[i % 2]} {castling} - 0 1")
        lab["legal"] = np.asarray([float(i % 3 != 0)], np.float32)
        out.append(lab)
    return out


@pytest.mark.parametrize("legal", [True, False])
def test_metrics_from_fens_matches_jax(legal):
    from chess_vision_tpu_torch.fen import labels_to_fen

    rng = np.random.default_rng(1)
    labels = _labels(rng, 12)
    if not legal:
        for lab in labels:
            lab["legal"] = np.zeros(1, np.float32)
    fens = []
    for i, lab in enumerate(labels):
        squares = lab["squares"].copy()
        if i % 4 == 1:  # a wrong square on some boards
            squares[i] = (squares[i] + 1) % 13
        turn = "wb"[(i // 2) % 2]
        castling = "KQkq"[: i % 5] or "-"
        fens.append(f"{labels_to_fen(squares)} {turn} {castling}")
    got, got_sq = int8_eval.metrics_from_fens(fens, labels)
    want, want_sq = _jax_script().metrics_from_fens(fens, labels)
    assert got == want
    np.testing.assert_array_equal(got_sq, want_sq)


def _json_keys(tree: ast.AST, name: str) -> set[str]:
    """String keys of the dict literal assigned to ``name`` in ``tree``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == name for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict assigned to {name}")


def test_script_prints_every_key_of_the_jax_one(tiny):
    path, img_dir = tiny
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.experiments.int8_eval",
         "--checkpoint", path, "--test-dir", img_dir, "--batch-size", "4",
         "--calib", "2", "--device", "cpu"],
        cwd=REPO, env={**ENV, "CHESS_VISION_INT8_LAYOUT": "flat",
                       "OMP_NUM_THREADS": "2"},  # as this process's torch
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout)
    with open(JAX_SCRIPT) as f:
        want = _json_keys(ast.parse(f.read()), "out")
    assert want <= set(out), want - set(out)
    jax_metrics = _jax_script().metrics_from_fens(
        ["8/8/8/8/8/8/8/8 w -"], _labels(np.random.default_rng(0), 1))[0]
    for name in ("bf16", "int8"):
        assert set(jax_metrics) | {"throughput"} == set(out[name])
        assert out[name]["n"] == 8 and out[name]["n_legal"] == 6
    assert out["layout"] == "flat" and out["device"] == "cpu"
    assert out["mode"] == "ycbcr420"
    # the agreements are those of the two Predictors' FENs
    from chess_vision_tpu_torch.serve import Predictor

    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.endswith(".jpg"))
    ids = {}
    for quant in (None, "int8"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("CHESS_VISION_INT8_LAYOUT", "flat")
            p = Predictor(path, batch_size=4, device="cpu", quant=quant,
                          mode="ycbcr420",  # the script's default mode
                          calib_paths=files[:2] if quant else None)
        ids[quant] = int8_eval.metrics_from_fens(
            p.predict_files(files), [{"squares": np.zeros(64), "turn": [0],
                                      "castling": [0] * 4, "legal": [0]}] * 8)[1]
    same = ids[None] == ids["int8"]
    assert out["square_agreement"] == round(float(same.mean()), 6)
    assert out["board_agreement"] == round(float(same.all(axis=1).mean()), 6)
    assert out["disagreeing_boards"] == np.flatnonzero(~same.all(axis=1)).tolist()


def test_mode_ycbcr420_raises_naming_item_5(tiny, capsys):
    """The name is from when the mode raised (Queue A item 5); it is ported
    now: ``--mode rgb`` and ``--mode ycbcr420`` each give the agreements of
    the two Predictors in that mode."""
    from chess_vision_tpu_torch.serve import Predictor

    path, img_dir = tiny
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.endswith(".jpg"))
    for mode in ("rgb", "ycbcr420"):
        int8_eval.main(["--checkpoint", path, "--test-dir", img_dir,
                        "--mode", mode, "--batch-size", "4", "--device", "cpu"])
        out = json.loads(capsys.readouterr().out)
        assert out["mode"] == mode
        ids = [int8_eval.metrics_from_fens(
            Predictor(path, batch_size=4, device="cpu", quant=quant,
                      mode=mode).predict_files(files),
            [{"squares": np.zeros(64), "turn": [0], "castling": [0] * 4,
              "legal": [0]}] * 8)[1] for quant in (None, "int8")]
        same = ids[0] == ids[1]
        assert out["board_agreement"] == round(float(same.all(axis=1).mean()), 6)
        assert out["disagreeing_boards"] == np.flatnonzero(
            ~same.all(axis=1)).tolist()


def test_without_a_gpu_and_without_device_cpu_it_raises(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, img_dir = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        int8_eval.main(["--checkpoint", path, "--test-dir", img_dir])


def test_gate_reads_every_layout_and_names_the_cause(tiny, tmp_path):
    """On the CPU the kernels are their plain versions, so each layout's
    kernels and plain versions agree on every board, and every board where
    int8 and bf16 part is put down to the int8 scheme."""
    path, img_dir = tiny
    out_path = str(tmp_path / "gate.json")
    assert int8_gate.main(["--checkpoint", path, "--test-dir", img_dir,
                           "--calib", "2", "--out", out_path,
                           "--device", "cpu"]) == 0
    with open(out_path) as f:
        out = json.load(f)
    assert set(out["layouts"]) == {"block", "flat", "fused"}
    for layout, r in out["layouts"].items():
        assert r["board_agreement_kernel_plain"] == 1.0, layout
        assert r["max_abs_logit_kernel_vs_plain"] == 0.0, layout
        assert r["board_agreement_kernel_bf16"] == r["board_agreement_plain_bf16"]
        assert r["served_equals_logits"], layout
        assert r["causes"]["kernels differ from plain"] == 0
        assert r["causes"]["int8 scheme"] == len(r["disagreeing_boards"])
        assert len(r["disagreeing_boards"]) == round(
            8 * (1 - r["board_agreement_kernel_bf16"]))
        for board in r["disagreeing_boards"]:
            assert board["squares"] and all(
                q["kernel_class"] != q["bf16_class"] for q in board["squares"])
        # 8 boards: the first 512 are all of them
        assert r["board_agreement_kernel_bf16_first_512"] == \
            r["board_agreement_kernel_bf16"]
    # the scheme readings: the serving scheme is the block layout's plain
    # reading; each reading lists the boards it parts from bf16 on
    schemes = out["schemes"]
    assert set(schemes) == set(int8_gate.SCHEMES)
    assert schemes["serving"]["board_agreement"] == \
        out["layouts"]["block"]["board_agreement_plain_bf16"]
    for name, r in schemes.items():
        assert r["board_agreement_first_512"] == r["board_agreement"], name
        assert len(r["disagreeing_boards"]) == round(8 * (1 - r["board_agreement"]))
    # the ablation of a board: on the CPU every kernel is its plain version
    from chess_vision_tpu_torch.experiments.plain import WRAPPERS
    from chess_vision_tpu_torch.serve import Predictor

    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.endswith(".jpg"))
    p = Predictor(path, batch_size=4, device="cpu", quant="int8",
                  calib_paths=files[:2])
    ab = int8_gate.ablate(p, p._decode(files[0])[None], [0, 9, 63])
    assert set(ab) == {"kernels", "plain", *WRAPPERS}
    assert all(ab[w] == {"kernel_alone": ab["plain"], "plain_alone": ab["plain"]}
               for w in WRAPPERS) and ab["kernels"] == ab["plain"]


def test_xla_form_blocks_run_the_xla_block(tiny, monkeypatch):
    """``plain.xla_form_blocks`` swaps each block of the block layout for
    ``quant._block`` (bf16 attention, dynamic quantization), nothing else."""
    from chess_vision_tpu_torch.experiments.plain import (forward_logits,
                                                          xla_form_blocks)
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.serve import Predictor

    path, img_dir = tiny
    p = Predictor(path, batch_size=4, device="cpu", quant="int8")
    boards = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    calls = []
    block, quant_attn = quant._block, attn_ops.fused_qkv_attention_quant
    monkeypatch.setattr(quant, "_block",
                        lambda *a: calls.append("xla") or block(*a))
    monkeypatch.setattr(attn_ops, "fused_qkv_attention_quant",
                        lambda *a: calls.append("quant") or quant_attn(*a))
    with xla_form_blocks():
        xla = forward_logits(p, boards)["squares"]
    assert calls == ["xla", "xla"]
    served = forward_logits(p, boards)["squares"]
    assert calls[2:] == ["quant", "quant"]
    assert np.isfinite(xla).all() and xla.shape == served.shape


def test_compare_names_a_kernel_when_plain_sides_with_bf16():
    rng = np.random.default_rng(2)
    bf16 = rng.normal(size=(4, 64, 13)).astype(np.float32)
    plain = bf16.copy()
    kernel = bf16.copy()
    kernel[1, 5] = -bf16[1, 5]  # board 1 square 5: the kernel alone moves
    plain[2, 7] = kernel[2, 7] = -bf16[2, 7]  # board 2: both int8 forwards
    plain[3, 9] = -bf16[3, 9]  # board 3: the plain version alone moves
    r = int8_gate.compare(bf16, kernel, plain,
                          ["a.jpg", "b.jpg", "c.jpg", "d.jpg"])
    assert r["board_agreement_kernel_bf16"] == pytest.approx(2 / 4)
    assert r["board_agreement_plain_bf16"] == pytest.approx(2 / 4)
    assert r["board_agreement_kernel_plain"] == pytest.approx(2 / 4)
    assert [(b["index"], b["cause"]) for b in r["disagreeing_boards"]] == [
        (1, "kernels differ from plain"), (2, "int8 scheme"),
        (3, "kernels differ from plain")]
    assert [[q["square"] for q in b["squares"]]
            for b in r["disagreeing_boards"]] == [[5], [7], [9]]
    board3 = r["disagreeing_boards"][2]["squares"][0]
    assert board3["kernel_class"] == board3["bf16_class"] != board3["plain_class"]


def test_visualize_failures_writes_a_png(tiny, tmp_path):
    pytest.importorskip("matplotlib")
    path, img_dir = tiny
    out = str(tmp_path / "failures.png")
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.visualize_failures",
         "--checkpoint", path, "--test-dir", img_dir, "--num-failures", "6",
         "--batch-size", "4", "--out", out, "--device", "cpu"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "failures among 8 images" in r.stdout and f"saved {out}" in r.stdout
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
