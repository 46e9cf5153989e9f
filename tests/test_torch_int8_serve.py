"""The port's int8 serving entry points (chess_vision_tpu_torch/serve.py
``Predictor(quant="int8")`` and ``python -m chess_vision_tpu_torch.serve
--quant int8 --calib N``): the arch check, the ``CHESS_VISION_GELU`` knob,
and the CLI against the Predictor on a tiny checkpoint written by the JAX
package. The FENs themselves are held against the JAX package in
test_torch_int8_model.py."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu_torch.ops import quant

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256
CFG = {"model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                 "input_size": SIZE, "embed_dim": 128, "depth": 2,
                 "num_heads": 2, "head_dropout": 0.0, "drop_path_rate": 0.0},
       "training": {"mixed_precision": False}}


def _boards(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


def test_predictor_int8_rejects_other_archs():
    from chess_vision_tpu_torch.serve import Predictor

    cfg = {"model": {"arch": "cnn", "input_size": 64}}
    with pytest.raises(ValueError, match="arch=vit"):
        Predictor((cfg, {}), device="cpu", quant="int8")


def test_gelu_mode_from_environment(monkeypatch):
    monkeypatch.delenv("CHESS_VISION_GELU", raising=False)
    assert quant.approx_gelu() == "sigmoid"
    monkeypatch.setenv("CHESS_VISION_GELU", "hard")
    assert quant.approx_gelu() == "hard"
    monkeypatch.setenv("CHESS_VISION_GELU", "tanh")
    with pytest.raises(ValueError):
        quant.approx_gelu()


def test_serve_cli_int8_matches_predictor(tmp_path):
    from PIL import Image

    from chess_vision_tpu.utils.checkpoint import save_checkpoint
    from chess_vision_tpu_torch.serve import Predictor

    params = init_variables(jax_build_model(CFG), SIZE, seed=5)["params"]
    ckpt = str(tmp_path / "tiny.ckpt")
    save_checkpoint(ckpt, jax.tree.map(np.asarray, params), {}, {}, step=1,
                    epoch=1, best_val_acc=0.0, config=CFG)
    img_dir = tmp_path / "boards"
    img_dir.mkdir()
    for i, img in enumerate(_boards(3, seed=10)):
        Image.fromarray(img).save(img_dir / f"{i}.png")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CHESS_VISION_GELU": "sigmoid"}
    run = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.serve", "--checkpoint",
         ckpt, "--images", str(img_dir), "--quant", "int8", "--calib", "2",
         "--batch-size", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    paths = sorted(str(p) for p in img_dir.iterdir())
    want = Predictor(ckpt, batch_size=2, device="cpu", quant="int8",
                     calib_paths=paths[:2]).predict_files(paths)
    got = [line.split("\t")[1] for line in run.stdout.strip().splitlines()]
    assert got == want
