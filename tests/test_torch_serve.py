"""The port's serving path (chess_vision_tpu_torch/serve.py, predict.py,
utils/checkpoint.py, config.py) against the JAX package's, on a tiny
checkpoint written by the JAX package: FEN strings must be byte-identical at
f32."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chess_vision_tpu.config import get_data_config as jax_data_config
from chess_vision_tpu_torch.config import get_data_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny vit checkpoint (f32) + a few board images, as tests/test_serve.py."""
    import jax
    import jax.numpy as jnp

    from chess_vision_tpu.datagen.generate import generate_split
    from chess_vision_tpu.models import build_model
    from chess_vision_tpu.utils.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("torch_serve")
    img_dir = str(d / "imgs")
    generate_split(img_dir, [("random", 5)], size=64, seed=6, workers=1)
    cfg = {
        "model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                  "input_size": 64, "embed_dim": 128, "depth": 2,
                  "num_heads": 2},
        "training": {"mixed_precision": False},
    }
    variables = build_model(cfg).init(
        {"params": jax.random.key(3), "dropout": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), train=False,
    )
    path = str(d / "ckpt.msgpack")
    save_checkpoint(path, variables["params"], {}, {}, step=3, epoch=1,
                    best_val_acc=0.5, config=cfg)
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.endswith(".jpg"))
    return path, paths


@pytest.mark.parametrize("name", [
    "vit_base_patch16_224.augreg_in21k",
    "convnextv2_tiny.fcmae_ft_in22k_in1k",
    "mobilenetv4_conv_small_050.e3000_r224_in1k",
    "vit_small_unlisted", "",
])
def test_data_config_matches_jax(name):
    assert get_data_config(name) == jax_data_config(name)


def test_load_checkpoint_matches_flax(tiny_ckpt):
    from chess_vision_tpu.utils.checkpoint import load_checkpoint as flax_load
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    path, _ = tiny_ckpt
    ours, ref = load_checkpoint(path), flax_load(path)
    assert ours.keys() == ref.keys()

    def same(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert a == b and type(a) is type(b), where

    same(ours, ref, "")


def test_load_checkpoint_unchunks_large_arrays(tmp_path, monkeypatch):
    from flax import serialization

    from chess_vision_tpu.utils.checkpoint import save_checkpoint
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    w = np.arange(100, dtype=np.float32).reshape(4, 25)
    path = str(tmp_path / "chunked.ckpt")
    save_checkpoint(path, {"w": w}, {}, {}, step=0, epoch=0, best_val_acc=0.0,
                    config={"model": {}})
    np.testing.assert_array_equal(load_checkpoint(path)["params"]["w"], w)


def test_predict_array_matches_jax_f32(tiny_ckpt):
    from chess_vision_tpu.serve import Predictor as JaxPredictor
    from chess_vision_tpu_torch.serve import Predictor

    path, _ = tiny_ckpt
    imgs = np.random.default_rng(9).integers(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    want = JaxPredictor(path, batch_size=4).predict_array(imgs)
    got = Predictor(path, batch_size=4, inflight=2, device="cpu").predict_array(imgs)
    assert len(got) == 5
    assert got == want


def test_predict_files_matches_jax_f32(tiny_ckpt):
    from chess_vision_tpu.serve import Predictor as JaxPredictor
    from chess_vision_tpu_torch.serve import Predictor

    path, paths = tiny_ckpt
    want = JaxPredictor(path, batch_size=2, decode_workers=2).predict_files(paths)
    got = Predictor(path, batch_size=2, decode_workers=2, inflight=2,
                    device="cpu").predict_files(paths)
    assert len(got) == len(paths)
    assert got == want


def test_predict_cli_matches_jax_cli(tiny_ckpt):
    path, paths = tiny_ckpt
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    run = lambda *cmd: subprocess.run(  # noqa: E731
        [sys.executable, *cmd, "--checkpoint", path, "--image", paths[0]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    ref = run("predict.py")
    ours = run("-m", "chess_vision_tpu_torch.predict", "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert ours.returncode == 0, ours.stderr
    assert ours.stdout.strip() and ours.stdout == ref.stdout


def test_predictor_without_gpu_or_device_raises(tiny_ckpt, monkeypatch):
    from chess_vision_tpu_torch.serve import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tiny_ckpt[0])


@pytest.mark.parametrize("kwargs", [{"mode": "ycbcr420"},
                                    {"mode": "ycbcr420", "quant": "int8"}])
def test_unported_serving_forms_raise(tiny_ckpt, kwargs):
    """The name is from when these forms raised (Queue A item 5); both are
    ported now: the ycbcr420 Predictor, in bf16 and int8, stages three plane
    buffers a slot and serves files and arrays alike (the FENs are held to
    the JAX package in tests/test_torch_serve_ycbcr.py); an unknown mode
    raises."""
    from chess_vision_tpu_torch.serve import Predictor

    path, paths = tiny_ckpt
    p = Predictor(path, batch_size=2, inflight=2, device="cpu",
                  calib_paths=paths[:2], **kwargs)
    assert p.mode == "ycbcr420" and len(p._slots[0].inputs) == 3
    from_files = p.predict_files(paths)
    planes = [p._decode_planes(f) for f in paths]
    want = []
    for start in range(0, len(paths), 2):
        chunk = planes[start:start + 2]
        want += p._drain(*p._submit(tuple(np.stack([c[i] for c in chunk])
                                          for i in range(3))))
    assert len(from_files) == len(paths) and from_files == want
    assert len(p.predict_array(np.stack([p._decode(f) for f in paths]))) == len(paths)
    with pytest.raises(ValueError, match="unknown mode"):
        Predictor(path, device="cpu", **{**kwargs, "mode": "yuv"})


def test_predict_array_rejects_wrong_size(tiny_ckpt):
    from chess_vision_tpu_torch.serve import Predictor

    p = Predictor(tiny_ckpt[0], batch_size=2, device="cpu")
    with pytest.raises(ValueError):
        p.predict_array(np.zeros((1, 32, 32, 3), np.uint8))


def test_importing_port_does_not_import_jax():
    code = ("import sys, chess_vision_tpu_torch.serve, chess_vision_tpu_torch.predict; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
