"""The port's trainer CLI (python -m chess_vision_tpu_torch.train) end to
end on the CPU, on a 24-board corpus from the JAX package's generator with the
tiny widths (embed 64, depth 2, 4 heads, 64 px): it trains, its checkpoints
serve in both packages' predictors with the same FEN, either package resumes
the other's checkpoint, and without ``--device cpu`` on a machine with no GPU
it fails with the device error."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from chess_vision_tpu_torch.serve import Predictor
from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cli_corpus")
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu.datagen.generate",
         "--out", str(out), "--count", "24", "--size", "64", "--seed", "7"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return out


def _overrides(corpus, save_dir, epochs, transport="rgb"):
    return ["--set", f"training.epochs={epochs}", "training.batch_size=8",
            "data.num_workers=0", "data.max_samples=24",
            f"data.train_dir={corpus}", "data.ood_val_dir=", "model.pretrained=false",
            "model.input_size=64", "model.embed_dim=64", "model.depth=2",
            "model.num_heads=4", f"data.transport={transport}",
            f"checkpointing.save_dir={save_dir / 'ckpt'}",
            f"logging.tensorboard_dir={save_dir / 'runs'}"]


def _train(args, check=True):
    r = subprocess.run([sys.executable, "-m", "chess_vision_tpu_torch.train",
                        "--config", "configs/vit.yaml", *args],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=900)
    if check:
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
        assert "Training complete" in r.stdout
    return r


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Two epochs on the rgb transport; (corpus, save dir, stdout)."""
    save = tmp_path_factory.mktemp("torch_cli_run")
    r = _train(["--device", "cpu", *_overrides(corpus, save, 2)])
    return corpus, save, r.stdout


def test_trains_two_epochs_and_writes_checkpoints(trained):
    corpus, save, out = trained
    assert "Devices: 1 x cpu" in out and "Epoch 2/2" in out
    assert "model.remat=auto -> False" in out
    ckpt = load_checkpoint(str(save / "ckpt" / "latest.ckpt"))
    assert (ckpt["epoch"], ckpt["step"]) == (1, 4)  # 22 train boards, batch 8
    assert ckpt["config"]["model"]["embed_dim"] == 64
    assert ckpt["config"]["model"]["remat"] is False
    assert os.path.exists(save / "ckpt" / "run_meta.json")
    assert any(f.startswith("events.out") for _, _, fs in os.walk(save / "runs")
               for f in fs)


def test_checkpoint_serves_in_both_packages(trained):
    corpus, save, _ = trained
    ckpt = str(save / "ckpt" / "latest.ckpt")
    image = str(corpus / "000000.jpg")
    ours = Predictor(ckpt, batch_size=4, device="cpu").predict_files([image])
    r = subprocess.run([sys.executable, "predict.py", "--checkpoint", ckpt,
                        "--image", image], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == ours[0]


def test_port_resumes_its_checkpoint_at_the_next_epoch(trained):
    corpus, save, _ = trained
    ckpt = str(save / "ckpt" / "latest.ckpt")
    resumed = save / "resumed"
    r = _train(["--device", "cpu", "--resume", ckpt,
                *_overrides(corpus, resumed, 3)])
    assert "Resumed from epoch 2" in r.stdout and "Epoch 3/3" in r.stdout
    assert "Epoch 2/3" not in r.stdout
    after = load_checkpoint(str(resumed / "ckpt" / "latest.ckpt"))
    assert (after["epoch"], after["step"]) == (2, 6)
    # --reset-schedule keeps the weights only and starts at epoch 1
    warm = save / "warm"
    r = _train(["--device", "cpu", "--resume", ckpt, "--reset-schedule",
                *_overrides(corpus, warm, 1)])
    assert "reset schedule" in r.stdout and "Epoch 1/1" in r.stdout


def test_jax_trainer_resumes_the_port_checkpoint_and_back(trained):
    corpus, save, _ = trained
    ckpt = str(save / "ckpt" / "latest.ckpt")
    jax_dir = save / "jax"
    r = subprocess.run(
        [sys.executable, "train.py", "--config", "configs/vit.yaml", "--resume",
         ckpt, *_overrides(corpus, jax_dir, 3), "data.device_cache=false",
         "model.remat=false"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "Resumed from epoch 2" in r.stdout and "Training complete" in r.stdout
    jax_ckpt = str(jax_dir / "ckpt" / "latest.ckpt")
    back = save / "back"
    r = _train(["--device", "cpu", "--resume", jax_ckpt,
                *_overrides(corpus, back, 4)])
    assert "Resumed from epoch 3" in r.stdout and "Epoch 4/4" in r.stdout
    assert load_checkpoint(str(back / "ckpt" / "latest.ckpt"))["step"] == 8


def test_ycbcr420_transport_and_auto_resume(corpus, tmp_path):
    args = ["--device", "cpu", "--auto-resume"]
    r = _train([*args, *_overrides(corpus, tmp_path, 1, "ycbcr420")])
    assert "Auto-resuming" not in r.stdout
    r = _train([*args, *_overrides(corpus, tmp_path, 2, "ycbcr420")])
    assert "Auto-resuming" in r.stdout and "Resumed from epoch 1" in r.stdout
    assert load_checkpoint(str(tmp_path / "ckpt" / "latest.ckpt"))["step"] == 4


def test_without_a_gpu_and_without_device_cpu_it_fails(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _train(_overrides(corpus, tmp_path, 1), check=False)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not os.path.exists(tmp_path / "ckpt" / "latest.ckpt")


@pytest.mark.parametrize("override,match", [
    ("training.fsdp=true", None),
    ("training.tensor_parallel=2", "tp=2 does not divide device count 1"),
    ("model.remat=attn_out", None)])
def test_unported_options_raise_naming_the_roadmap(corpus, tmp_path, override, match):
    """The name is from when all three raised NotImplementedError (ROADMAP
    Queue A items 7 and 11); all are ported. Without a launcher there is one
    device: fsdp then trains as one device does, a model axis of 2 does not
    divide it (ValueError, as the JAX package's ``make_mesh_2d``), and
    ``remat="attn_out"`` trains and is kept in the checkpoint's config."""
    r = _train(["--device", "cpu", *_overrides(corpus, tmp_path, 1), override],
               check=match is None)
    if match is not None:
        assert r.returncode != 0
        assert "ValueError" in r.stderr and match in r.stderr
        return
    assert "Devices: 1 x cpu" in r.stdout
    ckpt = load_checkpoint(str(tmp_path / "ckpt" / "latest.ckpt"))
    key, value = override.split("=")
    section, name = key.split(".")
    assert str(ckpt["config"][section][name]).lower() == value


def test_device_cache_true_trains_as_streaming_the_packed_transport(
        corpus, tmp_path):
    """``data.device_cache=true`` (the ``data.device_cache=true`` case of
    the test above until the cache was ported) holds the corpus on the
    device even on the rgb transport, as the reference does, and then trains
    on its 4:2:0 planes: the same epochs, to the printed digit, as streaming
    the packed transport."""
    def epochs(out):
        return [line for line in out.splitlines() if "— loss:" in line]

    cached = _train(["--device", "cpu", *_overrides(corpus, tmp_path / "a", 2),
                     "data.device_cache=true"]).stdout
    streamed = _train(["--device", "cpu",
                       *_overrides(corpus, tmp_path / "b", 2, "packed"),
                       "data.device_cache=false"]).stdout
    assert "Device cache: on" in cached and "Device cache" not in streamed
    assert "bytes to the device a train step" in cached
    assert len(epochs(cached)) == 4 and epochs(cached) == epochs(streamed)
