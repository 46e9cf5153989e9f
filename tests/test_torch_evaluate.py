"""The port's evaluation (chess_vision_tpu_torch/evaluate.py and its CLI)
against the JAX package's (chess_vision_tpu/evaluate.py, the root
evaluate.py), on the CPU.

A tiny ViT (2 blocks, embed 64, 4 heads, 64 px, f32) trained one step by the
port's trainer writes a checkpoint that both packages read; a 10-board
directory from the JAX package's generator (size 64, seed 3, as
tests/test_evaluate.py) is the test set. Counts, confusion matrices, grouped
metrics and the printed report must be identical, the loss within 1e-5
relative. The rigged-model and Kaggle filename-mode tests of
tests/test_evaluate.py are ported with their hand-computed values."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch import evaluate as port_eval
from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
from chess_vision_tpu_torch.fen import fen_to_labels, labels_to_fen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}
HALF = (0.5,) * 3
COUNTS = ("square_acc", "board_acc", "turn_acc", "castling_acc",
          "full_fen_acc", "total_boards", "total_legal")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from chess_vision_tpu.datagen.generate import generate_split

    d = str(tmp_path_factory.mktemp("torch_eval") / "imgs")
    generate_split(d, [("game", 10)], size=64, seed=3, workers=1)
    return d


class _NoLogger:
    """The trainer's TensorBoard logger, which is not under test here (its
    writer's import takes seconds)."""

    def __init__(self, tb_dir):
        pass

    def __getattr__(self, name):
        return lambda *args: None


@pytest.fixture(scope="module")
def trained(tiny_dir, tmp_path_factory):
    """One train step of the port's trainer in f32; the checkpoint path."""
    from unittest import mock

    from chess_vision_tpu_torch.config import load_config
    from chess_vision_tpu_torch.train import __main__ as trainer

    save = tmp_path_factory.mktemp("torch_eval_run")
    cfg = load_config(os.path.join(REPO, "configs", "vit.yaml"))
    cfg["data"].update(train_dir=tiny_dir, test_dir=tiny_dir, num_workers=1,
                       ood_val_dir="")
    cfg["model"].update(pretrained=False, input_size=64, embed_dim=64, depth=2,
                        num_heads=4)
    cfg["training"].update(epochs=1, batch_size=8, mixed_precision=False)
    cfg["checkpointing"]["save_dir"] = str(save / "ckpt")
    cfg["logging"]["tensorboard_dir"] = str(save / "runs")
    with mock.patch.object(trainer, "MetricLogger", _NoLogger):
        trainer.train(cfg, ChessDataset(tiny_dir, input_size=64), device="cpu")
    return str(save / "ckpt" / "latest.ckpt")


def _jax_side(ckpt_path):
    from chess_vision_tpu.models import abstract_variables, build_model
    from chess_vision_tpu.utils.checkpoint import load_checkpoint, restore_tree

    ckpt = load_checkpoint(ckpt_path)
    model = build_model(ckpt["config"])
    params = restore_tree(abstract_variables(model, 64)["params"], ckpt["params"])
    return model, params


def test_evaluate_matches_jax_f32(trained, tiny_dir, capsys):
    import jax

    from chess_vision_tpu.data import BatchLoader as JaxLoader
    from chess_vision_tpu.data import ChessDataset as JaxDataset
    from chess_vision_tpu.evaluate import evaluate as jax_evaluate
    from chess_vision_tpu.parallel.mesh import make_mesh

    model, params = _jax_side(trained)
    jds = JaxDataset(tiny_dir, input_size=64)
    want = jax_evaluate(model, params, {}, jds,
                        JaxLoader(jds, np.arange(len(jds)), 4, num_workers=1),
                        make_mesh(jax.devices()[:1]), HALF, HALF)
    want_text = capsys.readouterr().out

    tmodel, cfg = port_eval.load_model(trained, "cpu")
    assert cfg["training"]["mixed_precision"] is False
    ds = ChessDataset(tiny_dir, input_size=64)
    got = port_eval.evaluate(tmodel, ds,
                             BatchLoader(ds, np.arange(len(ds)), 4, num_workers=1),
                             HALF, HALF)
    got_text = capsys.readouterr().out

    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert "GROUPED METRICS" in got_text and "Confusion matrix" in got_text
    assert got_text == want_text


def test_eval_batch_matches_jax_on_every_output(trained, tiny_dir):
    """Per batch: predictions, per-sample flags, every sum and both
    confusion matrices, including a padded tail batch (mask 0 rows)."""
    from chess_vision_tpu.evaluate import make_eval_batch_fn as jax_fn

    model, params = _jax_side(trained)
    jax_batch = jax_fn(model, HALF, HALF)
    tmodel, _ = port_eval.load_model(trained, "cpu")
    port_batch = port_eval.make_eval_batch_fn(tmodel, HALF, HALF)
    ds = ChessDataset(tiny_dir, input_size=64)
    for batch in BatchLoader(ds, np.arange(len(ds)), 4, num_workers=1):
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and k != "indices"}
        want = {k: np.asarray(v) for k, v in jax_batch(params, {}, arrays).items()}
        got = port_batch({k: torch.from_numpy(v) for k, v in arrays.items()})
        res = got["results"].numpy()
        np.testing.assert_array_equal(res[:, :64], want["preds"])
        np.testing.assert_array_equal(res[:, 64], want["board_correct"])
        np.testing.assert_array_equal(res[:, 65], want["turn_correct_mask"])
        np.testing.assert_array_equal(res[:, 66], want["castling_all_correct_mask"])
        np.testing.assert_array_equal(res[:, 67], want["num_wrong"])
        for key in ("conf", "turn_conf", "castling_right_correct_legal",
                    *port_eval.COUNT_KEYS):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        assert got["conf"].dtype == torch.int64
        assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                       rel=1e-5)


def test_confusion_counts_only_weighted_pairs():
    rng = np.random.default_rng(0)
    true, pred = rng.integers(0, 13, (2, 200))
    weight = rng.integers(0, 2, 200)
    want = np.zeros((13, 13), np.int64)
    np.add.at(want, (true, pred), weight)
    got = port_eval._confusion(*(torch.from_numpy(a) for a in (true, pred, weight)), 13)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


class RiggedModel(torch.nn.Module):
    """Predicts a fixed board for every input; turn logit > 0; castling all
    > 0 (tests/test_evaluate.py's RiggedModel)."""

    def __init__(self, board_fen: str):
        super().__init__()
        onehot = torch.eye(13)[torch.from_numpy(fen_to_labels(board_fen)).long()]
        self.register_buffer("squares", (onehot * 10.0 - 5.0).reshape(1, -1))
        self.bias = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B = x.shape[0]
        return {"squares": self.squares.expand(B, -1) + 0 * self.bias,
                "turn": torch.full((B, 1), 3.0),
                "castling": torch.full((B, 4), 3.0)}


def _run_eval(model, dataset, batch_size=4):
    loader = BatchLoader(dataset, np.arange(len(dataset)), batch_size,
                         num_workers=1)
    return port_eval.evaluate(model, dataset, loader, HALF, HALF, verbose=False)


def test_rigged_metrics_match_hand_computation(tiny_dir):
    dataset = ChessDataset(tiny_dir, input_size=64)
    fen0 = dataset.samples[0]["fen"].split()[0]
    metrics = _run_eval(RiggedModel(fen0), dataset)

    n = len(dataset)
    labels = [fen_to_labels(s["fen"].split()[0]) for s in dataset.samples]
    pred = fen_to_labels(fen0)
    assert metrics["square_acc"] == pytest.approx(
        np.mean([np.mean(lab == pred) for lab in labels]))
    assert metrics["board_acc"] == pytest.approx(
        np.mean([np.array_equal(lab, pred) for lab in labels]))
    assert metrics["total_boards"] == n
    assert metrics["total_legal"] == n
    assert metrics["turn_acc"] == pytest.approx(
        np.mean([s["turn"] == "b" for s in dataset.samples]))
    assert metrics["castling_acc"] == pytest.approx(
        np.mean([s["castling"] == "KQkq" for s in dataset.samples]))


def test_kaggle_filename_mode(tmp_path):
    from PIL import Image

    d = str(tmp_path / "kaggle")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    fens = []
    for _ in range(6):
        fen = labels_to_fen(rng.integers(0, 13, 64).astype(np.int32))
        fens.append(fen)
        img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, fen.replace("/", "-") + ".jpeg"))

    dataset = ChessDataset(d, input_size=64)
    assert not dataset.use_manifest
    metrics = _run_eval(RiggedModel(fens[0]), dataset)
    assert metrics["total_legal"] == 0
    assert metrics["turn_acc"] == 0.0  # divided over max(legal, 1)
    assert metrics["board_acc"] == pytest.approx(1.0 / 6.0)


def _cli(args, check=True):
    r = subprocess.run([sys.executable, *args], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=600)
    if check:
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r


def test_cli_writes_the_root_clis_metrics(trained, tiny_dir):
    flags = ["--checkpoint", trained, "--test-dir", tiny_dir, "--batch-size", "8"]
    log = os.path.join(os.path.dirname(trained), "eval_results.jsonl")
    if os.path.exists(log):
        os.remove(log)
    ours = _cli(["-m", "chess_vision_tpu_torch.evaluate", "--device", "cpu", *flags])
    ref = _cli(["evaluate.py", *flags])
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    got, want = rows[0], rows[1]
    assert {k: got[k] for k in ("checkpoint", "test_dir", "num_samples")} == \
        {k: want[k] for k in ("checkpoint", "test_dir", "num_samples")}
    assert {k: got["metrics"][k] for k in COUNTS} == \
        {k: want["metrics"][k] for k in COUNTS}
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert f"Results appended to {log}" in ours.stdout
    assert ours.stdout.split("\n", 1)[1] == ref.stdout.split("\n", 1)[1]


def test_cli_without_a_gpu_and_without_device_cpu_fails(trained, tiny_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _cli(["-m", "chess_vision_tpu_torch.evaluate", "--checkpoint", trained,
              "--test-dir", tiny_dir], check=False)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


def test_other_archs_raise_naming_the_roadmap(trained, tmp_path):
    """``load_model`` takes a ChessCNN checkpoint (it raised
    NotImplementedError until the arch was ported): the model comes back as
    a ChessCNN in eval mode with the checkpoint's weights and config."""
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.models.cnn import ChessCNN
    from chess_vision_tpu_torch.train.state import create_train_state
    from chess_vision_tpu_torch.utils import checkpoint

    cfg = checkpoint.load_checkpoint(trained)["config"]
    cfg["model"].update(arch="cnn", name="convnextv2_tiny.fcmae_ft_in22k_in1k")
    written = init_weights(build_model(cfg), seed=3)
    path = str(tmp_path / "cnn.ckpt")
    checkpoint.save_checkpoint(path, create_train_state(cfg, written, 1),
                               epoch=0, best_val_acc=0.0, config=cfg)
    model, loaded_cfg = port_eval.load_model(path, "cpu")
    assert isinstance(model, ChessCNN) and not model.training
    assert loaded_cfg == cfg
    loaded = model.state_dict()  # f32: the config trains without bf16
    for key, value in written.state_dict().items():
        assert torch.equal(loaded[key], value), key
