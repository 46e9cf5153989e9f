"""The port's device-resident corpus (chess_vision_tpu_torch/data_device.py,
its use in train/__main__.py and train/loop.BatchStager) against the JAX
package's ``data_device.py`` and the port's streaming ``packed`` transport,
on the CPU with a 20-board corpus from the JAX package's generator and a
tiny ViT (embed 32, 1 block, 2 heads, 64 px).

Tolerances: none. The epoch plans, the gathered batches and the estimate
are equal to the last bit, and so are the per-epoch metrics of a training
run with the corpus on the device and one that streams the packed
transport: the batches are the same bytes, and the augmentation and dropout
streams are seeded by the step."""

from __future__ import annotations

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

import chess_vision_tpu_torch.ops  # noqa: F401  (the first exp on one thread)
from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
from chess_vision_tpu_torch.data_device import (DeviceBatchLoader, DeviceData,
                                                gather_batch)
from chess_vision_tpu_torch.train.loop import BatchStager

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dd") / "data"
    subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu.datagen.generate", "--out",
         str(out), "--count", "20", "--size", "64", "--seed", "3"],
        check=True, capture_output=True, timeout=600)
    return str(out)


@pytest.mark.parametrize("n,batch,shuffle,drop", [
    (20, 8, True, True), (20, 8, False, False), (13, 4, True, False),
    (7, 8, False, False)])
def test_epoch_plan_matches_jax_and_the_loader_order(n, batch, shuffle, drop):
    from chess_vision_tpu.data_device import DeviceData as JaxDeviceData

    ours = DeviceData(torch.zeros((n, 1), dtype=torch.uint8),
                      torch.zeros((n, 70)), 64)
    ref = JaxDeviceData(np.zeros((n, 1), np.uint8),
                        np.zeros((n, 70), np.float32), 64)
    for epoch in (0, 3):
        got = ours.epoch_plan(batch, shuffle, seed=5, epoch=epoch,
                              drop_remainder=drop)
        want = ref.epoch_plan(batch, shuffle, seed=5, epoch=epoch,
                              drop_remainder=drop)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    class Rows:  # the streaming loader's order over rows 0..n-1
        def labels_for(self, i):
            return {k: np.zeros(w, np.float32) for k, w in
                    (("squares", 64), ("turn", 1), ("castling", 4), ("legal", 1))}

        def load_image(self, i):
            return np.zeros((2, 2, 3), np.uint8)

    loader = BatchLoader(Rows(), np.arange(n), batch, shuffle=shuffle, seed=5,
                         num_workers=1, drop_remainder=drop)
    for epoch in range(2):
        idxs, mask = ours.epoch_plan(batch, shuffle, seed=5, epoch=epoch,
                                     drop_remainder=drop)
        batches = list(loader)
        assert len(batches) == len(idxs)
        for b, row, m in zip(batches, idxs, mask):
            assert np.array_equal(b["indices"], row) and np.array_equal(b["mask"], m)


def test_nbytes_estimate_matches_jax():
    from chess_vision_tpu.data_device import DeviceData as JaxDeviceData

    for n, size in ((51_000, 256), (20, 64), (0, 224)):
        assert DeviceData.nbytes_estimate(n, size) == \
            JaxDeviceData.nbytes_estimate(n, size)
    assert DeviceData.nbytes_estimate(51_000, 256) == 51_000 * 98_584


def test_gathered_batches_equal_the_packed_loader(tiny_dir):
    """Train (shuffled, tail dropped) and eval (padded, masked) epochs of the
    device loader against the packed transport's, byte for byte, on a split
    that is not in corpus order."""
    ds = ChessDataset(tiny_dir, input_size=64)
    split = np.random.default_rng(1).permutation(len(ds))[:13]
    dd = DeviceData.build(ds, split, CPU, chunk=5, num_workers=2,
                          progress=False)
    assert dd.n == 13 and dd.nbytes == DeviceData.nbytes_estimate(13, 64)
    stager = BatchStager(CPU)
    for kw in (dict(shuffle=True, seed=4, drop_remainder=True), {}):
        stream = BatchLoader(ds, split, 4, num_workers=2, transport="packed", **kw)
        gathered = DeviceBatchLoader(dd, 4, **kw)
        for epoch in range(2):
            a, b = list(stream), list(gathered)
            assert len(a) == len(b) == len(stream)
            for want, got in zip(a, b):
                got = stager(got)
                assert set(got) == {"pixels", "labels"}
                for k in got:
                    assert got[k].dtype == torch.from_numpy(want[k]).dtype
                    assert np.array_equal(got[k].numpy(), want[k]), (kw, epoch, k)
    assert gathered.bytes_to_device == 2 * 4 * 4 * 4  # 2 epochs of 4 int32 rows
    assert stager.bytes_to_device == 0  # the gathered batches passed through


def test_padded_eval_tail_is_masked(tiny_dir):
    ds = ChessDataset(tiny_dir, input_size=64)
    dd = DeviceData.build(ds, np.arange(13), CPU, progress=False)
    batches = list(DeviceBatchLoader(dd, 4))
    masks = [b["labels"][:, 70].tolist() for b in batches]
    assert masks == [[1.0] * 4] * 3 + [[1.0, 0.0, 0.0, 0.0]]
    last = batches[-1]
    assert all(torch.equal(last["pixels"][i], dd.pixels[12]) for i in range(4))
    assert torch.equal(last["labels"][:, :70], dd.labels[[12] * 4])
    direct = gather_batch(dd.pixels, dd.labels, torch.tensor([2, 0], dtype=torch.int32),
                          torch.tensor([True, False]))
    assert direct["labels"][:, 70].tolist() == [1.0, 0.0]


def test_stager_passes_device_tensors_and_counts_arrays():
    stager = BatchStager(CPU)
    tensor = torch.arange(6)
    out = stager({"pixels": tensor, "labels": np.ones((2, 71), np.float32),
                  "indices": np.arange(2), "n_real": 2})
    assert out["pixels"] is tensor and set(out) == {"pixels", "labels"}
    assert stager.bytes_to_device == 2 * 71 * 4


def _train_cfg(tmp, device_cache):
    return {
        "data": {"val_split": 0.3, "num_workers": 2, "transport": "packed",
                 "device_cache": device_cache},
        "model": {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
                  "pretrained": False, "input_size": 64, "embed_dim": 32,
                  "depth": 1, "num_heads": 2, "mlp_ratio": 2.0,
                  "head_dropout": 0.1, "drop_path_rate": 0.1, "remat": False},
        "training": {"epochs": 2, "batch_size": 4, "lr": 1e-3,
                     "weight_decay": 0.01, "grad_clip_norm": 1.0,
                     "mixed_precision": False, "label_smoothing": 0.1,
                     "use_class_weights": True},
        "scheduler": {"type": "cosine", "warmup_epochs": 1},
        "checkpointing": {"save_dir": str(tmp / "ckpt")},
        "logging": {"tensorboard_dir": str(tmp / "runs")},
    }


def test_train_from_the_device_equals_streaming(tiny_dir, tmp_path, capsys):
    """``train()`` with the corpus on the device against streaming the packed
    transport: the same per-epoch metrics (train, val and OOD), bit for bit;
    a step copies 4 bytes a board to the device instead of the batch."""
    from chess_vision_tpu_torch.train.__main__ import train

    runs = {}
    for flag in (False, True):
        ds = ChessDataset(tiny_dir, input_size=64)
        ood = ChessDataset(tiny_dir, max_samples=6, input_size=64)
        runs[flag] = train(_train_cfg(tmp_path / str(flag), flag), ds, ood,
                           seed=3, device="cpu")
    out = capsys.readouterr().out
    assert out.count("Device cache: on") == 1
    streamed, cached = runs[False]["history"], runs[True]["history"]
    assert len(cached) == 2
    for s, c in zip(streamed, cached):
        for split in ("train", "val", "ood"):
            assert s[split] == c[split], (split, s[split], c[split])
        assert s["bytes_to_device_per_step"] == 4 * (64 * 64 * 3 // 2 + 71 * 4)
        assert c["bytes_to_device_per_step"] == 4 * 4
    assert runs[False]["device_cache"] is None
    assert runs[True]["device_cache"]["bytes"] == DeviceData.nbytes_estimate(26, 64)
    a, b = (copy.deepcopy(r["state"].model.state_dict()) for r in runs.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
