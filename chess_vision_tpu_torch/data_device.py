"""A training corpus held in the device's memory (the port's counterpart of
``chess_vision_tpu/data_device.py``).

When the corpus fits beside the train state, it is decoded and uploaded
once; every epoch then draws its batches by an index gather on the device,
so a step copies only its (B,) index row to the device instead of the
batch. Layout on the device, the ``packed`` loader transport's
(``data.BatchLoader``), so ``train/loop.unpack_batch`` takes a gathered
batch unchanged:

  pixels (N, P) uint8: the YCbCr 4:2:0 planes of each board, flattened
  labels (N, 70) f32: squares (64), turn (1), castling (4), legal (1)

A gathered batch appends the mask column (the padded tail of an eval epoch
gets 0), as the packed transport does. One device.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

LABEL_COLUMNS = 70


def _pack_labels(dataset, idx: np.ndarray) -> np.ndarray:
    rows = []
    for i in idx:
        lab = dataset.labels_for(int(i))
        rows.append(np.concatenate([lab["squares"].astype(np.float32),
                                    lab["turn"], lab["castling"], lab["legal"]]))
    return np.stack(rows)


def _pack_pixels(dataset, idx: np.ndarray, pool) -> np.ndarray:
    planes = list(pool.map(dataset.load_planes, [int(i) for i in idx]))
    B = len(planes)
    return np.concatenate([np.stack([p[k] for p in planes]).reshape(B, -1)
                           for k in range(3)], axis=1)


class DeviceData:
    """A dataset split resident on a device: ``pixels`` (N, P) uint8 and
    ``labels`` (N, 70) f32 tensors there, ``n`` samples."""

    def __init__(self, pixels: torch.Tensor, labels: torch.Tensor,
                 input_size: int):
        self.pixels = pixels
        self.labels = labels
        self.n = int(pixels.shape[0])
        self.input_size = input_size

    @property
    def nbytes(self) -> int:
        return (self.pixels.numel() * self.pixels.element_size()
                + self.labels.numel() * self.labels.element_size())

    @staticmethod
    def nbytes_estimate(n_samples: int, input_size: int) -> int:
        per = input_size * input_size * 3 // 2 + LABEL_COLUMNS * 4
        return n_samples * per

    @classmethod
    def build(cls, dataset, indices, device, chunk: int = 2048,
              num_workers: int = 6, progress: bool = True) -> "DeviceData":
        """Decode ``indices`` of ``dataset`` (``load_planes``, ``labels_for``)
        chunk by chunk into tensors preallocated on ``device``: host memory
        holds a chunk at a time, device memory the corpus once. On a CUDA
        device each chunk goes through one of two pinned buffers by a
        non-blocking copy, so the next chunk decodes while it travels."""
        device = torch.device(device)
        indices = np.asarray(indices)
        n = len(indices)
        s = dataset.input_size
        P = s * s * 3 // 2
        pixels = torch.empty((n, P), dtype=torch.uint8, device=device)
        labels = torch.empty((n, LABEL_COLUMNS), dtype=torch.float32,
                             device=device)
        cuda = device.type == "cuda"
        rows = min(chunk, max(n, 1))
        staging = [(torch.empty((rows, P), dtype=torch.uint8, pin_memory=cuda),
                    torch.empty((rows, LABEL_COLUMNS), dtype=torch.float32,
                                pin_memory=cuda), [None]) for _ in range(2)]
        t0 = time.time()
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            for k, off in enumerate(range(0, n, chunk)):
                sel = indices[off:off + chunk]
                px, lb, done = staging[k % 2]
                if done[0] is not None:
                    done[0].synchronize()  # its previous chunk has landed
                px.numpy()[:len(sel)] = _pack_pixels(dataset, sel, pool)
                lb.numpy()[:len(sel)] = _pack_labels(dataset, sel)
                pixels[off:off + len(sel)].copy_(px[:len(sel)], non_blocking=cuda)
                labels[off:off + len(sel)].copy_(lb[:len(sel)], non_blocking=cuda)
                if cuda:
                    done[0] = torch.cuda.Event()
                    done[0].record()
                if progress and k % 4 == 0:
                    done_n = off + len(sel)
                    print(f"    device-cache upload {done_n}/{n} "
                          f"({done_n / max(time.time() - t0, 1e-9):.0f} img/s)",
                          file=sys.stderr, flush=True)
        if cuda:
            torch.cuda.synchronize(device)
        data = cls(pixels, labels, s)
        if progress:
            seconds = time.time() - t0
            print(f"    device-cache ready: {n} samples, "
                  f"{data.nbytes / 2**20:.0f} MB in {seconds:.1f}s "
                  f"({n / max(seconds, 1e-9):.0f} img/s)",
                  file=sys.stderr, flush=True)
        return data

    def epoch_plan(self, batch_size: int, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0,
                   drop_remainder: bool = False):
        """(idxs (steps, B) int32, mask (steps, B) f32) for one epoch, in
        ``data.BatchLoader``'s order (``default_rng(seed + epoch)``
        permutation of the local rows) and the JAX package's: a padded tail
        repeats the last row with mask 0."""
        order = np.arange(self.n)
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            order = order[rng.permutation(self.n)]
        if drop_remainder:
            steps = self.n // batch_size
            order = order[:steps * batch_size]
            mask = np.ones((steps, batch_size), np.float32)
            return order.reshape(steps, batch_size).astype(np.int32), mask
        steps = -(-self.n // batch_size)
        pad = steps * batch_size - self.n
        mask = np.ones(steps * batch_size, np.float32)
        if pad:
            mask[-pad:] = 0.0
            order = np.concatenate([order, np.full(pad, order[-1], order.dtype)])
        return (order.reshape(steps, batch_size).astype(np.int32),
                mask.reshape(steps, batch_size))


class DeviceBatchLoader:
    """``data.BatchLoader``'s interface over a ``DeviceData`` split: each
    batch is gathered on the device (``gather_batch``); the only copy to
    the device a step makes is its (B,) int32 index row. Shuffle order
    ``default_rng(seed + epoch)`` with an internal epoch counter,
    ``drop_remainder``, padded and masked tails, as the streaming loader.
    ``bytes_to_device`` counts the bytes its batches copied there."""

    def __init__(self, device_data: DeviceData, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = False):
        self.dd = device_data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self.bytes_to_device = 0

    def __len__(self) -> int:
        n = self.dd.n
        return (n // self.batch_size if self.drop_remainder
                else -(-n // self.batch_size))

    def __iter__(self):
        idxs, _ = self.dd.epoch_plan(
            self.batch_size, shuffle=self.shuffle, seed=self.seed,
            epoch=self.epoch, drop_remainder=self.drop_remainder)
        self.epoch += 1
        device = self.dd.pixels.device
        for step in range(idxs.shape[0]):
            idx = torch.from_numpy(idxs[step]).to(device, non_blocking=True)
            self.bytes_to_device += idxs[step].nbytes
            # the plan's mask, made on the device: rows past n are padding
            first = step * self.batch_size
            real = torch.arange(first, first + self.batch_size,
                                device=device) < self.dd.n
            yield gather_batch(self.dd.pixels, self.dd.labels, idx, real)


def gather_batch(pixels: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                 mask: torch.Tensor) -> dict:
    """The ``packed`` transport's batch for rows ``idx``, assembled on the
    device: {"pixels" (B, P) uint8, "labels" (B, 71) f32 with the mask as the
    last column}."""
    lb = labels.index_select(0, idx)
    return {"pixels": pixels.index_select(0, idx),
            "labels": torch.cat([lb, mask.to(lb.dtype)[:, None]], dim=1)}
