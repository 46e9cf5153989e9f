"""Dataset and host-side input pipeline (the port's own copy of
``chess_vision_tpu/data.py``; numpy and PIL, no device code).

ChessDataset has two modes: manifest-CSV mode (auto-detected
{root}/manifest.csv, full FEN + metadata columns) and filename-FEN mode
(Kaggle; `legal` is 0 for every sample).

The host side does only what the device cannot: file IO, JPEG decode, and the
PIL bilinear resize to the model input size. Everything downstream
(augmentation, normalization) runs on the device (see augment.py). Batches
are delivered as uint8 numpy arrays by a double-buffered thread-pool loader,
so decode overlaps device compute; staging into pinned memory and the copy to
the device belong to the training loop, not to the loader. A seed gives the
same batch order here as in the JAX package. PIL is imported where an image
is decoded, so the module imports without it.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chess_vision_tpu_torch.fen import (
    fen_to_labels,
    filename_to_fen,
    parse_full_fen,
)
from chess_vision_tpu_torch.parallel.mesh import shard_rows

IMAGE_EXTS = (".jpeg", ".jpg", ".png")


class ChessDataset:
    """Map-style dataset of board images + per-square labels."""

    def __init__(
        self,
        root_dir: str,
        max_samples: int | None = None,
        manifest: str | None = None,
        input_size: int = 256,
        fast_decode: bool = True,
        cache_decoded: bool = False,
        cache_budget_gb: float = 8.0,
    ):
        self.root_dir = root_dir
        self.input_size = input_size
        self.fast_decode = fast_decode
        # Decoded-sample RAM cache for multi-epoch training: decode output is
        # deterministic per sample (all augmentation runs device-side), so
        # epochs 2+ skip JPEG decode entirely. ~96KB/sample for the ycbcr420
        # transport (~4.3GB for a 45k split), ~192KB for RGB. dict get/set are
        # single bytecode ops under the GIL — safe from loader threads.
        # Bounded: once cache_budget_gb of decoded bytes are held, further
        # samples are decoded fresh each epoch instead of cached (no OOM at
        # reference-scale corpora on small hosts).
        self._cache: dict | None = {} if cache_decoded else None
        self._cache_bytes = 0
        self._cache_budget = int(cache_budget_gb * 2**30)

        if manifest is None:
            manifest = os.path.join(root_dir, "manifest.csv")

        if os.path.exists(manifest):
            with open(manifest, newline="") as f:
                self.samples = [dict(row) for row in csv.DictReader(f)]
            self.use_manifest = True
        else:
            self.samples = [
                {"filename": f}
                for f in sorted(os.listdir(root_dir))
                if f.lower().endswith(IMAGE_EXTS)
            ]
            self.use_manifest = False

        if max_samples is not None:
            self.samples = self.samples[:max_samples]

    def __len__(self) -> int:
        return len(self.samples)

    def get_metadata(self, idx: int) -> dict:
        """Raw manifest row (for eval grouping)."""
        return self.samples[idx]

    def labels_for(self, idx: int) -> dict:
        sample = self.samples[idx]
        fen = sample.get("fen")
        if self.use_manifest and fen:
            labels = parse_full_fen(fen)
        else:
            labels = {
                "squares": fen_to_labels(filename_to_fen(sample["filename"])),
                "turn": np.zeros(1, np.float32),
                "castling": np.zeros(4, np.float32),
            }
        if self.use_manifest:
            legal = sample.get("legal", "1") == "1"
        else:
            legal = False
        labels["legal"] = np.asarray([1.0 if legal else 0.0], np.float32)
        return labels

    def _cache_put(self, key, value) -> None:
        if self._cache is None or key in self._cache:
            return
        nbytes = (value.nbytes if isinstance(value, np.ndarray)
                  else sum(p.nbytes for p in value))
        if self._cache_bytes + nbytes > self._cache_budget:
            return
        self._cache[key] = value
        self._cache_bytes += nbytes

    def _decode_rgb(self, idx: int) -> np.ndarray:
        path = os.path.join(self.root_dir, self.samples[idx]["filename"])
        out = None
        if self.fast_decode:
            from chess_vision_tpu_torch import native

            out = native.decode_file(path, self.input_size)
        if out is None:
            from PIL import Image

            img = Image.open(path).convert("RGB")
            if img.size != (self.input_size, self.input_size):
                img = img.resize(
                    (self.input_size, self.input_size), Image.BILINEAR
                )
            out = np.asarray(img, dtype=np.uint8)
        return out

    def load_image(self, idx: int) -> np.ndarray:
        """uint8 (input_size, input_size, 3).

        JPEGs go through the native libjpeg decode+resize (GIL-releasing,
        PIL-parity triangle filter, chess_vision_tpu_torch/native) when available;
        everything else (and fast_decode=False) uses PIL BILINEAR.
        """
        if self._cache is not None:
            hit = self._cache.get(("rgb", idx))
            if hit is not None:
                return hit
        out = self._decode_rgb(idx)
        self._cache_put(("rgb", idx), out)
        return out

    def load_planes(self, idx: int):
        """(Y, Cb, Cr) uint8 planes for the YCbCr-4:2:0 transport: native raw
        JPEG decode when possible, else RGB decode + host conversion."""
        from chess_vision_tpu_torch import native

        if self._cache is not None:
            hit = self._cache.get(("ycbcr", idx))
            if hit is not None:
                return hit
        path = os.path.join(self.root_dir, self.samples[idx]["filename"])
        planes = native.decode_file_ycbcr420(path, self.input_size)
        if planes is None:
            from chess_vision_tpu_torch.ops.preprocess import rgb_to_ycbcr420

            # _decode_rgb (not load_image): don't also pin the intermediate
            # RGB copy in the cache when only planes were requested
            planes = rgb_to_ycbcr420(self._decode_rgb(idx))
        self._cache_put(("ycbcr", idx), planes)
        return planes

    def __getitem__(self, idx: int):
        return self.load_image(idx), self.labels_for(idx)


def seeded_split(n: int, val_fraction: float, seed: int = 42):
    """Deterministic train/val index split (augmentation runs on the device
    in the train step only, so one dataset instance serves both)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    val_size = int(n * val_fraction)
    train_size = n - val_size
    return perm[:train_size], perm[train_size:]


class BatchLoader:
    """Thread-pool batch loader with background prefetch.

    Yields dicts of numpy arrays:
      image (B, S, S, 3) uint8; squares (B, 64) int32;
      turn (B, 1) f32; castling (B, 4) f32; legal (B, 1) f32.

    When drop_remainder is False the final short batch is padded up to
    batch_size by repeating the last sample, with `mask` marking real rows:
    every batch has one shape and the metric counts stay exact.

    `shard` = (index, count) yields shard `index` of `count` contiguous
    shards of each batch (`parallel.mesh.shard_rows`), in the same order and
    padding, and decodes only its rows: a data-parallel rank's slice of the
    global batch. `indices`, `mask` and `n_real` are then the shard's.
    """

    def __init__(
        self,
        dataset: ChessDataset,
        indices,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 6,
        drop_remainder: bool = False,
        prefetch: int = 2,
        transport: str = "rgb",
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.transport = transport  # "rgb" | "ycbcr420" | "packed"
        self.rows = shard_rows(batch_size, *shard)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _make_batch(self, pool, idx_chunk) -> dict:
        n_real = len(idx_chunk)
        if n_real < self.batch_size and not self.drop_remainder:
            pad = np.full(self.batch_size - n_real, idx_chunk[-1])
            idx_chunk = np.concatenate([idx_chunk, pad])
        mask = np.zeros(len(idx_chunk), np.float32)
        mask[:n_real] = 1.0
        idx_chunk, mask = idx_chunk[self.rows], mask[self.rows]
        n_real = int(mask.sum())
        labels = [self.dataset.labels_for(i) for i in idx_chunk]
        batch = {
            "squares": np.stack([l["squares"] for l in labels]).astype(np.int32),
            "turn": np.stack([l["turn"] for l in labels]),
            "castling": np.stack([l["castling"] for l in labels]),
            "legal": np.stack([l["legal"] for l in labels]),
            "mask": mask,
            "indices": np.asarray(idx_chunk, np.int64),
            "n_real": n_real,
        }
        if self.transport == "ycbcr420":
            planes = list(pool.map(self.dataset.load_planes, idx_chunk))
            batch["y"] = np.stack([p[0] for p in planes])
            batch["cb"] = np.stack([p[1] for p in planes])
            batch["cr"] = np.stack([p[2] for p in planes])
        elif self.transport == "packed":
            # One uint8 pixel buffer + one f32 label buffer per batch: the
            # fewest host->device copies. Pixels are YCbCr-4:2:0 planes
            # flattened and concatenated; labels/mask are packed columns.
            planes = list(pool.map(self.dataset.load_planes, idx_chunk))
            B = len(planes)
            batch["pixels"] = np.concatenate(
                [
                    np.stack([p[0] for p in planes]).reshape(B, -1),
                    np.stack([p[1] for p in planes]).reshape(B, -1),
                    np.stack([p[2] for p in planes]).reshape(B, -1),
                ],
                axis=1,
            )
            batch["labels"] = np.concatenate(
                [
                    batch.pop("squares").astype(np.float32),
                    batch.pop("turn"),
                    batch.pop("castling"),
                    batch.pop("legal"),
                    batch.pop("mask")[:, None],
                ],
                axis=1,
            ).astype(np.float32)
        else:
            batch["image"] = np.stack(
                list(pool.map(self.dataset.load_image, idx_chunk))
            )
        return batch

    def __iter__(self):
        order = self.indices
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = order[rng.permutation(len(order))]
        self.epoch += 1

        nb = len(self)
        chunks = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer(pool):
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(pool, chunk))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            t = threading.Thread(target=producer, args=(pool,), daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()
                # drain so the producer can exit
                while t.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.1)
