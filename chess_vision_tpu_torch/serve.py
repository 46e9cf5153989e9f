"""Batched board image -> FEN serving on a CUDA GPU.

Counterpart of ``chess_vision_tpu/serve.py`` and the root ``serve.py`` CLI.
Pipeline: host thread-pool decode -> uint8 NHWC batch staged in pinned host
memory -> device (preprocess kernel, ChessViT with the attention kernel,
argmax; only 69 bytes of results per board come back) -> host FEN assembly.
A bounded window of ``inflight`` batches lets decode, staging and FEN
assembly on the host overlap the device's work. ``quant="int8"`` serves the
W8A8 form instead (``ops/quant.py``: int8 GEMM, row-quant and quantizing
attention kernels), with per-layer softmax shifts calibrated on a few inputs;
``CHESS_VISION_INT8_LAYOUT=block|flat|fused`` picks its kernel layout.

    python -m chess_vision_tpu_torch.serve --checkpoint C --images dir_or_glob \
        [--quant int8 --calib 8]
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chess_vision_tpu_torch.fen import assemble_fens_batch
from chess_vision_tpu_torch.config import get_data_config
from chess_vision_tpu_torch.convert.jax_params import (
    int8_pack_from_jax,
    state_dict_from_jax,
)
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.ops import preprocess as preprocess_ops
from chess_vision_tpu_torch.ops import quant as quant_ops
from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint
from chess_vision_tpu_torch.utils.device import resolve_device


def make_infer_fn(model, mean, std):
    """Inference function: uint8 (B,S,S,3) on the model's device -> (square
    ids u8 (B,64), turn bool (B,), castling bool (B,4)), left on the device."""

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        x = preprocess_ops.preprocess_u8(images_u8, mean, std, model.dtype)
        out = model(x)
        preds = out["squares"].reshape(-1, 64, 13).argmax(dim=-1)
        return preds.to(torch.uint8), out["turn"][:, 0] > 0, out["castling"] > 0

    return infer


def make_int8_infer_fn(pack, mean, std, attn_shifts=None,
                       gelu: str = "sigmoid", num_heads: int = 12,
                       layout: str = "block"):
    """The int8 (W8A8) counterpart of ``make_infer_fn``: same input and
    outputs, ChessViT run by ``ops/quant.chessvit_int8_apply`` on ``pack``
    (the port's tensors) with the calibrated ``attn_shifts``, the fc1
    ``gelu`` and the kernel ``layout`` closed in."""

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        x = preprocess_ops.preprocess_u8(images_u8, mean, std, torch.bfloat16)
        out = quant_ops.chessvit_int8_apply(pack, x, attn_shifts=attn_shifts,
                                            gelu=gelu, num_heads=num_heads,
                                            layout=layout)
        preds = out["squares"].reshape(-1, 64, 13).argmax(dim=-1)
        return preds.to(torch.uint8), out["turn"][:, 0] > 0, out["castling"] > 0

    return infer


class _Slot:
    """Host buffers of one in-flight batch: the staged images and the results,
    pinned on a CUDA device so both copies run asynchronously."""

    def __init__(self, batch: int, size: int, pin: bool):
        self.images = torch.empty((batch, size, size, 3), dtype=torch.uint8,
                                  pin_memory=pin)
        self.preds = torch.empty((batch, 64), dtype=torch.uint8, pin_memory=pin)
        self.turn = torch.empty((batch,), dtype=torch.bool, pin_memory=pin)
        self.castling = torch.empty((batch, 4), dtype=torch.bool, pin_memory=pin)
        self.done: torch.cuda.Event | None = None


class Predictor:
    """Load a checkpoint once, predict FENs for images at max throughput.

    ``checkpoint`` is a path to a JAX-package checkpoint or a ``(cfg,
    params)`` pair with params in the JAX layout. ``device`` defaults to the
    CUDA device and raises without one; pass ``device="cpu"`` to run the
    plain PyTorch ops on the CPU.

    ``quant="int8"`` (ViT only) serves the W8A8 form: weights quantized once,
    and, given ``calib_paths``, per-layer softmax shifts calibrated on those
    images. Its fc1 GELU is read from ``CHESS_VISION_GELU`` (default
    "sigmoid") and its kernel layout from ``CHESS_VISION_INT8_LAYOUT``
    ("block", the default, "flat" or "fused"; the JAX package's "xla" and
    "hybrid" are not ported and raise), both once, here. Then ``model`` is
    None and ``pack``, ``attn_shifts``, ``gelu`` and ``layout`` hold what
    the forward runs on."""

    def __init__(self, checkpoint, batch_size: int = 256,
                 decode_workers: int = 8, inflight: int = 4,
                 mode: str = "rgb", quant: str | None = None, device=None,
                 calib_paths=None):
        if mode != "rgb":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP Queue A item 5)")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}; expected None or 'int8'")
        self.device = resolve_device(device)
        if isinstance(checkpoint, (str, os.PathLike)):
            ckpt = load_checkpoint(os.fspath(checkpoint))
            cfg, params = ckpt["config"], ckpt["params"]
        else:
            cfg, params = checkpoint
        self.cfg = cfg
        self.input_size = cfg["model"].get("input_size") or 224
        data_cfg = get_data_config(cfg["model"].get("name", ""))
        self.model = self.pack = self.attn_shifts = self.gelu = None
        self.layout = None
        if quant == "int8":
            if cfg["model"].get("arch", "vit") != "vit":
                raise ValueError("int8 quantization currently supports arch=vit")
            self.gelu = quant_ops.approx_gelu()
            self.layout = quant_ops.int8_layout()
            num_heads = cfg["model"].get("num_heads", 12)
            calib = None
            if calib_paths:
                # normalized on the host in f32, as the JAX Predictor does
                imgs = np.stack([self._decode(p) for p in calib_paths])
                m = np.asarray(data_cfg["mean"], np.float32) * 255.0
                sd = np.asarray(data_cfg["std"], np.float32) * 255.0
                calib = torch.from_numpy((imgs.astype(np.float32) - m) / sd)
                calib = calib.to(self.device)
            pack = quant_ops.quantize_chessvit(params, calib=calib,
                                               num_heads=num_heads,
                                               gelu=self.gelu)
            self.attn_shifts = pack.pop("attn_shifts", None)
            self.pack = int8_pack_from_jax(pack, self.device)
            self.infer = make_int8_infer_fn(
                self.pack, data_cfg["mean"], data_cfg["std"],
                attn_shifts=self.attn_shifts, gelu=self.gelu,
                num_heads=num_heads, layout=self.layout)
        else:
            self.model = build_model(cfg)
            self.model.load_state_dict(state_dict_from_jax(params, cfg))
            self.model.cast_weights().to(self.device)
            self.infer = make_infer_fn(self.model, data_cfg["mean"],
                                       data_cfg["std"])
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.inflight = inflight
        pin = self.device.type == "cuda"
        self._slots = [_Slot(batch_size, self.input_size, pin)
                       for _ in range(inflight)]
        self._submitted = 0

    def _decode(self, path: str) -> np.ndarray:
        from chess_vision_tpu_torch import native

        out = native.decode_file(path, self.input_size)
        if out is not None:
            return out
        from PIL import Image

        img = Image.open(path).convert("RGB")
        if img.size != (self.input_size, self.input_size):
            img = img.resize((self.input_size, self.input_size), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _submit(self, images: np.ndarray) -> tuple[int, _Slot]:
        """Stage up to batch_size images (the tail padded with the last one)
        and enqueue their inference. A slot is reused ``inflight`` submissions
        later, by which time its batch has been drained."""
        count = images.shape[0]
        slot = self._slots[self._submitted % self.inflight]
        self._submitted += 1
        staged = slot.images.numpy()
        staged[:count] = images
        staged[count:] = images[-1]
        preds, turn, castling = self.infer(
            slot.images.to(self.device, non_blocking=True))
        slot.preds.copy_(preds, non_blocking=True)
        slot.turn.copy_(turn, non_blocking=True)
        slot.castling.copy_(castling, non_blocking=True)
        if self.device.type == "cuda":
            slot.done = torch.cuda.Event()
            slot.done.record()
        return count, slot

    @staticmethod
    def _drain(count: int, slot: _Slot) -> list[str]:
        if slot.done is not None:
            slot.done.synchronize()
        return assemble_fens_batch(slot.preds.numpy()[:count],
                                   slot.turn.numpy()[:count],
                                   slot.castling.numpy()[:count])

    def _check_images(self, images_u8: np.ndarray) -> None:
        want = (self.input_size, self.input_size, 3)
        if images_u8.dtype != np.uint8 or images_u8.shape[1:] != want:
            raise ValueError(f"expected uint8 (N, {want[0]}, {want[1]}, 3) "
                             f"images, got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")

    def predict_array(self, images_u8: np.ndarray) -> list[str]:
        """uint8 (N,S,S,3) RGB -> N FEN strings (padding the tail batch)."""
        self._check_images(images_u8)
        fens: list[str] = []
        window: list[tuple[int, _Slot]] = []
        for start in range(0, images_u8.shape[0], self.batch_size):
            window.append(self._submit(images_u8[start:start + self.batch_size]))
            if len(window) >= self.inflight:
                fens.extend(self._drain(*window.pop(0)))
        while window:
            fens.extend(self._drain(*window.pop(0)))
        return fens

    def predict_files(self, paths: list[str]) -> list[str]:
        """Streaming image files -> FENs: decode overlaps device compute."""
        batch_q: queue.Queue = queue.Queue(maxsize=self.inflight)

        def producer():
            try:
                with ThreadPoolExecutor(self.decode_workers) as pool:
                    for start in range(0, len(paths), self.batch_size):
                        chunk = paths[start:start + self.batch_size]
                        batch_q.put(np.stack(list(pool.map(self._decode, chunk))))
                batch_q.put(None)
            except Exception as exc:  # handed to the consumer, which raises it
                batch_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        fens: list[str] = []
        window: list[tuple[int, _Slot]] = []
        while (item := batch_q.get()) is not None:
            if isinstance(item, Exception):
                raise item
            window.append(self._submit(item))
            if len(window) >= self.inflight:
                fens.extend(self._drain(*window.pop(0)))
        while window:
            fens.extend(self._drain(*window.pop(0)))
        thread.join()
        return fens


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--images", required=True,
                        help="directory or glob of board images")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--decode-workers", type=int, default=8)
    parser.add_argument("--mode", choices=["rgb", "ycbcr420"], default="rgb",
                        help="ycbcr420 is not ported yet")
    parser.add_argument("--quant", choices=["int8"], default=None,
                        help="int8 W8A8 serving (ViT only)")
    parser.add_argument("--calib", type=int, default=8,
                        help="int8 only: calibrate per-layer softmax shifts "
                             "on the first N inputs (0 = exact row-max "
                             "shifts, no calibration)")
    parser.add_argument("--dp", action="store_true",
                        help="data-parallel serving; not ported yet")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    if args.dp:
        raise NotImplementedError(
            "--dp is not ported yet (ROADMAP Queue A item 11)")
    if os.path.isdir(args.images):
        paths = sorted(
            os.path.join(args.images, f)
            for f in os.listdir(args.images)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
    else:
        paths = sorted(glob.glob(args.images))
    if not paths:
        sys.exit(f"no images found at {args.images}")

    predictor = Predictor(
        args.checkpoint, batch_size=args.batch_size,
        decode_workers=args.decode_workers, mode=args.mode, quant=args.quant,
        device=args.device,
        calib_paths=paths[:args.calib] if args.quant == "int8" else None,
    )
    t0 = time.time()
    fens = predictor.predict_files(paths)
    elapsed = time.time() - t0
    print(f"{len(paths)} boards in {elapsed:.2f}s "
          f"({len(paths) / elapsed:.0f} boards/s)", file=sys.stderr)

    lines = [f"{os.path.basename(p)}\t{fen}" for p, fen in zip(paths, fens)]
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
