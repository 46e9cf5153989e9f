"""Batched board image -> FEN serving on a CUDA GPU.

Counterpart of ``chess_vision_tpu/serve.py`` and the root ``serve.py`` CLI.
Pipeline: host thread-pool decode -> uint8 NHWC batch staged in pinned host
memory -> device (preprocess kernel, the model: ChessViT with the attention
kernel, ChessCNN or ChessSquareCNN; argmax; only 69 bytes of results per
board come back) -> host FEN assembly.
A bounded window of ``inflight`` batches lets decode, staging and FEN
assembly on the host overlap the device's work. ``quant="int8"`` serves the
W8A8 form instead (``ops/quant.py``: int8 GEMM, row-quant and quantizing
attention kernels), with per-layer softmax shifts calibrated on a few inputs
(else the JAX default "bound" shift);
``CHESS_VISION_INT8_LAYOUT=block|flat|fused|hybrid|xla`` picks its kernel
layout and ``CHESS_VISION_ATTN_SOFTMAX``, ``_ATTN_QK``, ``_ATTN_EXP`` and
``_EPILOGUE`` its serving modes (``ops/quant.Int8Modes``).

``devices=[...]`` serves over several devices from one process (the
``serve`` CLI's ``--dp`` takes every visible CUDA device): one replica of the
model, or of the int8 pack, per device (a device may be named twice: two
replicas on one card), each batch cut into contiguous shards that run on
their devices' streams side by side; the FENs come back in order. int8
calibration runs once and its shifts are shared.

``mode="ycbcr420"`` ships the JPEG's own 4:2:0 planes (Y at full size, Cb
and Cr at half size: half the bytes of RGB) and rebuilds normalized RGB on
the device in plain PyTorch (``ops/preprocess.ycbcr420_to_normalized``) in
place of the preprocess kernel; files are decoded to planes by the native
decoder, and ``predict_array``'s RGB boards are converted on the host.

    python -m chess_vision_tpu_torch.serve --checkpoint C --images dir_or_glob \
        [--mode ycbcr420] [--quant int8 --calib 8] [--dp]
"""

from __future__ import annotations

import argparse
import copy
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
from chess_vision_tpu_torch.parallel.mesh import shard_rows
from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint
from chess_vision_tpu_torch.utils.device import resolve_device

MODES = ("rgb", "ycbcr420")


def model_input(inputs, mean, std, dtype, mode: str = "rgb") -> torch.Tensor:
    """The normalized (B, S, S, 3) model input in ``dtype`` from a batch on
    the device: ``mode="rgb"`` takes (uint8 (B, S, S, 3),) through the
    preprocess kernel, ``"ycbcr420"`` takes the uint8 planes (Y (B, S, S),
    Cb, Cr (B, S/2, S/2)) through ``ycbcr420_to_normalized``."""
    if mode == "ycbcr420":
        return preprocess_ops.ycbcr420_to_normalized(*inputs, mean, std, dtype)
    return preprocess_ops.preprocess_u8(inputs[0], mean, std, dtype)


def make_infer_fn(model, mean, std, mode: str = "rgb"):
    """Inference function: the batch's inputs on the model's device (see
    ``model_input``) -> (square ids u8 (B,64), turn bool (B,), castling bool
    (B,4)), left on the device."""

    @torch.inference_mode()
    def infer(*inputs: torch.Tensor):
        out = model(model_input(inputs, mean, std, model.dtype, mode))
        preds = out["squares"].reshape(-1, 64, 13).argmax(dim=-1)
        return preds.to(torch.uint8), out["turn"][:, 0] > 0, out["castling"] > 0

    return infer


def make_int8_infer_fn(pack, mean, std, attn_shifts=None,
                       gelu: str = "sigmoid", num_heads: int = 12,
                       layout: str = "block", mode: str = "rgb",
                       modes: quant_ops.Int8Modes = quant_ops.Int8Modes()):
    """The int8 (W8A8) counterpart of ``make_infer_fn``: same inputs and
    outputs, ChessViT run by ``ops/quant.chessvit_int8_apply`` on ``pack``
    (the port's tensors) with the calibrated ``attn_shifts``, the fc1
    ``gelu``, the kernel ``layout`` and the serving ``modes`` closed in."""

    @torch.inference_mode()
    def infer(*inputs: torch.Tensor):
        x = model_input(inputs, mean, std, torch.bfloat16, mode)
        out = quant_ops.chessvit_int8_apply(pack, x, attn_shifts=attn_shifts,
                                            gelu=gelu, num_heads=num_heads,
                                            layout=layout, modes=modes)
        preds = out["squares"].reshape(-1, 64, 13).argmax(dim=-1)
        return preds.to(torch.uint8), out["turn"][:, 0] > 0, out["castling"] > 0

    return infer


class _Slot:
    """Host buffers of one in-flight batch: the staged inputs (the RGB images,
    or the Y, Cb and Cr planes) and the results, pinned on a CUDA device so
    both copies run asynchronously."""

    def __init__(self, batch: int, size: int, pin: bool, mode: str = "rgb"):
        shapes = ([(batch, size, size), (batch, size // 2, size // 2),
                   (batch, size // 2, size // 2)] if mode == "ycbcr420"
                  else [(batch, size, size, 3)])
        self.inputs = [torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
                       for shape in shapes]
        self.preds = torch.empty((batch, 64), dtype=torch.uint8, pin_memory=pin)
        self.turn = torch.empty((batch,), dtype=torch.bool, pin_memory=pin)
        self.castling = torch.empty((batch, 4), dtype=torch.bool, pin_memory=pin)
        self.done: list[torch.cuda.Event] = []  # one per shard


class Predictor:
    """Load a checkpoint once, predict FENs for images at max throughput.

    ``checkpoint`` is a path to a JAX-package checkpoint or a ``(cfg,
    params)`` pair with params in the JAX layout, or ``(cfg, params,
    batch_stats)`` for the square model's BatchNorm. Any arch serves in
    bf16; the weights are rounded to it once, here, and BatchNorm stays
    unfolded, as in the JAX package. ``device`` defaults to the
    CUDA device and raises without one; pass ``device="cpu"`` to run the
    plain PyTorch ops on the CPU.

    ``quant="int8"`` (ViT only) serves the W8A8 form: weights quantized once,
    and, given ``calib_paths``, per-layer softmax shifts calibrated on those
    images (without them, each layer's shift is the mode's: the "bound" by
    default, as in the JAX package). Its fc1 GELU is read from
    ``CHESS_VISION_GELU`` (default "sigmoid"), its kernel layout from
    ``CHESS_VISION_INT8_LAYOUT`` ("block", the default, "flat", "fused",
    "hybrid" or "xla") and its modes from ``CHESS_VISION_ATTN_SOFTMAX``,
    ``CHESS_VISION_ATTN_QK``, ``CHESS_VISION_ATTN_EXP`` and
    ``CHESS_VISION_EPILOGUE`` (``ops/quant.int8_modes``), all once, here; an
    unknown value raises. Then ``model`` is None and ``pack``,
    ``attn_shifts``, ``gelu``, ``layout`` and ``int8_modes`` hold what the
    forward runs on. Calibration images are decoded to RGB and normalized
    on the host in either ``mode``, as in the JAX package.

    ``mode="ycbcr420"`` stages and ships 4:2:0 planes (module docstring).

    ``devices`` (a list, instead of ``device``) serves over several devices:
    one replica each, ``batch_size`` cut into len(devices) contiguous shards
    (it must divide), a shard per device on the device's own stream. A
    failure on any device raises."""

    def __init__(self, checkpoint, batch_size: int = 256,
                 decode_workers: int = 8, inflight: int = 4,
                 mode: str = "rgb", quant: str | None = None, device=None,
                 calib_paths=None, devices=None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}; expected None or 'int8'")
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [resolve_device(device)])
        shard_rows(batch_size, 0, len(self.devices))  # it must divide
        self.device = self.devices[0]
        if isinstance(checkpoint, (str, os.PathLike)):
            ckpt = load_checkpoint(os.fspath(checkpoint))
            cfg, params = ckpt["config"], ckpt["params"]
            batch_stats = ckpt.get("batch_stats")
        else:
            cfg, params, batch_stats = (*checkpoint, None)[:3]
        self.cfg = cfg
        self.mode = mode
        self.input_size = cfg["model"].get("input_size") or 224
        data_cfg = get_data_config(cfg["model"].get("name", ""))
        self.model = self.pack = self.attn_shifts = self.gelu = None
        self.layout = self.int8_modes = None
        if quant == "int8":
            if cfg["model"].get("arch", "vit") != "vit":
                raise ValueError("int8 quantization currently supports arch=vit")
            self.gelu = quant_ops.approx_gelu()
            self.layout = quant_ops.int8_layout()
            self.int8_modes = quant_ops.int8_modes()
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
            self.packs = [int8_pack_from_jax(pack, d) for d in self.devices]
            self.pack = self.packs[0]
            self.infers = [make_int8_infer_fn(
                p, data_cfg["mean"], data_cfg["std"],
                attn_shifts=self.attn_shifts, gelu=self.gelu,
                num_heads=num_heads, layout=self.layout, mode=mode,
                modes=self.int8_modes)
                for p in self.packs]
        else:
            model = build_model(cfg)
            model.load_state_dict(
                state_dict_from_jax(params, cfg, batch_stats))
            model.cast_weights()
            self.models = [copy.deepcopy(model).to(d) for d in self.devices[1:]]
            self.model = model.to(self.device)
            self.models.insert(0, self.model)
            self.infers = [make_infer_fn(m, data_cfg["mean"], data_cfg["std"],
                                         mode=mode) for m in self.models]
        self.infer = self.infers[0]
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         and len(self.devices) > 1 else None
                         for d in self.devices]
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.inflight = inflight
        pin = self.device.type == "cuda"
        self._slots = [_Slot(batch_size, self.input_size, pin, mode)
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

    def _decode_planes(self, path: str):
        """(Y, Cb, Cr) uint8 planes: the native 4:2:0 decode when the JPEG
        has that form at the input size, else the RGB decode converted on
        the host."""
        from chess_vision_tpu_torch import native

        planes = native.decode_file_ycbcr420(path, self.input_size)
        if planes is not None:
            return planes
        return preprocess_ops.rgb_to_ycbcr420(self._decode(path))

    def _submit(self, inputs: tuple) -> tuple[int, _Slot]:
        """Stage up to batch_size inputs (a tuple of arrays in the slot's
        order; the tail padded with the last of them) and enqueue their
        inference. A slot is reused ``inflight`` submissions later, by which
        time its batch has been drained."""
        slot = self._slots[self._submitted % self.inflight]
        self._submitted += 1
        count = len(inputs[0])
        for buf, arr in zip(slot.inputs, inputs):
            staged = buf.numpy()
            staged[:count] = arr
            staged[count:] = arr[-1]
        slot.done = []
        if len(self.devices) == 1:  # the current stream
            self._run_shard(slot, slice(None), self.infers[0], self.device)
            return count, slot
        for i, (infer, device, stream) in enumerate(
                zip(self.infers, self.devices, self._streams)):
            rows = shard_rows(self.batch_size, i, len(self.devices))
            if stream is None:
                self._run_shard(slot, rows, infer, device)
                continue
            # the shard's copies and forward queue on the device's stream,
            # after what the default stream has queued (slot reuse)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self._run_shard(slot, rows, infer, device)
        return count, slot

    @staticmethod
    def _run_shard(slot: _Slot, rows: slice, infer, device) -> None:
        """Rows ``rows`` of the slot through ``infer`` on ``device``, their
        results copied back into the slot; on CUDA an event marks the end."""
        preds, turn, castling = infer(
            *(buf[rows].to(device, non_blocking=True) for buf in slot.inputs))
        slot.preds[rows].copy_(preds, non_blocking=True)
        slot.turn[rows].copy_(turn, non_blocking=True)
        slot.castling[rows].copy_(castling, non_blocking=True)
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            slot.done.append(event)

    @staticmethod
    def _drain(count: int, slot: _Slot) -> list[str]:
        for event in slot.done:
            event.synchronize()
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
        """uint8 (N,S,S,3) RGB -> N FEN strings (padding the tail batch). In
        ycbcr420 mode a producer thread converts each batch to planes on the
        host, split over the ``decode_workers`` pool, while earlier batches
        run."""
        self._check_images(images_u8)
        chunks = (images_u8[start:start + self.batch_size]
                  for start in range(0, images_u8.shape[0], self.batch_size))
        if self.mode == "rgb":
            return self._run((chunk,) for chunk in chunks)

        def planes(pool):
            for chunk in chunks:
                yield preprocess_ops.rgb_to_ycbcr420_batch(chunk, pool)

        return self._run(self._ahead(planes))

    def predict_files(self, paths: list[str]) -> list[str]:
        """Streaming image files -> FENs: decode overlaps device compute."""
        ycbcr = self.mode == "ycbcr420"
        decode = self._decode_planes if ycbcr else self._decode

        def batches(pool):
            for start in range(0, len(paths), self.batch_size):
                items = list(pool.map(decode,
                                      paths[start:start + self.batch_size]))
                yield (tuple(np.stack([p[i] for p in items]) for i in range(3))
                       if ycbcr else (np.stack(items),))

        return self._run(self._ahead(batches))

    def _ahead(self, produce):
        """Yield the batches of ``produce(pool)``, a generator run on a
        producer thread with the ``decode_workers`` pool, up to ``inflight``
        batches ahead of the consumer."""
        batch_q: queue.Queue = queue.Queue(maxsize=self.inflight)

        def producer():
            try:
                with ThreadPoolExecutor(self.decode_workers) as pool:
                    for batch in produce(pool):
                        batch_q.put(batch)
                batch_q.put(None)
            except Exception as exc:  # handed to the consumer, which raises it
                batch_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while (item := batch_q.get()) is not None:
            if isinstance(item, Exception):
                raise item
            yield item
        thread.join()

    def _run(self, batches) -> list[str]:
        """Submit each batch of inputs, keeping ``inflight`` in flight;
        returns their FENs in order."""
        fens: list[str] = []
        window: list[tuple[int, _Slot]] = []
        for inputs in batches:
            window.append(self._submit(inputs))
            if len(window) >= self.inflight:
                fens.extend(self._drain(*window.pop(0)))
        while window:
            fens.extend(self._drain(*window.pop(0)))
        return fens


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--images", required=True,
                        help="directory or glob of board images")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--decode-workers", type=int, default=8)
    parser.add_argument("--mode", choices=list(MODES), default="rgb",
                        help="rgb: ship decoded RGB; ycbcr420: ship the "
                             "JPEG's 4:2:0 planes (half the bytes) and "
                             "rebuild RGB on the device")
    parser.add_argument("--quant", choices=["int8"], default=None,
                        help="int8 W8A8 serving (ViT only)")
    parser.add_argument("--calib", type=int, default=8,
                        help="int8 only: calibrate per-layer softmax shifts "
                             "on the first N inputs (0 = no calibration: "
                             "CHESS_VISION_ATTN_SOFTMAX's shift, the bound "
                             "by default)")
    parser.add_argument("--dp", action="store_true",
                        help="data-parallel serving over every visible CUDA "
                             "device (one replica each; --batch-size must "
                             "divide by their count)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    devices = None
    if args.dp:
        if args.device is not None:
            sys.exit("--dp serves on every visible CUDA device; drop --device")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            sys.exit("--dp needs a CUDA device")
        print(f"Data-parallel serving over {len(devices)} devices",
              file=sys.stderr)
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
        device=args.device, devices=devices,
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
