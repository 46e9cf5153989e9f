"""Where int8 and bf16 disagree, the kernels or the int8 scheme?

The North star's gate is board agreement 1.0 between the int8 (W8A8) and the
bf16 serving paths of a trained checkpoint (``int8_eval.py`` reads it). This
script reads the same boards through three forwards on the card, in each int8
layout (block, flat and fused): bf16, int8 on the kernels and int8 on the
kernels' plain versions (``experiments/plain.py``), and compares their square
logits:

    python -m chess_vision_tpu_torch.experiments.int8_gate --checkpoint C \\
        --test-dir D [--max-samples 4096] [--calib 64] [--out gate.json] \\
        [--device cpu]

For each layout it reports the int8 kernels' and the plain versions' board
agreement with bf16, and the kernels' with the plain versions; and for every
board where any two of the three forwards disagree, the squares where they
do, each side's class and its top-2 logit margin. Where the kernels and
their plain versions give the same classes on the board, the int8 scheme is
the cause of its disagreement with bf16 ("int8 scheme"); where they do not
("kernels differ from plain"), it runs the board alone with each kernel
alone on the kernels and alone on its plain version (``ablate``), which
names the kernel that moves it.

Then it reads which choice of the int8 scheme moves the boards that
disagree (``schemes``): the plain versions of the block layout, on the same
checkpoint, with one choice changed at a time against the serving scheme
(sigmoid GELU in fc1, shifts calibrated on ``--calib`` boards, RGB input):
the XLA-form block (``plain.xla_form_blocks``: bf16 attention, then dynamic
row quantization, the arithmetic of the JAX package's ``xla`` layout), the
erf GELU, no calibration (``calib_0``: the JAX default, the bound shift),
no calibration under the exact row max (``calib_0_max``,
``CHESS_VISION_ATTN_SOFTMAX=max``: what ``calib_0`` read before the bound was
ported), and 4:2:0 input (the files' own planes, held against bf16 on the
same planes).
Every agreement is given on all the boards and on the first 512 (the JAX
package's gate read 512). Prints one JSON object (and writes it to
``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

BATCH = 256
LAYOUTS = ("block", "flat", "fused")
FIRST = 512  # the JAX package's gate was read on 512 boards
# one choice of the serving scheme changed at a time: (CHESS_VISION_GELU,
# calibrated, mode, XLA-form blocks, CHESS_VISION_ATTN_SOFTMAX)
SCHEMES = {"serving": ("sigmoid", True, "rgb", False, "bound"),
           "xla_form": ("sigmoid", True, "rgb", True, "bound"),
           "gelu_erf": ("erf", True, "rgb", False, "bound"),
           "calib_0": ("sigmoid", False, "rgb", False, "bound"),
           "calib_0_max": ("sigmoid", False, "rgb", False, "max"),
           "ycbcr420": ("sigmoid", True, "ycbcr420", False, "bound")}


def square_logits(predictor, boards) -> np.ndarray:
    """(N, 64, 13) f32 square logits of ``predictor``'s forward on uint8
    ``boards`` (or, in ycbcr420 mode, a tuple of plane stacks)."""
    from chess_vision_tpu_torch.experiments.plain import forward_logits

    return forward_logits(predictor, boards, BATCH)["squares"].reshape(-1, 64, 13)


def margins(logits: np.ndarray) -> np.ndarray:
    """Top-2 logit margin of every square."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def compare(bf16: np.ndarray, kernel: np.ndarray, plain: np.ndarray,
            files: list[str]) -> dict:
    """The agreements of the three forwards' classes, and each board where
    any two of them disagree, square by square."""
    ids = {k: v.argmax(-1) for k, v in
           (("bf16", bf16), ("kernel", kernel), ("plain", plain))}
    board = lambda a, b, n=None: float(  # noqa: E731
        (ids[a][:n] == ids[b][:n]).all(axis=1).mean())
    marg = {k: margins(v) for k, v in
            (("bf16", bf16), ("kernel", kernel), ("plain", plain))}
    differ = (ids["kernel"] != ids["bf16"]) | (ids["kernel"] != ids["plain"])
    boards = []
    for i in np.flatnonzero(differ.any(axis=1)):
        squares = []
        for s in np.flatnonzero(differ[i]):
            squares.append({
                "square": int(s),
                **{f"{k}_class": int(ids[k][i, s]) for k in ids},
                **{f"{k}_margin": float(marg[k][i, s]) for k in marg}})
        scheme = bool((ids["plain"][i] == ids["kernel"][i]).all())
        boards.append({
            "index": int(i), "file": os.path.basename(files[i]),
            "cause": "int8 scheme" if scheme else "kernels differ from plain",
            "max_abs_logit_kernel_vs_plain": float(
                np.abs(kernel[i] - plain[i]).max()),
            "squares": squares})
    return {
        "board_agreement_kernel_bf16": board("kernel", "bf16"),
        "board_agreement_plain_bf16": board("plain", "bf16"),
        "board_agreement_kernel_plain": board("kernel", "plain"),
        f"board_agreement_kernel_bf16_first_{FIRST}": board("kernel", "bf16", FIRST),
        f"board_agreement_plain_bf16_first_{FIRST}": board("plain", "bf16", FIRST),
        "square_agreement_kernel_bf16": float((ids["kernel"] == ids["bf16"]).mean()),
        "max_abs_logit_kernel_vs_plain": float(np.abs(kernel - plain).max()),
        "disagreeing_boards": boards,
        "causes": {c: sum(b["cause"] == c for b in boards)
                   for c in ("int8 scheme", "kernels differ from plain")},
    }


def ablate(predictor, board: np.ndarray, squares: list[int]) -> dict:
    """Which kernel moves a board's classes off the plain versions': the
    classes on ``squares`` of ``board`` (uint8 (1, S, S, 3)) through all the
    kernels, through all the plain versions, and, for each wrapper of
    ``experiments/plain.WRAPPERS``, with that wrapper alone on its kernel and
    with it alone on its plain version."""
    from chess_vision_tpu_torch.experiments.plain import WRAPPERS, plain_int8_ops

    def classes():
        logits = square_logits(predictor, board)[0, squares]
        return logits.argmax(-1).tolist()

    out = {"kernels": classes()}
    with plain_int8_ops():
        out["plain"] = classes()
    for name in WRAPPERS:
        with plain_int8_ops(keep=(name,)):
            alone = classes()
        with plain_int8_ops(keep=tuple(w for w in WRAPPERS if w != name)):
            out[name] = {"kernel_alone": alone, "plain_alone": classes()}
    return out


def agreement(reference: np.ndarray, logits: np.ndarray) -> dict:
    """Board agreement of two forwards' square classes on all the boards
    and on the first ``FIRST``, and the boards where they differ."""
    same = (reference.argmax(-1) == logits.argmax(-1)).all(axis=1)
    return {"board_agreement": float(same.mean()),
            f"board_agreement_first_{FIRST}": float(same[:FIRST].mean()),
            "disagreeing_boards": np.flatnonzero(~same).tolist()}


def scheme_readings(checkpoint, device, files, boards, bf16_logits,
                    calib: int) -> dict:
    """The plain block layout's agreement with bf16 under each of
    ``SCHEMES``; the ycbcr420 reading decodes the files' planes and holds
    int8 against bf16 on them."""
    from unittest import mock

    from chess_vision_tpu_torch.experiments.plain import (plain_int8_ops,
                                                          xla_form_blocks)
    from chess_vision_tpu_torch.serve import Predictor

    planes = reference = None
    out = {}
    for name, (gelu, calibrated, mode, xla, softmax) in SCHEMES.items():
        t0 = time.time()
        if mode == "ycbcr420" and planes is None:
            bf16 = Predictor(checkpoint, batch_size=BATCH, device=device,
                             mode=mode)
            decoded = [bf16._decode_planes(f) for f in files]
            planes = tuple(np.stack([p[i] for p in decoded]) for i in range(3))
            reference = square_logits(bf16, planes)
            del bf16, decoded
        env = {"CHESS_VISION_INT8_LAYOUT": "block", "CHESS_VISION_GELU": gelu,
               "CHESS_VISION_ATTN_SOFTMAX": softmax}
        with mock.patch.dict(os.environ, env):
            int8 = Predictor(checkpoint, batch_size=BATCH, device=device,
                             quant="int8", mode=mode,
                             calib_paths=files[:calib] if calibrated else None)
        with plain_int8_ops():
            with xla_form_blocks() if xla else contextlib.nullcontext():
                logits = square_logits(
                    int8, planes if mode == "ycbcr420" else boards)
        out[name] = agreement(reference if mode == "ycbcr420" else bf16_logits,
                              logits)
        out[name]["seconds"] = round(time.time() - t0, 1)
        print(f"scheme {name}: board agreement with bf16 "
              f"{out[name]['board_agreement']} (first {FIRST}: "
              f"{out[name][f'board_agreement_first_{FIRST}']}), boards "
              f"{out[name]['disagreeing_boards']}", file=sys.stderr, flush=True)
        del int8
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--test-dir", required=True)
    ap.add_argument("--max-samples", type=int, default=4096)
    ap.add_argument("--calib", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from unittest import mock

    import torch

    from chess_vision_tpu_torch.data import ChessDataset
    from chess_vision_tpu_torch.experiments.plain import plain_int8_ops
    from chess_vision_tpu_torch.fen import fen_to_labels
    from chess_vision_tpu_torch.serve import Predictor
    from chess_vision_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds = ChessDataset(args.test_dir, max_samples=args.max_samples)
    files = [os.path.join(args.test_dir, s["filename"]) for s in ds.samples]
    bf16 = Predictor(args.checkpoint, batch_size=BATCH, device=device)
    boards = np.stack([bf16._decode(f) for f in files])
    print(f"{len(files)} boards from {args.test_dir}", file=sys.stderr)
    bf16_logits = square_logits(bf16, boards)
    fens = bf16.predict_array(boards)
    served = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    if not (served == bf16_logits.argmax(-1)).all():
        raise RuntimeError("bf16 Predictor's FENs differ from its logits")
    del bf16

    out = {"checkpoint": args.checkpoint, "test_dir": args.test_dir,
           "boards": len(files), "calib": args.calib,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else str(device)),
           "layouts": {}}
    for layout in LAYOUTS:
        t0 = time.time()
        with mock.patch.dict(os.environ, {"CHESS_VISION_INT8_LAYOUT": layout}):
            int8 = Predictor(args.checkpoint, batch_size=BATCH, device=device,
                             quant="int8", calib_paths=files[:args.calib])
        kernel = square_logits(int8, boards)
        with plain_int8_ops():
            plain = square_logits(int8, boards)
        fens = int8.predict_array(boards)
        served = np.stack([fen_to_labels(f.split()[0]) for f in fens])
        result = compare(bf16_logits, kernel, plain, files)
        for board in result["disagreeing_boards"]:
            if board["cause"] == "kernels differ from plain":
                i = board["index"]
                board["ablation"] = ablate(
                    int8, boards[i:i + 1], [q["square"] for q in board["squares"]])
        result["served_equals_logits"] = bool((served == kernel.argmax(-1)).all())
        result["seconds"] = round(time.time() - t0, 1)
        out["layouts"][layout] = result
        print(f"{layout}: board agreement kernels/bf16 "
              f"{result['board_agreement_kernel_bf16']}, plain/bf16 "
              f"{result['board_agreement_plain_bf16']}, kernels/plain "
              f"{result['board_agreement_kernel_plain']}; disagreeing boards by "
              f"cause {result['causes']}", file=sys.stderr, flush=True)
        del int8
    out["schemes"] = scheme_readings(args.checkpoint, device, files, boards,
                                     bf16_logits, args.calib)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
