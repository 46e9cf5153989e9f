"""bf16 against int8 (W8A8) accuracy of a trained ChessViT checkpoint
(``experiments/int8_eval.py`` of the JAX package).

Both paths run through the serving stack (``serve.Predictor``: native
decode, the preprocess kernel, argmax FEN assembly) on the same held-out
files; prints each path's square, board, turn, castling and full-FEN accuracy
(turn and castling over legal boards), the int8 - bf16 deltas and how often
the two agree, per square and per board:

    python -m chess_vision_tpu_torch.experiments.int8_eval --checkpoint C \\
        --test-dir data/test [--max-samples 4096] [--batch-size 256] \\
        [--calib 64] [--mode ycbcr420|rgb] [--device cpu]

The int8 kernel layout is ``CHESS_VISION_INT8_LAYOUT`` (block, flat or
fused), read by the Predictor: run the script once per layout. ``--mode``
is the Predictor's input form, ``ycbcr420`` (the JPEG's 4:2:0 planes, the
default, as in the JAX script) or ``rgb``. Differences from the JAX script:
``--calib 0`` means the exact row max in every softmax (the JAX package's
"adaptive bound" shifts are not ported); the JSON also names the layout,
the mode, the device, the board agreement on the first 512 boards (the JAX
package's gate was read on 512) and the indices of the boards whose
placements differ. It runs on the CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def metrics_from_fens(pred_fens, labels):
    n = len(pred_fens)
    sq_correct = 0
    board_ok = np.zeros(n, bool)
    turn_ok = np.zeros(n, bool)
    cast_ok = np.zeros(n, bool)
    legal = np.zeros(n, bool)
    from chess_vision_tpu_torch.fen import fen_to_labels

    pred_sq = np.zeros((n, 64), np.int32)
    for i, (fen, lab) in enumerate(zip(pred_fens, labels)):
        parts = fen.split()
        sq = fen_to_labels(parts[0])
        pred_sq[i] = sq
        eq = sq == lab["squares"]
        sq_correct += int(eq.sum())
        board_ok[i] = bool(eq.all())
        turn_ok[i] = (parts[1] == "b") == bool(lab["turn"][0] > 0.5)
        pred_cast = parts[2] if parts[2] != "-" else ""
        true_cast = "".join(
            c for c, f in zip("KQkq", lab["castling"]) if f > 0.5
        )
        cast_ok[i] = pred_cast == true_cast
        legal[i] = lab["legal"][0] > 0.5
    return {
        "square_acc": sq_correct / (n * 64),
        "board_acc": float(board_ok.mean()),
        "turn_acc": float(turn_ok[legal].mean()) if legal.any() else None,
        "castling_acc": float(cast_ok[legal].mean()) if legal.any() else None,
        "full_fen_acc": float((board_ok & turn_ok & cast_ok)[legal].mean())
        if legal.any() else None,
        "n": n, "n_legal": int(legal.sum()),
    }, pred_sq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--test-dir", default="data/test")
    ap.add_argument("--max-samples", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--mode", default="ycbcr420", choices=["ycbcr420", "rgb"],
                    help="the Predictor's input form")
    ap.add_argument("--calib", type=int, default=0,
                    help="calibrate per-layer softmax shifts on the first N "
                         "images (0 = the exact row max)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from chess_vision_tpu_torch.data import ChessDataset
    from chess_vision_tpu_torch.serve import Predictor
    from chess_vision_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds = ChessDataset(args.test_dir, max_samples=args.max_samples)
    paths = [os.path.join(args.test_dir, s["filename"]) for s in ds.samples]
    labels = [ds.labels_for(i) for i in range(len(ds))]
    print(f"{len(paths)} images from {args.test_dir}", file=sys.stderr)

    results = {}
    preds = {}
    layout = None
    for quant in (None, "int8"):
        name = quant or "bf16"
        t0 = time.time()
        p = Predictor(args.checkpoint, batch_size=args.batch_size,
                      mode=args.mode, quant=quant, device=device,
                      calib_paths=paths[:args.calib] if quant else None)
        fens = p.predict_files(paths)
        dt = time.time() - t0
        m, sq = metrics_from_fens(fens, labels)
        m["throughput"] = round(len(paths) / dt, 1)
        results[name] = m
        preds[name] = sq
        layout = p.layout or layout
        print(f"{name}: {json.dumps(m)}", file=sys.stderr)
        del p

    same = preds["bf16"] == preds["int8"]
    agree = float(same.mean())
    board_agree = float(same.all(axis=1).mean())
    out = {
        "test_dir": args.test_dir,
        "checkpoint": args.checkpoint,
        "bf16": results["bf16"],
        "int8": results["int8"],
        "delta_board_acc": round(
            results["int8"]["board_acc"] - results["bf16"]["board_acc"], 6),
        "delta_square_acc": round(
            results["int8"]["square_acc"] - results["bf16"]["square_acc"], 6),
        "square_agreement": round(agree, 6),
        "board_agreement": round(board_agree, 6),
        "board_agreement_first_512": round(
            float(same[:512].all(axis=1).mean()), 6),
        "layout": layout,
        "mode": args.mode,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "disagreeing_boards": np.flatnonzero(~same.all(axis=1)).tolist(),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
