"""Full evaluation suite (``chess_vision_tpu/evaluate.py``) and its CLI, the
counterpart of the root ``evaluate.py``:

    python -m chess_vision_tpu_torch.evaluate --checkpoint C [--test-dir D]
        [--manifest M] [--max-samples N] [--batch-size 64] [--device cpu]

Overall loss, square and board accuracy; turn, castling and full-FEN metrics
masked to legal == 1 samples; per-piece accuracy; the 13x13 piece confusion;
the 2x2 turn confusion; the ten worst boards with true and predicted FENs;
metrics grouped by manifest fields. Counts and confusions are summed on the
device; per batch only the predictions and the per-sample flags (one int8
(B, 68) tensor) come back to the host. The CLI reads the config from the
checkpoint and appends one row to ``eval_results.jsonl`` next to it. It runs
on the CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from datetime import datetime

import numpy as np
import torch

from chess_vision_tpu_torch.augment import preprocess_eval_batch
from chess_vision_tpu_torch.fen import INDEX_TO_PIECE, NUM_CLASSES, labels_to_fen
from chess_vision_tpu_torch.train.losses import weighted_smoothed_cross_entropy
from chess_vision_tpu_torch.train.loop import BatchStager

PIECE_NAMES = {i: ("empty" if i == 0 else INDEX_TO_PIECE[i]) for i in range(NUM_CLASSES)}
CASTLING_NAMES = ["K", "Q", "k", "q"]
# device sums of ``eval_batch``: int64 counts, the f64 loss sum
COUNT_KEYS = ("squares_correct", "boards_correct", "turn_correct_legal",
              "castling_all_correct_legal", "full_fen_correct_legal",
              "n_legal", "n")


def piece_count_bucket(count) -> str:
    count = int(count)
    if count <= 10:
        return "endgame (2-10)"
    if count <= 20:
        return "midgame (11-20)"
    return "opening (21-32)"


def castling_category(castling_str: str) -> str:
    return "none" if castling_str == "-" else "has_rights"


def _confusion(true: torch.Tensor, pred: torch.Tensor, weight: torch.Tensor,
               classes: int) -> torch.Tensor:
    """(classes, classes) int64 counts of (true, pred) pairs weighted by a 0/1
    ``weight``: ``torch.bincount`` of true * classes + pred, with the
    weight-0 pairs sent to one bin past the matrix (integer counts, so the
    same on every run on CUDA)."""
    index = true.long() * classes + pred.long()
    index = torch.where(weight > 0, index, classes * classes)
    counts = torch.bincount(index.reshape(-1), minlength=classes * classes + 1)
    return counts[:classes * classes].reshape(classes, classes)


def make_eval_batch_fn(model, mean, std):
    """``eval_batch(batch)`` on a device batch: the model in eval mode under
    ``torch.no_grad``; returns ``results``, int8 (B, 68) (the 64 predicted
    squares, then board correct, turn correct, castling correct and the
    number of wrong squares), and the batch's sums on the device: the counts
    of ``COUNT_KEYS``, ``loss_sum`` (plain unweighted cross entropy over the
    real rows times their number), ``castling_right_correct_legal`` (4,),
    ``conf`` (13, 13) over real rows and ``turn_conf`` (2, 2) over legal
    rows."""

    @torch.no_grad()
    def eval_batch(batch: dict) -> dict:
        model.eval()
        out = model(preprocess_eval_batch(batch, mean, std))

        sq_logits = out["squares"].reshape(-1, 64, NUM_CLASSES)
        sq_labels = batch["squares"].long()
        mask = batch["mask"]
        real = mask > 0
        legal = (batch["legal"][:, 0] * mask) > 0

        preds = sq_logits.argmax(dim=-1)
        wrong = preds != sq_labels
        board_correct = ~wrong.any(dim=1) & real

        # plain unweighted CE on real rows (reference evaluate.py:50,96)
        piece_loss = weighted_smoothed_cross_entropy(
            sq_logits.reshape(-1, NUM_CLASSES), sq_labels.reshape(-1),
            sample_mask=mask.repeat_interleave(64))

        turn_pred = out["turn"][:, 0] > 0
        turn_correct = turn_pred == (batch["turn"][:, 0] > 0)
        castling_right_correct = (out["castling"] > 0) == (batch["castling"] > 0)
        castling_all_correct = castling_right_correct.all(dim=1)
        num_wrong = wrong.sum(dim=1) * real

        results = torch.cat([
            preds, board_correct[:, None], turn_correct[:, None],
            castling_all_correct[:, None], num_wrong[:, None]],
            dim=1).to(torch.int8)
        count = lambda x: x.sum(dtype=torch.int64)  # noqa: E731
        return {
            "results": results,
            "loss_sum": piece_loss.double() * mask.double().sum(),
            "squares_correct": count(~wrong & real[:, None]),
            "boards_correct": count(board_correct),
            "turn_correct_legal": count(turn_correct & legal),
            "castling_right_correct_legal": (
                castling_right_correct & legal[:, None]).sum(dim=0),
            "castling_all_correct_legal": count(castling_all_correct & legal),
            "full_fen_correct_legal": count(
                board_correct & turn_correct & castling_all_correct & legal),
            "n_legal": count(legal),
            "n": count(real),
            "conf": _confusion(sq_labels, preds, real[:, None].expand_as(preds),
                               NUM_CLASSES),
            "turn_conf": _confusion(batch["turn"][:, 0] > 0, turn_pred, legal, 2),
        }

    return eval_batch


def evaluate(model, dataset, loader, mean, std, verbose: bool = True) -> dict:
    """Evaluate ``model`` (a module holding its weights, on the device it
    runs on) over ``loader``'s batches of ``dataset``; returns the metrics
    dict of the JAX package's ``evaluate`` and, with ``verbose``, prints its
    report byte for byte. Unlike the JAX function it takes no ``params``,
    ``batch_stats`` or ``mesh``: the module holds its weights, and
    multi-device evaluation is not ported (ROADMAP Queue A item 11)."""
    eval_batch = make_eval_batch_fn(model, mean, std)
    stager = BatchStager(next(model.parameters()).device)

    sums = None
    sample_results = []
    worst = []

    for batch in loader:
        indices = batch["indices"]
        n_real = batch["n_real"]
        out = eval_batch(stager(batch))
        sums = out if sums is None else {
            k: v if k == "results" else sums[k] + v for k, v in out.items()}

        results = out["results"].cpu().numpy()  # the batch's one read
        preds = results[:, :64]
        board_correct, turn_ok, castling_ok, num_wrong = results[:, 64:].T
        legal = batch["legal"][:, 0] > 0

        for i in range(n_real):
            idx = int(indices[i])
            sample_results.append({
                "idx": idx,
                "board_correct": bool(board_correct[i]),
                "squares_wrong": int(num_wrong[i]),
                "turn_correct": bool(turn_ok[i]) if legal[i] else None,
                "castling_correct": bool(castling_ok[i]) if legal[i] else None,
            })
            if num_wrong[i] > 0:
                worst.append((
                    int(num_wrong[i]),
                    labels_to_fen(batch["squares"][i]),
                    labels_to_fen(preds[i]),
                    idx,
                ))

    if sums is None:  # no batch: every count is zero
        conf = np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
        turn_conf = np.zeros((2, 2), np.int64)
        castling_right = np.zeros(4, np.int64)
        scalars = defaultdict(float)
    else:
        conf = sums["conf"].cpu().numpy()
        turn_conf = sums["turn_conf"].cpu().numpy()
        castling_right = sums["castling_right_correct_legal"].cpu().numpy()
        scalars = {k: float(sums[k]) for k in ("loss_sum", *COUNT_KEYS)}
    n = max(scalars["n"], 1.0)
    n_legal = scalars["n_legal"]
    metrics = {
        "loss": scalars["loss_sum"] / n,
        "square_acc": scalars["squares_correct"] / (n * 64),
        "board_acc": scalars["boards_correct"] / n,
        "turn_acc": scalars["turn_correct_legal"] / max(n_legal, 1),
        "castling_acc": scalars["castling_all_correct_legal"] / max(n_legal, 1),
        "full_fen_acc": scalars["full_fen_correct_legal"] / max(n_legal, 1),
        "total_boards": int(n),
        "total_legal": int(n_legal),
    }

    if verbose:
        _print_report(metrics, conf, turn_conf, castling_right, worst)
        print_grouped_metrics(dataset, sample_results)

    return metrics


def _print_report(metrics, conf, turn_conf, castling_right, worst):
    # The JAX package's report text, byte for byte (its own comment: a
    # stated parity goal with the reference evaluate.py:159-287).
    n = metrics["total_boards"]
    n_legal = metrics["total_legal"]
    print("\n" + "=" * 60)
    print("EVALUATION RESULTS")
    print("=" * 60)

    total_squares = n * 64
    correct_squares = int(round(metrics["square_acc"] * total_squares))
    correct_boards = int(round(metrics["board_acc"] * n))
    print(f"\nOverall ({n} images, {n_legal} legal):")
    print(f"  Loss:            {metrics['loss']:.4f}")
    print(f"  Per-square acc:  {metrics['square_acc']:.4f} "
          f"({correct_squares}/{total_squares})")
    print(f"  Full-board acc:  {metrics['board_acc']:.4f} "
          f"({correct_boards}/{n})")

    if n_legal > 0:
        correct_turn = int(round(metrics["turn_acc"] * n_legal))
        print("\nTurn prediction (legal positions only):")
        print(f"  Accuracy:        {metrics['turn_acc']:.4f} "
              f"({correct_turn}/{n_legal})")
        print("  Confusion (rows=true, cols=pred):")
        print("             White  Black")
        print(f"    White  {turn_conf[0, 0]:>6d} {turn_conf[0, 1]:>6d}")
        print(f"    Black  {turn_conf[1, 0]:>6d} {turn_conf[1, 1]:>6d}")

        print("\nCastling prediction (legal positions only):")
        for r in range(4):
            acc = castling_right[r] / n_legal
            print(f"  {CASTLING_NAMES[r]:>1s}: {acc:.4f} "
                  f"({int(castling_right[r])}/{n_legal})")
        correct_castling = int(round(metrics["castling_acc"] * n_legal))
        print(f"  All-4-correct:   {metrics['castling_acc']:.4f} "
              f"({correct_castling}/{n_legal})")

        correct_full = int(round(metrics["full_fen_acc"] * n_legal))
        print("\nFull FEN accuracy (position + turn + castling, legal only):")
        print(f"  {metrics['full_fen_acc']:.4f} ({correct_full}/{n_legal})")
    else:
        print("\nNo legal positions in dataset — turn/castling metrics skipped.")

    print("\nPer-piece accuracy:")
    for c in range(NUM_CLASSES):
        total = conf[c].sum()
        if total > 0:
            correct = conf[c, c]
            print(f"  {PIECE_NAMES[c]:>5s}: {correct / total:.4f}  "
                  f"({correct}/{total})")

    print("\nConfusion matrix (rows=true, cols=predicted):")
    header = "       " + "".join(f"{PIECE_NAMES[c]:>6s}" for c in range(NUM_CLASSES))
    print(header)
    for t in range(NUM_CLASSES):
        row = f"  {PIECE_NAMES[t]:>4s} " + "".join(
            f"{conf[t, p]:>6d}" for p in range(NUM_CLASSES)
        )
        print(row)

    worst.sort(key=lambda x: -x[0])
    print("\nTop 10 worst predictions:")
    for num_wrong, fen_true, fen_pred, idx in worst[:10]:
        print(f"  Image {idx}: {num_wrong}/64 squares wrong")
        print(f"    True: {fen_true}")
        print(f"    Pred: {fen_pred}")


def print_grouped_metrics(dataset, sample_results):
    """Accuracy breakdowns grouped by manifest metadata fields
    (reference evaluate.py:233-287)."""
    if not getattr(dataset, "use_manifest", False) or not sample_results:
        return

    grouping_fields = {
        "piece_count": piece_count_bucket,
        "castling": castling_category,
        "turn": lambda x: "white" if x == "w" else "black",
        "has_highlight": lambda x: "highlighted" if x == "1" else "no highlight",
        "style": lambda x: x,
        "flipped": lambda x: "flipped" if x == "1" else "normal",
    }

    print("\n" + "=" * 60)
    print("GROUPED METRICS")
    print("=" * 60)

    for field, bucket_fn in grouping_fields.items():
        if field not in dataset.get_metadata(0):
            continue
        groups = defaultdict(lambda: {
            "total": 0, "board_correct": 0,
            "turn_correct": 0, "turn_total": 0,
            "castling_correct": 0, "castling_total": 0,
        })
        for result in sample_results:
            meta = dataset.get_metadata(result["idx"])
            bucket = bucket_fn(meta.get(field, ""))
            g = groups[bucket]
            g["total"] += 1
            g["board_correct"] += result["board_correct"]
            if result["turn_correct"] is not None:
                g["turn_total"] += 1
                g["turn_correct"] += result["turn_correct"]
            if result["castling_correct"] is not None:
                g["castling_total"] += 1
                g["castling_correct"] += result["castling_correct"]

        print(f"\nBy {field}:")
        for bucket in sorted(groups.keys()):
            g = groups[bucket]
            board_acc = g["board_correct"] / g["total"] if g["total"] else 0
            line = f"  {bucket:>20s}: board_acc={board_acc:.4f} (n={g['total']})"
            if g["turn_total"]:
                line += f"  turn={g['turn_correct'] / g['turn_total']:.4f}"
            if g["castling_total"]:
                line += (
                    f"  castling={g['castling_correct'] / g['castling_total']:.4f}"
                )
            print(line)


def load_model(checkpoint: str, device=None):
    """The checkpoint's model (any arch, its BatchNorm statistics included)
    with its weights on ``device`` (the CUDA device unless given), in eval
    mode and its compute dtype; returns it and the config read from the
    checkpoint."""
    from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
    from chess_vision_tpu_torch.models import build_model
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint
    from chess_vision_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ckpt = load_checkpoint(checkpoint)
    cfg = ckpt["config"]
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(ckpt["params"], cfg,
                                              ckpt.get("batch_stats")))
    return model.cast_weights().to(device).eval(), cfg


def main(argv=None):
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader, ChessDataset

    parser = argparse.ArgumentParser(description="Evaluate chess model on test set")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--test-dir", default=None, help="Override test directory")
    parser.add_argument("--manifest", default=None, help="Manifest CSV path")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)

    model, cfg = load_model(args.checkpoint, args.device)
    input_size = cfg["model"].get("input_size") or 224

    test_dir = args.test_dir or cfg["data"]["test_dir"]
    dataset = ChessDataset(
        test_dir, max_samples=args.max_samples, manifest=args.manifest,
        input_size=input_size,
    )
    loader = BatchLoader(
        dataset, np.arange(len(dataset)), args.batch_size,
        num_workers=cfg["data"].get("num_workers", 6),
    )
    print(f"Test set: {len(dataset)} images from {test_dir}")

    data_cfg = get_data_config(cfg["model"]["name"])
    metrics = evaluate(model, dataset, loader, data_cfg["mean"], data_cfg["std"])

    ckpt_dir = os.path.dirname(os.path.abspath(args.checkpoint))
    eval_log = os.path.join(ckpt_dir, "eval_results.jsonl")
    entry = {
        "timestamp": datetime.now().isoformat(),
        "checkpoint": args.checkpoint,
        "test_dir": test_dir,
        "num_samples": len(dataset),
        "metrics": metrics,
    }
    with open(eval_log, "a") as f:
        f.write(json.dumps(entry) + "\n")
    print(f"\nResults appended to {eval_log}")


if __name__ == "__main__":
    main()
