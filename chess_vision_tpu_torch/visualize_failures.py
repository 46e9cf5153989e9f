"""Render a grid of the worst-predicted boards (the root
``visualize_failures.py``): scan a test dir, find boards with at least one
wrong square, save an annotated matplotlib grid of the worst N.

    python -m chess_vision_tpu_torch.visualize_failures --checkpoint C
        --test-dir D [--max-samples N] [--num-failures 30] [--batch-size 64]
        [--out failures.png] [--device cpu]

The model runs on the CUDA device unless ``--device`` says otherwise.
matplotlib is imported once there are failures to draw; without it the
command raises ``ImportError``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    import numpy as np

    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
    from chess_vision_tpu_torch.evaluate import load_model, make_eval_batch_fn
    from chess_vision_tpu_torch.fen import labels_to_fen
    from chess_vision_tpu_torch.train.loop import BatchStager

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--test-dir", required=True)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--num-failures", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--out", default="failures.png")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)

    model, cfg = load_model(args.checkpoint, args.device)
    input_size = cfg["model"].get("input_size") or 224
    dataset = ChessDataset(args.test_dir, max_samples=args.max_samples,
                           input_size=input_size)
    loader = BatchLoader(dataset, np.arange(len(dataset)), args.batch_size)
    data_cfg = get_data_config(cfg["model"]["name"])
    eval_batch = make_eval_batch_fn(model, data_cfg["mean"], data_cfg["std"])
    stager = BatchStager(next(model.parameters()).device)

    failures = []  # (num_wrong, idx, true_fen, pred_fen)
    for batch in loader:
        results = eval_batch(stager(batch))["results"].cpu().numpy()
        for i in range(batch["n_real"]):
            num_wrong = int(results[i, -1])
            if num_wrong > 0:
                failures.append((
                    num_wrong, int(batch["indices"][i]),
                    labels_to_fen(batch["squares"][i]),
                    labels_to_fen(results[i, :64]),
                ))

    print(f"{len(failures)} failures among {len(dataset)} images")
    if not failures:
        return
    failures.sort(key=lambda f: -f[0])
    worst = failures[: args.num_failures]

    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "visualize_failures draws its grid with matplotlib, which this "
            "Python does not have") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    cols = 5
    rows = -(-len(worst) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4.6 * rows))
    axes = np.atleast_2d(axes)
    for ax in axes.flat:
        ax.axis("off")
    for ax, (num_wrong, idx, true_fen, pred_fen) in zip(axes.flat, worst):
        path = os.path.join(dataset.root_dir, dataset.samples[idx]["filename"])
        ax.imshow(Image.open(path))
        ax.set_title(
            f"#{idx}: {num_wrong}/64 wrong\nT: {true_fen}\nP: {pred_fen}",
            fontsize=7,
        )
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
