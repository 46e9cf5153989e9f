"""Predict the FEN of a single board image; prints
"<placement> <turn> <castling>" as the root ``predict.py`` does.

    python -m chess_vision_tpu_torch.predict --checkpoint C --image I [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from PIL import Image

    from chess_vision_tpu_torch.serve import Predictor

    parser = argparse.ArgumentParser(description="Predict FEN from a board image")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)

    predictor = Predictor(args.checkpoint, batch_size=1, inflight=1,
                          device=args.device)
    size = predictor.input_size
    img = Image.open(args.image).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    print(predictor.predict_array(np.asarray(img, np.uint8)[None])[0])


if __name__ == "__main__":
    main()
