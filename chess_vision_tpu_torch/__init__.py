"""chess_vision_tpu_torch: the PyTorch/CUDA port of chess_vision_tpu.

Serves the flagship ChessViT (board image -> FEN) on an NVIDIA Hopper GPU,
with preprocessing and attention in hand-written CUDA kernels. The FEN codec
is numpy-only and shared with the JAX package, not copied; importing this
package does not import JAX.
"""

from chess_vision_tpu.fen import (  # noqa: F401
    CLASS_TO_COLOR,
    CLASS_TO_TYPE,
    INDEX_TO_PIECE,
    NUM_CLASSES,
    NUM_PIECE_COLORS,
    NUM_PIECE_TYPES,
    NUM_SQUARES,
    PIECE_TO_INDEX,
    assemble_fen,
    assemble_fens_batch,
    fen_to_labels,
    filename_to_fen,
    flip_fen,
    labels_to_fen,
    parse_full_fen,
)

__version__ = "0.1.0"
