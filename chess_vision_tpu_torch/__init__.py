"""chess_vision_tpu_torch: the PyTorch/CUDA port of chess_vision_tpu.

Serves, evaluates and trains the three archs of the JAX package (the
flagship ChessViT, board image -> FEN; ChessCNN; ChessSquareCNN) in bf16,
f32 or int8 serving on an NVIDIA Hopper GPU, or over several
(``parallel/``: data-parallel, FSDP and tensor-parallel training, serving
and evaluation over a device list), with every Pallas kernel of the JAX
package as a hand-written CUDA kernel (``csrc/``). The package stands alone: it imports nothing of
``chess_vision_tpu`` or JAX and keeps its own copies of the numpy-only FEN
codec (``fen.py``), the JPEG decoder (``native/``) and the host input
pipeline (``data.py``); tests hold the copies equal to the JAX package's.
"""

from chess_vision_tpu_torch.fen import (  # noqa: F401
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
