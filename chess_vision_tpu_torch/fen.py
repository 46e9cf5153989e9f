"""FEN <-> label codec and label-space constants.

Pure numpy/python — no device code. This is the shared label vocabulary for the
whole framework: 13 joint piece classes (empty + 6 white + 6 black), decomposed
into 7 piece types x 3 colors for the models' additive-logit heads.

Behavioral parity with the reference implementation:
  - fen_to_labels / labels_to_fen: reference dataset.py:35-70
  - filename_to_fen (Kaggle filename mode): reference dataset.py:73-76
  - parse_full_fen: reference dataset.py:79-116
  - assemble_fen (argmax -> FEN string assembly): reference predict.py:26-42
Index 0 = a8 (top-left), 7 = h8, 8 = a7, ..., 63 = h1.
"""

from __future__ import annotations

import os

import numpy as np

PIECE_TO_INDEX = {
    ".": 0,
    "P": 1, "N": 2, "B": 3, "R": 4, "Q": 5, "K": 6,
    "p": 7, "n": 8, "b": 9, "r": 10, "q": 11, "k": 12,
}
INDEX_TO_PIECE = {v: k for k, v in PIECE_TO_INDEX.items()}
PIECE_CHARS = "".join(INDEX_TO_PIECE[i] for i in range(13))  # ".PNBRQKpnbrqk"

NUM_CLASSES = 13
NUM_SQUARES = 64

# Type/color decomposition: type in {empty,P,N,B,R,Q,K}, color in {empty,white,black}.
NUM_PIECE_TYPES = 7
NUM_PIECE_COLORS = 3

#                         .  P  N  B  R  Q  K  p  n  b  r  q  k
CLASS_TO_TYPE = np.array([0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6], dtype=np.int32)
CLASS_TO_COLOR = np.array([0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2], dtype=np.int32)

CASTLING_CHARS = ("K", "Q", "k", "q")


def fen_to_labels(fen: str) -> np.ndarray:
    """Convert a FEN board-placement string to a (64,) int32 array of class ids.

    FEN ranks run from rank 8 (top) to rank 1 (bottom), files a..h left to
    right, so index 0 = a8 and index 63 = h1.
    """
    squares: list[int] = []
    for rank in fen.split("/"):
        for ch in rank:
            if ch.isdigit():
                squares.extend([0] * int(ch))
            elif ch in PIECE_TO_INDEX:
                squares.append(PIECE_TO_INDEX[ch])
            else:
                raise ValueError(f"Invalid piece character {ch!r} in FEN: {fen}")
    if len(squares) != NUM_SQUARES:
        raise ValueError(f"Expected 64 squares, got {len(squares)} from FEN: {fen}")
    return np.asarray(squares, dtype=np.int32)


def labels_to_fen(labels) -> str:
    """Convert a (64,) array of class ids back to a FEN placement string.

    Runs of empty squares are re-encoded as digit counts per rank.
    """
    labels = np.asarray(labels).reshape(-1)
    if labels.shape[0] != NUM_SQUARES:
        raise ValueError(f"Expected 64 labels, got {labels.shape[0]}")
    ranks = []
    for rank_start in range(0, 64, 8):
        rank_str = ""
        empty = 0
        for sq in range(rank_start, rank_start + 8):
            piece = INDEX_TO_PIECE[int(labels[sq])]
            if piece == ".":
                empty += 1
            else:
                if empty:
                    rank_str += str(empty)
                    empty = 0
                rank_str += piece
        if empty:
            rank_str += str(empty)
        ranks.append(rank_str)
    return "/".join(ranks)


def filename_to_fen(filename: str) -> str:
    """'1B1B1K2-3p1N2-...-1B6.jpeg' -> placement FEN (Kaggle filename scheme)."""
    name = os.path.splitext(os.path.basename(filename))[0]
    return name.replace("-", "/")


def parse_full_fen(fen_str: str) -> dict:
    """Parse a 2-6 field FEN into {squares, turn, castling} numpy arrays.

    Returns:
        squares: (64,) int32 class ids
        turn: (1,) float32 — 0.0 = white to move, 1.0 = black
        castling: (4,) float32 — [K, Q, k, q] availability flags
    """
    parts = fen_str.strip().split()
    placement = parts[0]

    turn_char = parts[1] if len(parts) > 1 else "w"
    turn_val = 1.0 if turn_char == "b" else 0.0

    castling_str = parts[2] if len(parts) > 2 else "-"
    castling = np.zeros(4, dtype=np.float32)
    if castling_str != "-":
        for i, ch in enumerate(CASTLING_CHARS):
            if ch in castling_str:
                castling[i] = 1.0

    return {
        "squares": fen_to_labels(placement),
        "turn": np.asarray([turn_val], dtype=np.float32),
        "castling": castling,
    }


def assemble_fen(square_ids, turn_logit: float, castling_logits) -> str:
    """Assemble the final FEN string from model outputs (reference predict.py:26-42).

    Args:
        square_ids: (64,) argmaxed class ids
        turn_logit: scalar logit; > 0 means black to move
        castling_logits: (4,) logits; > 0 means the right is available

    Returns:
        "<placement> <turn> <castling>" exactly as the reference prints it.
    """
    placement = labels_to_fen(square_ids)
    turn = "b" if float(turn_logit) > 0 else "w"
    castling_logits = np.asarray(castling_logits).reshape(-1)
    chars = "".join(
        ch for flag, ch in zip(castling_logits > 0, CASTLING_CHARS) if flag
    )
    return f"{placement} {turn} {chars or '-'}"


def assemble_fens_batch(square_ids, turn_logits, castling_logits) -> list[str]:
    """Vectorized host-side FEN assembly for the batched serving path.

    Args:
        square_ids: (B, 64) int array
        turn_logits: (B,) or (B, 1)
        castling_logits: (B, 4)
    """
    square_ids = np.asarray(square_ids)
    turn_logits = np.asarray(turn_logits).reshape(-1)
    castling_logits = np.asarray(castling_logits).reshape(-1, 4)
    return [
        assemble_fen(square_ids[i], turn_logits[i], castling_logits[i])
        for i in range(square_ids.shape[0])
    ]


def flip_fen(placement: str) -> str:
    """Rotate a placement FEN 180 degrees (rank and file reversal).

    Matches the reference datagen's flipped-board label correction
    (datagen/render-worker.js:14-24): when a board is rendered from black's
    perspective, the label FEN is flipped so labels always match the image.
    """
    ranks = placement.split("/")
    flipped = []
    for rank in reversed(ranks):
        expanded = ""
        for ch in rank:
            expanded += "." * int(ch) if ch.isdigit() else ch
        flipped.append(_compress_rank(expanded[::-1]))
    return "/".join(flipped)


def _compress_rank(expanded: str) -> str:
    out = ""
    empty = 0
    for ch in expanded:
        if ch == ".":
            empty += 1
        else:
            if empty:
                out += str(empty)
                empty = 0
            out += ch
    if empty:
        out += str(empty)
    return out
