"""Read a served FEN back into the answers it states: 64 square classes
(index 0 = a8, 63 = h1; 0 empty, 1-6 white P N B R Q K, 7-12 black), the
turn (True: black to move) and the castling rights K, Q, k, q."""

from __future__ import annotations

import numpy as np

PIECES = ".PNBRQKpnbrqk"
CASTLING = "KQkq"


def parse(fen: str) -> tuple[np.ndarray, bool, np.ndarray]:
    """Raises ValueError on a FEN that does not state 64 squares, a turn and
    a castling field."""
    fields = fen.split()
    if len(fields) != 3 or fields[1] not in ("w", "b"):
        raise ValueError(f"malformed FEN {fen!r}")
    squares: list[int] = []
    ranks = fields[0].split("/")
    if len(ranks) != 8:
        raise ValueError(f"malformed FEN {fen!r}")
    for rank in ranks:
        for ch in rank:
            if ch.isdigit():
                squares.extend([0] * int(ch))
            elif ch in PIECES[1:]:
                squares.append(PIECES.index(ch))
            else:
                raise ValueError(f"malformed FEN {fen!r}")
    if len(squares) != 64:
        raise ValueError(f"malformed FEN {fen!r}")
    castling = fields[2]
    if castling != "-" and not set(castling) <= set(CASTLING):
        raise ValueError(f"malformed FEN {fen!r}")
    flags = np.array([ch in castling for ch in CASTLING])
    return np.array(squares), fields[1] == "b", flags
