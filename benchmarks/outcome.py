"""What a cell's driver hands back to ``run.py``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict                 # end-to-end metric name -> value
    numbers: dict                 # correctness number name -> value
    memory_peak_bytes: int
    items: int                    # boards or images completed in the window
    window_s: float
    trace: object = None          # trace.Summary of the traced part
    traced_items: int = 0         # boards or images the traced part completed
    notes: dict = dataclasses.field(default_factory=dict)
