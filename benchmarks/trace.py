"""The traced part of a run: ``torch.profiler`` with CUDA activity, reduced
to what the per-layer metrics and the breakdown read.

The profiler's timeline is exported as a Chrome trace into the run's
temporary directory and read back: ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events are the device's work; ``user_annotation`` events
named ``bench.*`` are the ranges the harness puts around its own calls on
the host (``span``), which label the device's idle gaps. The traced window
is the ``bench.window`` range.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def span(name: str):
    """A host range the trace labels idle gaps with (``bench.<name>``)."""
    import torch

    return torch.profiler.record_function(f"bench.{name}")


class Profile:
    """Context manager around the traced window; ``summary()`` after it."""

    def __init__(self):
        self._prof = None
        self._window = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> "Summary":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)
        return Summary.from_events(events.get("traceEvents", events))


def _union(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _top(by: dict, top: int) -> list:
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


class Summary:
    """Device events inside the traced window, in microseconds."""

    def __init__(self, device: list, ranges: list, window: tuple):
        self.device = device          # (name, start, end)
        self.ranges = ranges          # (name, start, end) of bench.* ranges
        self.start, self.end = window

    @classmethod
    def from_events(cls, events: list) -> "Summary":
        device, ranges, window = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            start = float(e["ts"])
            end = start + float(e.get("dur", 0.0))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((e["name"], start, end))
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                if e["name"] == WINDOW:
                    window = (start, end)
                else:
                    ranges.append((e["name"][len("bench."):], start, end))
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        lo, hi = window
        device = [(n, max(s, lo), min(t, hi)) for n, s, t in device
                  if t > lo and s < hi]
        return cls(device, ranges, window)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        busy = _union((s, e) for _, s, e in self.device)
        return sum(e - s for s, e in busy) * 1e-6

    def seconds(self, pattern: str) -> float:
        """Device seconds of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by: dict = defaultdict(float)
        for n, s, e in self.device:
            by[short_name(n)] += (e - s) * 1e-6
        return _top(by, top)

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds by the innermost harness range open on the
        host when each gap began ("outside" where none was)."""
        busy = _union((s, e) for _, s, e in self.device)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        by: dict = defaultdict(float)
        for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
            if gap_end <= gap_start:
                continue
            label, width = "outside", float("inf")
            for name, s, e in self.ranges:
                if s <= gap_start < e and e - s < width:
                    label, width = name, e - s
            by[label] += (gap_end - gap_start) * 1e-6
        return _top(by, top)
