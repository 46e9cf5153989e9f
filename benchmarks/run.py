"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmarks.run --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell's traffic mix says which driver runs
it (``kind``: "serve" or "train"). The last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace
1``), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared with its limit, which also close standard error.

An exception or SIGTERM still prints the line, with ``correct`` false, and
exits with 1. Without a CUDA device, with fewer than the cell asks for,
without the program, or with JAX loaded once the window has closed, the
run prints no result and exits with 2, 3 or 4.
"""

from __future__ import annotations

import time

SETUP_T0 = time.perf_counter()  # noqa: E402  (before torch is imported)

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from benchmarks import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chess_vision_tpu")
PROGRAM = ("chess_vision_tpu_torch", "torch")
NO_DEVICE, NO_PROGRAM, JAX_LOADED = 2, 3, 4


class Terminated(BaseException):
    """SIGTERM, raised in the main thread."""


def _on_sigterm(signum, frame):
    raise Terminated(f"signal {signum}")


def forbidden_modules() -> list:
    """Modules whose top-level name (before the first dot) is JAX's, flax's
    or the JAX package's, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def device_info(count: int, memory: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory)}


def per_layer(cell, outcome) -> dict:
    """The cell's per-layer metrics that their readers find something to
    read for; a reader that returns None leaves its metric out."""
    ctx = {"cell": cell, "items": outcome.items, "window_s": outcome.window_s,
           "trace": outcome.trace, "traced_items": outcome.traced_items}
    out = {}
    for m in cell.per_layer:
        reader = spec.metric_reader(m["name"])
        value = reader.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def emit(line: str, checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             setup_t0: float):
    """(outcome, correct, checks) of one run of ``cell`` on ``device``."""
    import importlib

    from benchmarks import judge

    driver = importlib.import_module(f"benchmarks.{cell.traffic['kind']}")
    outcome = driver.run(cell, seed, seconds, traced, device, setup_t0)
    numbers = dict(outcome.numbers, failed=outcome.failed)
    correct, checks = judge.verdict(numbers, dict(cell.limits, failed=0))
    return outcome, correct, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    signal.signal(signal.SIGTERM, _on_sigterm)

    cell = spec.load(args.workload)
    try:
        import torch
    except ModuleNotFoundError as exc:
        print(f"no PyTorch: {exc}", file=sys.stderr)
        return NO_PROGRAM
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return NO_DEVICE
    device = torch.device("cuda", 0)
    try:
        outcome, correct, checks = run_cell(cell, args.seed, args.seconds,
                                            bool(args.trace), device, SETUP_T0)
    except ModuleNotFoundError as exc:
        if (exc.name or "").split(".")[0] not in PROGRAM:
            raise
        print(f"the program is missing: {exc}", file=sys.stderr)
        return NO_PROGRAM
    except BaseException as exc:  # the line is owed on every failure
        traceback.print_exc()
        checks = {"error": {"value": f"{type(exc).__name__}: {exc}"[:300],
                            "limit": None}}
        try:
            device = device_info(cell.chips, 0)
        except Exception:  # a device that has failed may not even answer this
            device = {"platform": "gpu", "kind": "unknown", "count": cell.chips,
                      "memory_peak_bytes": 0}
        emit(result_line(False, 0, 0, {}, device, checks), checks)
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX was loaded in the measured process: {loaded}",
              file=sys.stderr)
        return JAX_LOADED
    device = device_info(cell.chips, outcome.memory_peak_bytes)
    breakdown = None
    if args.trace:
        metrics = per_layer(cell, outcome)
        if outcome.trace is not None:
            device["busy_s"] = outcome.trace.busy_s
            device["window_s"] = outcome.trace.window_s
            breakdown = {"device_ops": outcome.trace.device_ops(),
                         "idle_gaps": outcome.trace.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": float(outcome.metrics[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    print(f"numbers: {json.dumps(outcome.numbers)}", file=sys.stderr)
    print(f"notes: {json.dumps(outcome.notes)}", file=sys.stderr)
    emit(result_line(correct, outcome.attempted, outcome.failed, metrics,
                     device, checks, breakdown), checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
