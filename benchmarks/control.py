"""The readings a cell's limits are set from, many seeds in one process.

    python3 -m benchmarks.control --workload <name> --seeds 1,2,3 \
        [--seconds 3] [--program] [--control] [--fault half_batch ...]

``--program``: the cell's own numbers, a short run of the timed path a seed
(the lower readings). ``--control``: the same numbers of the control, the
step below the configuration's precision that a later change might take
(the upper readings): the cell's limits file names it under ``control``,
either the program with other traffic (``{"kind": "program", "traffic":
{...}}``: a path of its own in a lower precision) or the reference at fewer
bits (``{"kind": "reference", "reference": {...}}``), read against the
reference at the same boards, or the same rows and draws. ``--fault``: the
program with a fault of ``faults.PLANTED`` planted. Each reading is one JSON
line; the last line gives each number's largest program reading and smallest
control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmarks import faults, inputs, judge, run, serve, spec, train


def _serve_boards(cell, seed: int, device):
    """The boards of the first ``sample_requests`` requests of ``seed``."""
    tr = cell.traffic
    req = tr["request_boards"]
    pool = inputs.boards(tr["pool_boards"], cell.model["input_size"], seed,
                            device)
    order = serve.request_order(cell, seed, tr["sample_requests"])
    return np.concatenate([pool[s * req:(s + 1) * req] for s in order])


def serve_control(cell, seed: int, control: dict, device) -> dict:
    boards = _serve_boards(cell, seed, device)
    if control["kind"] == "program":
        low_cell = cell.with_overrides(traffic=control["traffic"])
        predictor, _ = serve.build(low_cell, seed, device)
        given = judge.answers(predictor.predict_array(boards))
        del predictor
    else:
        low_cell = cell.with_overrides(
            traffic={"reference": control["reference"]})
        given = judge.argmax_answers(
            serve.reference_logits(low_cell, seed, boards, device))
    return serve.judge_sample(cell, seed, boards, device, given)


def train_control(cell, seed: int, control: dict, device) -> dict:
    import torch

    from benchmarks.reference import augment

    tr = cell.traffic
    pixels, labels = inputs.corpus(tr["corpus_boards"],
                                   cell.model["input_size"], seed + 1, device)
    cw = (inputs.class_weights(labels[:, :64])
          if tr["training"].get("use_class_weights") else None)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    aug = [augment.draw(tr["batch_size"], gen)
           for _ in range(tr["warmup_steps"])]
    ref = train.reference(cell, seed, pixels, labels, cw, aug, device)
    low = train.reference(cell, seed, pixels, labels, cw, aug, device,
                          **control["reference"])
    return judge.train_numbers(low, ref)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", action="append", default=[],
                        choices=sorted(faults.PLANTED))
    args = parser.parse_args(argv)
    cell = spec.load(args.workload)
    device = torch.device("cuda", 0)
    readings: dict = {}

    def record(what: str, seed: int, numbers: dict) -> None:
        print(json.dumps({"what": what, "seed": seed, **numbers}), flush=True)
        readings.setdefault(what, []).append(numbers)

    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            out, _, _ = run.run_cell(cell, seed, args.seconds, False, device,
                                     time.perf_counter())
            record("program", seed, out.numbers)
        if args.control:
            kind = cell.traffic["kind"]
            fn = serve_control if kind == "serve" else train_control
            record("control", seed, fn(cell, seed, cell.control, device))
        for fault in args.fault:
            with faults.PLANTED[fault]():
                out, _, _ = run.run_cell(cell, seed, args.seconds, False,
                                         device, time.perf_counter())
            record(fault, seed, out.numbers)
        torch.cuda.empty_cache()
    summary = {}
    for what, rows in readings.items():
        pick = max if what == "program" else min
        summary[what] = {k: pick(r[k] for r in rows) for k in rows[0]
                         if isinstance(rows[0][k], (int, float))}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
