"""Serving cells: one caller in a closed loop on ``Predictor.predict_array``.

Set-up, in order: load (or build) the kernel library; make the weights from
the seed; build the ``Predictor`` (int8: it quantizes); make the pool of
boards on the host; warm up with requests of the cell's own size. The
window then sends one request after another, each ``request_boards`` boards
of the pool, timed from the call until its FEN strings return, until
``seconds`` have passed; the request that crosses the end is counted whole,
and the window ends with it. A ``--trace 1`` run then sends
``trace_requests`` more under the profiler (its per-layer metrics read the
window, the trace or both). Afterwards a sample of the finished requests,
drawn from the seed, is held against the configuration's reference
(``judge_sample``).

Traffic keys: ``request_boards``, ``pool_boards``, ``batch_size``,
``inflight``, ``mode``, ``quant`` (null or "int8"), ``env`` (the program's
mode variables, set before it is built), ``warmup_requests``,
``sample_requests``, ``trace_requests`` and ``reference`` (keyword
arguments of the reference's ``forward``).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from benchmarks import inputs, judge, trace, weights
from benchmarks.fen import parse
from benchmarks.outcome import Outcome
from benchmarks.reference import common

REFERENCE_BLOCK = 128  # boards a reference call


def _counters() -> dict:
    from chess_vision_tpu_torch.ops import attention, preprocess

    return {"K1": preprocess.LAUNCHES, "K2": attention.LAUNCHES,
            "K4": attention.QUANT_LAUNCHES}


def build(cell, seed: int, device, clock: dict | None = None):
    """(predictor, host pool of boards) for ``cell``; ``clock`` gets the
    seconds each set-up step took."""
    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.serve import Predictor

    clock = {} if clock is None else clock
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        clock[name] = round(now - t, 3)
        t = now

    tr = cell.traffic
    for key, value in tr.get("env", {}).items():
        os.environ[key] = str(value)
    if device.type == "cuda":
        _build.library()
    lap("library")
    spec = cell.reference().param_spec(cell.model)
    flat = weights.make_flat(spec, seed, device)
    params = weights.tree(spec, flat.cpu().numpy())
    del flat
    lap("weights")
    cfg = {"model": cell.model, "training": {"mixed_precision": True}}
    predictor = Predictor((cfg, params), batch_size=tr["batch_size"],
                          inflight=tr["inflight"], mode=tr["mode"],
                          quant=tr.get("quant"), device=device)
    lap("predictor")
    pool = inputs.boards(tr["pool_boards"], cell.model["input_size"],
                            seed, device)
    lap("pool")
    return predictor, pool


def request_order(cell, seed: int, count: int) -> np.ndarray:
    """Pool slots of the first ``count`` requests: every slot once in a
    seeded order, then again in another."""
    slots = cell.traffic["pool_boards"] // cell.traffic["request_boards"]
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(slots)
                           for _ in range(-(-count // slots))])[:count]


def reference_logits(cell, seed: int, boards: np.ndarray, device,
                     bf16: bool = False) -> dict:
    """The reference's logits of uint8 ``boards``, computed in blocks; with
    ``bf16`` under autocast (products in bf16, the norms and softmax in
    f32): a plain bf16 forward."""
    import torch

    spec = cell.reference().param_spec(cell.model)
    params = weights.tree(spec, weights.make_flat(spec, seed, device))
    mean = torch.tensor(cell.config["data"]["mean"], device=device)
    std = torch.tensor(cell.config["data"]["std"], device=device)
    out: dict = {"squares": [], "turn": [], "castling": []}
    half = torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)
    with torch.no_grad(), common.full_f32(), half:
        for start in range(0, len(boards), REFERENCE_BLOCK):
            x = torch.from_numpy(
                boards[start:start + REFERENCE_BLOCK]).to(device)
            x = (x.float() / 255.0 - mean) / std
            logits = cell.reference().forward(
                params, x, cell.model, **cell.traffic.get("reference", {}))
            for key in out:
                out[key].append(logits[key].float().cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def judge_sample(cell, seed: int, boards: np.ndarray, device,
                 given: tuple) -> dict:
    """``judge.answer_gap`` of the answers ``given`` for ``boards``, and
    ``gap_vs_bf16``: their mean gap over that of a plain bf16 forward's
    answers on the same boards, which takes out how sensitive a seed's
    weights make the answers to rounding."""
    ref = reference_logits(cell, seed, boards, device)
    numbers = judge.answer_gap(ref, given)
    plain = judge.answer_gap(ref, judge.argmax_answers(
        reference_logits(cell, seed, boards, device, bf16=True)))
    numbers["gap_vs_bf16"] = judge.ratio(numbers["mean_gap_units"],
                                         plain["mean_gap_units"])
    return numbers


def _valid(fens, n: int) -> bool:
    """Whether a request returned ``n`` FENs that each state a board."""
    if len(fens) != n:
        return False
    try:
        for f in fens:
            parse(f)
    except ValueError:
        return False
    return True


def run(cell, seed: int, seconds: float, traced: bool, device,
        setup_t0: float) -> Outcome:
    import torch

    tr = cell.traffic
    req = tr["request_boards"]
    clock = {"imports": round(time.perf_counter() - setup_t0, 3)}
    predictor, pool = build(cell, seed, device, clock)
    slots = [slice(s * req, (s + 1) * req) for s in range(len(pool) // req)]
    t_warm = time.perf_counter()
    for slot in request_order(cell, seed + 1, tr["warmup_requests"]):
        predictor.predict_array(pool[slots[slot]])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock["warmup"] = round(time.perf_counter() - t_warm, 3)
    setup_s = time.perf_counter() - setup_t0

    order = request_order(cell, seed, 1 << 16)
    latencies, served = [], []

    def request():
        start = time.perf_counter()
        with trace.span("request"):
            fens = predictor.predict_array(pool[slots[order[len(served)]]])
        latencies.append(time.perf_counter() - start)
        served.append(fens)

    before = _counters()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        request()
    window_s, n_window = time.perf_counter() - t0, len(served)
    profile = None
    if traced:
        with trace.Profile() as profile:
            for _ in range(tr["trace_requests"]):
                request()
    counts = {k: v - before[k] for k, v in _counters().items()}
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    del predictor
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(not _valid(f, req) for f in served)
    sample = np.random.default_rng([seed, 1]).choice(
        len(served), size=min(tr["sample_requests"], len(served)),
        replace=False)
    boards = np.concatenate([pool[slots[order[i]]] for i in sample])
    fens = [f for i in sample for f in served[i]]
    t_ref = time.perf_counter()
    numbers = judge_sample(cell, seed, boards, device, judge.answers(fens))
    per_request = {k: v / len(served) for k, v in counts.items()}
    print(f"reference: {len(boards)} boards in "
          f"{time.perf_counter() - t_ref:.2f} s; {numbers['flips']} answers "
          f"off the reference's argmax; launches a request {per_request}",
          file=sys.stderr)
    return Outcome(
        attempted=len(served), failed=failed,
        metrics={"boards_per_s": n_window * req / window_s,
                 "request_p95_ms":
                     float(np.percentile(latencies[:n_window], 95)) * 1e3,
                 "setup_s": setup_s},
        numbers=numbers, memory_peak_bytes=int(memory),
        items=n_window * req, window_s=window_s,
        trace=profile.summary() if profile is not None else None,
        traced_items=(len(served) - n_window) * req,
        notes={"launches": counts, "requests": len(served), "setup": clock})
