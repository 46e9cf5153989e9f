"""The numbers that decide ``correct``, each held against its limit.

Serving. For every board of the sample the reference's logits (f32) are
read at the answers the served FEN states. A square's gap is the reference's
best logit less its logit of the served class; the turn's and a castling
flag's gap is |logit| where the served answer has the other sign, else 0.
Gaps are in units of the board's scale, its RMS square logit over 256
(about one bf16 ulp at that magnitude), so one limit holds at any logit
scale. ``gap_units`` is the widest gap of the sample, ``mean_gap_units``
the mean over all its answers: a lower precision flips more answers and
each by more, so the mean separates the precisions where the widest gap,
an extreme of a few near ties, swings from seed to seed.
``gap_per_tie_units`` is the sum of all the gaps over the number of close
calls (answers whose reference margin is under ``TIE_UNITS``): how many
near ties a seed's weights make sets how many answers can flip, and this
divides that out. ``gap_vs_bf16`` is the mean gap over that of a plain
bf16 forward of the reference on the same boards: the seed's sensitivity to
rounding, divided out.

Training. ``loss_rel``: the largest relative gap of the first steps'
losses. ``grad_rel``: the worst leaf's gap between the norms of the first
gradient as the optimizer got it (after clipping) on the two sides, over the
larger of the reference's norm of that leaf and of the median leaf.
``update_rel``: the same of the parameters' change over the first steps,
leaving out elements whose first reference gradient is under a thousandth
of the median leaf's RMS (moved by round-off alone).
"""

from __future__ import annotations

import numpy as np

from benchmarks import fen as fen_reader

# A close call: an answer whose reference margin (its best logit over the
# runner-up, or a flag's |logit|) is under this many units.
TIE_UNITS = 64.0


def answers(fens: list) -> tuple:
    """(classes (n, 64), turn (n,), castling (n, 4)) the FENs state."""
    parsed = [fen_reader.parse(f) for f in fens]
    return (np.stack([p[0] for p in parsed]), np.array([p[1] for p in parsed]),
            np.stack([p[2] for p in parsed]))


def argmax_answers(logits: dict) -> tuple:
    """The answers that ``logits`` put first."""
    n = len(logits["squares"])
    return (np.asarray(logits["squares"]).reshape(n, 64, 13).argmax(axis=-1),
            np.asarray(logits["turn"]).reshape(n) > 0,
            np.asarray(logits["castling"]).reshape(n, 4) > 0)


def answer_gap(logits: dict, given: tuple) -> dict:
    """``gap_units`` (the widest gap), ``mean_gap_units`` (the mean over
    every answer, 69 a board), ``gap_per_tie_units`` (their sum over the
    close calls), ``ties`` (the close calls) and ``flips`` (answers that
    differ from the reference's argmax) of the answers ``given`` against the
    reference's ``logits`` (numpy "squares" (n, 832), "turn" (n, 1),
    "castling" (n, 4))."""
    cls, turn, castling = given
    n = len(cls)
    sq = np.asarray(logits["squares"], np.float64).reshape(n, 64, 13)
    unit = np.sqrt((sq.reshape(n, -1) ** 2).mean(axis=1)) / 256
    got = np.take_along_axis(sq, cls[..., None], axis=-1)[..., 0]
    gaps = [(sq.max(axis=-1) - got) / unit[:, None]]
    for served, ref in ((turn[:, None], logits["turn"]),
                        (castling, logits["castling"])):
        ref = np.asarray(ref, np.float64).reshape(served.shape)
        wrong = served != (ref > 0)
        gaps.append(np.where(wrong, np.abs(ref), 0.0) / unit[:, None])
    flips = int((cls != sq.argmax(axis=-1)).sum()
                + sum(int((g > 0).sum()) for g in gaps[1:]))
    every = np.concatenate([g.reshape(-1) for g in gaps])
    top2 = np.sort(sq, axis=-1)[..., -2:]
    margins = np.concatenate([
        ((top2[..., 1] - top2[..., 0]) / unit[:, None]).reshape(-1),
        (np.abs(np.asarray(logits["turn"], np.float64).reshape(n, 1))
         / unit[:, None]).reshape(-1),
        (np.abs(np.asarray(logits["castling"], np.float64).reshape(n, 4))
         / unit[:, None]).reshape(-1)])
    ties = max(int((margins < TIE_UNITS).sum()), 1)
    return {"gap_units": float(every.max()),
            "mean_gap_units": float(every.mean()),
            "gap_per_tie_units": float(every.sum() / ties),
            "ties": ties, "flips": flips}


def ratio(a: float, b: float) -> float:
    """a / b; 0 over 0 is 0, anything else over 0 is infinite."""
    if b > 0:
        return a / b
    return 0.0 if a == 0 else float("inf")


def _rel_gaps(prog: dict, ref: dict) -> tuple[float, float, str]:
    """(worst, median, worst leaf's name) of the leaves' gaps, each over the
    larger of the reference's norm of that leaf and of the median leaf."""
    median = float(np.median(list(ref.values())))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in ref}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], float(np.median(list(gaps.values()))), worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "delta": {leaf: change tensor}} with leaves named alike; ``ref`` also
    "first": {leaf: first gradient tensor}. The change leaves out the
    elements whose first reference gradient is under a thousandth of the
    median leaf's RMS gradient: a key's bias, under softmax, shares the
    fused qkv bias with the query's and the value's and moves by round-off
    alone."""
    import torch

    losses = [abs(p - r) / abs(r)
              for p, r in zip(prog["losses"], ref["losses"])]
    rms = [float(g.norm()) / g.numel() ** 0.5 for g in ref["first"].values()]
    floor = 1e-3 * float(np.median(rms))
    moved_p, moved_r = {}, {}
    for k, d in ref["delta"].items():
        keep = ref["first"][k].abs() >= floor
        moved_r[k] = float(d[keep].norm())
        mine = torch.as_tensor(prog["delta"][k]).to(d.device)
        moved_p[k] = float(mine[keep].norm())
    grad, grad_median, grad_leaf = _rel_gaps(prog["grad"], ref["grad"])
    update, update_median, update_leaf = _rel_gaps(moved_p, moved_r)
    return {"loss1_rel": float(losses[0]), "loss_rel": float(max(losses)),
            "grad_rel": grad, "grad_median_rel": grad_median,
            "update_rel": update, "update_median_rel": update_median,
            "worst_grad_leaf": grad_leaf, "worst_update_leaf": update_leaf}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, {name: {"value",
    "limit"}}). A limit whose number is missing or not finite is not met;
    numbers without a limit are not compared."""
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in sorted(limits.items())}
    ok = all(isinstance(c["value"], (int, float)) and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok) and bool(checks), checks
