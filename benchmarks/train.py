"""Training cells: ``train_step`` on batches that ``DeviceBatchLoader``
gathers from a corpus on the card.

Set-up, in order: load (or build) the kernel library; make the weights and
the corpus from the seed; build the model, its AdamW state and the step
(``train/loop.make_steps``) as the trainer does; take the first
``warmup_steps`` steps through the window's own call and feed, keeping what
the correctness check reads: each step's loss, the first gradient as the
optimizer got it (its first moment after one step, over 1 - b1) and the
parameters' change over those steps. The window then takes step after step
until ``seconds`` have passed and waits for the device; a ``--trace 1``
run then takes ``trace_steps`` more under the profiler. Each step's
augmentation parameters are drawn by the harness (``reference.augment``)
and handed to ``train_step``, so the reference reads the same ones.

Afterwards the program's state is freed and the reference trains the same
weights on the same rows (the loader's order: the seeded permutation of the
corpus's rows) for the same steps.

Traffic keys: ``corpus_boards``, ``batch_size``, ``warmup_steps``,
``trace_steps``, ``model`` (laid over the configuration's), ``training`` and
``scheduler`` (the trainer's config sections).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmarks import inputs, judge, spec, trace, weights
from benchmarks.outcome import Outcome
from benchmarks.reference import augment, common
from benchmarks.reference import train as ref_train

B1 = 0.9


def by_leaf(pspec: list, cfg: dict, named: dict) -> dict:
    """Program tensors by ``state_dict`` name -> the same numbers as the
    weights' tree leaves, by path and in the tree's layout. The map is found,
    not written: each element's index in the tree goes through the program's
    own loader (``state_dict_from_jax``), which shows where it put that
    element, so no architecture's names or layouts are known here."""
    import torch

    from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax

    sizes = [int(np.prod(shape)) for _, shape, _, _ in pspec]
    where = state_dict_from_jax(
        weights.tree(pspec, np.arange(sum(sizes), dtype=np.int64)), cfg)
    flat = torch.zeros(sum(sizes))
    seen = torch.zeros(sum(sizes), dtype=torch.bool)
    for name, t in named.items():
        index = where[name].reshape(-1)
        flat[index] = t.reshape(-1).float().cpu()
        seen[index] = True
    if not bool(seen.all()):
        raise ValueError(f"{int((~seen).sum())} elements of the weights' tree "
                         f"are in none of the program's trainable parameters")
    out, offset = {}, 0
    for (path, shape, _, _), n in zip(pspec, sizes):
        out[path] = flat[offset:offset + n].reshape(shape)
        offset += n
    return out


def _gc_log(log: list):
    """A ``gc.callbacks`` entry that appends (generation, seconds) of each
    collection to ``log``."""
    began = [0.0]

    def callback(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            log.append((info["generation"], time.perf_counter() - began[0]))
    return callback


def window_notes(epoch_ends: list, collections: list, cpu_s: float) -> dict:
    """What the window's time went to on the host, for standard error: the
    seconds of each pass over the corpus, the process's CPU seconds, and the
    garbage collector's collections and seconds by generation."""
    ends = [0.0] + epoch_ends
    by_gen: dict = {}
    for gen, sec in collections:
        n, total = by_gen.get(gen, (0, 0.0))
        by_gen[gen] = (n + 1, total + sec)
    return {"epoch_s": [round(b - a, 3) for a, b in zip(ends, ends[1:])],
            "cpu_s": round(cpu_s, 3),
            "gc": {g: [n, round(t, 4)] for g, (n, t) in sorted(by_gen.items())}}


def trainer_config(cell, device, corpus_bytes: int) -> dict:
    """The trainer's config: the cell's model and training sections, remat
    as the trainer resolves "auto" (the card's memory less the corpus)."""
    import torch

    from chess_vision_tpu_torch.models import normalize_remat, resolve_remat

    tr = cell.traffic
    cfg = {"model": spec.merge(cell.model, tr.get("model", {})),
           "training": dict(tr["training"], batch_size=tr["batch_size"]),
           "scheduler": dict(tr["scheduler"])}
    remat = normalize_remat(cfg["model"].get("remat", "auto"))
    if remat == "auto":
        memory = (float(torch.cuda.get_device_properties(device).total_memory)
                  if device.type == "cuda" else None)
        remat = resolve_remat(tr["batch_size"], device,
                              memory - corpus_bytes if memory else None)
    cfg["model"]["remat"] = remat
    return cfg


def run(cell, seed: int, seconds: float, traced: bool, device,
        setup_t0: float) -> Outcome:
    import torch

    from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
    from chess_vision_tpu_torch.data_device import DeviceBatchLoader, DeviceData
    from chess_vision_tpu_torch.models import build_model
    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.train.loop import make_steps
    from chess_vision_tpu_torch.train.state import create_train_state

    tr = cell.traffic
    batch, size = tr["batch_size"], cell.model["input_size"]
    clock = {"imports": round(time.perf_counter() - setup_t0, 3)}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        clock[name] = round(now - t, 3)
        t = now

    if device.type == "cuda":
        _build.library()
    lap("library")
    pspec = cell.reference().param_spec(cell.model)
    flat = weights.make_flat(pspec, seed, device)
    params = weights.tree(pspec, flat.cpu().numpy())
    del flat
    lap("weights")
    pixels, labels = inputs.corpus(tr["corpus_boards"], size, seed + 1, device)
    lap("corpus")
    class_weights = (inputs.class_weights(labels[:, :64])
                     if tr["training"].get("use_class_weights") else None)
    corpus_bytes = pixels.numel() + labels.numel() * labels.element_size()
    cfg = trainer_config(cell, device, corpus_bytes)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    model.to(device)
    steps_per_epoch = tr["corpus_boards"] // batch
    state = create_train_state(cfg, model, steps_per_epoch)
    train_step, _ = make_steps(state, cfg, class_weights,
                               cell.config["data"]["mean"],
                               cell.config["data"]["std"], seed=seed)
    loader = DeviceBatchLoader(DeviceData(pixels, labels, size), batch,
                               shuffle=True, seed=seed, drop_remainder=True)
    aug_gen = torch.Generator(device=device).manual_seed(seed + 2)
    lap("trainer")

    def feed():
        while True:
            with trace.span("loader"):
                batches = iter(loader)
            while True:
                with trace.span("loader"):
                    item = next(batches, None)
                if item is None:
                    break
                with trace.span("aug_draw"):
                    yield item, augment.draw(batch, aug_gen)

    stream = feed()
    warm = tr["warmup_steps"]
    start = {n: p.detach().clone() for n, p in zip(state.names, state.params)}
    losses, kept = [], {}
    for step in range(warm):
        item, aug = next(stream)
        kept.setdefault("aug", []).append(aug)
        losses.append(train_step(item, aug)["step_loss"])
        if step == 0:
            kept["grad"] = {n: (m / (1 - B1)).cpu()
                            for n, m in state.mu.items()}
    kept["delta"] = {n: (p.detach() - start[n]).cpu()
                     for n, p in zip(state.names, state.params)}
    kept["losses"] = [float(v) for v in losses]
    del start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    lap("warmup")
    setup_s = time.perf_counter() - setup_t0

    step_losses = []

    def step():
        item, aug = next(stream)
        with trace.span("train_step"):
            step_losses.append(train_step(item, aug)["step_loss"])

    epoch_ends, collections = [], []
    on_gc = _gc_log(collections)
    gc.callbacks.append(on_gc)
    cpu0, t0 = time.process_time(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step()
        if len(step_losses) % steps_per_epoch == 0:
            epoch_ends.append(time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s, n_window = time.perf_counter() - t0, len(step_losses)
    gc.callbacks.remove(on_gc)
    host = window_notes(epoch_ends, collections, time.process_time() - cpu0)
    profile = None
    if traced:
        with trace.Profile() as profile:
            for _ in range(tr["trace_steps"]):
                step()
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    remat = cfg["model"]["remat"]
    del train_step, state, model, stream, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    kept["delta"] = by_leaf(pspec, cfg, kept["delta"])
    kept["grad"] = {k: float(g.norm())
                    for k, g in by_leaf(pspec, cfg, kept["grad"]).items()}
    ref = reference(cell, seed, pixels, labels, class_weights, kept["aug"],
                    device)
    numbers = judge.train_numbers(kept, ref)
    print(f"reference: {warm} steps in {time.perf_counter() - t_ref:.2f} s; "
          f"losses {kept['losses']} against {ref['losses']}; remat {remat}",
          file=sys.stderr)
    return Outcome(
        attempted=len(step_losses), failed=failed,
        metrics={"train_img_per_s": n_window * batch / window_s,
                 "setup_s": setup_s},
        numbers=numbers, memory_peak_bytes=int(memory),
        items=n_window * batch, window_s=window_s,
        trace=profile.summary() if profile is not None else None,
        traced_items=(len(step_losses) - n_window) * batch,
        notes={"steps": len(step_losses), "remat": str(remat),
               "setup": clock, "window": host})


def first_rows(cell, seed: int, steps: int) -> np.ndarray:
    """Corpus rows of the first ``steps`` batches: the loader's first epoch
    is the permutation ``default_rng(seed)`` draws."""
    tr = cell.traffic
    order = np.random.default_rng(seed).permutation(tr["corpus_boards"])
    return order[:steps * tr["batch_size"]].reshape(steps, tr["batch_size"])


def reference(cell, seed: int, pixels, labels, class_weights, aug: list,
              device, bits=None) -> dict:
    """The reference's numbers over the same weights, rows and draws."""
    import torch

    tr = cell.traffic
    pspec = cell.reference().param_spec(cell.model)
    params = weights.tree(pspec, weights.make_flat(pspec, seed, device))
    rows = torch.from_numpy(first_rows(cell, seed, len(aug))).to(device)
    batches = [(pixels[r], labels[r]) for r in rows]
    with common.full_f32():
        return ref_train.steps(
            cell.reference(), cell.model, params, batches, aug,
            class_weights, tr, tr["corpus_boards"] // tr["batch_size"],
            cell.config["data"]["mean"], cell.config["data"]["std"], bits=bits)
