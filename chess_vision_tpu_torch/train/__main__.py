"""Train the flagship ChessViT on a CUDA GPU (or, asked to, on the CPU).

Counterpart of the root ``train.py`` on its streaming path, for ``arch=vit``
on one device:

    python -m chess_vision_tpu_torch.train --config configs/vit.yaml \
        [--resume ckpt] [--reset-schedule] [--auto-resume] [--seed 0] \
        [--set training.epochs=2 data.max_samples=50 ...] [--device cpu] \
        [--profile-steps N]

Each epoch trains on the loader's batches, evaluates on the validation split
(and the out-of-distribution set when its directory exists), and writes
``latest.ckpt`` (and ``best.ckpt`` on a better validation board accuracy) in
the JAX package's checkpoint layout, so either package resumes or serves the
other's checkpoints. ``main`` parses the command line and calls ``train``,
which takes the config as a dict and the datasets as objects.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np
import torch

from chess_vision_tpu_torch.config import (
    apply_overrides,
    get_data_config,
    load_config,
)
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree
from chess_vision_tpu_torch.data import BatchLoader, ChessDataset, seeded_split
from chess_vision_tpu_torch.models import (
    build_model,
    init_weights,
    normalize_remat,
    param_count,
    resolve_remat,
)
from chess_vision_tpu_torch.train.loop import (
    BatchStager,
    make_steps,
    run_eval_epoch,
    run_train_epoch,
)
from chess_vision_tpu_torch.train.state import (
    compute_class_weights,
    create_train_state,
)
from chess_vision_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from chess_vision_tpu_torch.utils.device import resolve_device
from chess_vision_tpu_torch.utils.logging import (
    MetricLogger,
    update_run_meta,
    write_run_meta,
)


def maybe_load_pretrained(model, cfg: dict) -> bool:
    """Load pretrained backbone weights when ``model.pretrained`` asks for
    them: a checkpoint in the shared layout at ``model.pretrained_path`` (or
    ``pretrained/<model name>.ckpt``), either a converted backbone or a whole
    model's checkpoint. A missing file means random init, with a warning."""
    if not cfg["model"].get("pretrained", False):
        return False
    path = cfg["model"].get("pretrained_path") or os.path.join(
        "pretrained", cfg["model"]["name"] + ".ckpt")
    if not os.path.exists(path):
        print(f"WARNING: pretrained weights not found at {path}; "
              "using random init (run the timm->jax converter to create them)")
        return False
    params = load_checkpoint(path)["params"]
    backbone = params.get("backbone", params)
    sd = state_dict_from_tree({"backbone": backbone})
    model.load_state_dict(sd, strict=False)
    print(f"Loaded pretrained backbone from {path}")
    return True


def _check_supported(cfg: dict) -> None:
    arch = cfg["model"].get("arch", "vit")
    if arch != "vit":
        raise NotImplementedError(
            f"training arch={arch!r} is not ported to PyTorch yet (ROADMAP "
            "Queue A item 10, CNN and square archs)")
    tcfg = cfg["training"]
    tp = int(tcfg.get("tensor_parallel", 1) or 1)
    fsdp = str(tcfg.get("fsdp", False)).lower() in ("true", "1", "yes")
    if tp > 1 or fsdp:
        raise NotImplementedError(
            "training.tensor_parallel and training.fsdp are not ported to "
            "PyTorch yet (ROADMAP Queue A item 11, multi-device)")
    dc = cfg["data"].get("device_cache", False)
    if isinstance(dc, str):
        dc = dc.lower() not in ("false", "0", "no")
    if dc:
        raise NotImplementedError(
            "data.device_cache is not ported to PyTorch yet (ROADMAP Queue A "
            "item 9, device-resident corpus); set data.device_cache=false")


def train(cfg: dict, dataset, ood_dataset=None, *, seed: int = 0,
          resume: str | None = None, reset_schedule: bool = False,
          device=None, profile_steps: int = 0, on_step=None) -> dict:
    """Train ``cfg``'s model on ``dataset`` (an object with ``samples``,
    ``labels_for``, ``load_image``, ``load_planes`` and ``len``, as
    ``data.ChessDataset``). Runs on the CUDA device unless ``device`` says
    otherwise. Returns the final state, the per-epoch metrics and the train
    images per second of each epoch."""
    _check_supported(cfg)
    device = resolve_device(device)
    if torch.cuda.device_count() > 1 and device.type == "cuda":
        print(f"Devices: using {device} of {torch.cuda.device_count()} "
              "(multi-device training is not ported)")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Devices: 1 x {kind}")

    # --- Data ---
    data_cfg = get_data_config(cfg["model"]["name"])
    train_idx, val_idx = seeded_split(len(dataset), cfg["data"]["val_split"],
                                      seed=42)
    batch_size = cfg["training"]["batch_size"]
    num_workers = cfg["data"].get("num_workers", 6)
    transport = cfg["data"].get("transport", "rgb")
    train_loader = BatchLoader(
        dataset, train_idx, batch_size, shuffle=True, seed=seed,
        num_workers=num_workers, drop_remainder=True, transport=transport)
    val_loader = BatchLoader(dataset, val_idx, batch_size,
                             num_workers=num_workers, transport=transport)
    print(f"Train: {len(train_idx)}, Val: {len(val_idx)}")
    if len(train_loader) == 0:
        raise ValueError("Not enough training samples for one batch")
    ood_loader = None
    if ood_dataset is not None:
        ood_loader = BatchLoader(
            ood_dataset, np.arange(len(ood_dataset)), batch_size,
            num_workers=num_workers, transport=transport)
        print(f"OOD val: {len(ood_dataset)} images")

    class_weights = None
    if cfg["training"].get("use_class_weights", False):
        class_weights = compute_class_weights(
            [dataset.samples[i] for i in train_idx])
        print(f"Class weights: {class_weights}")

    # --- Remat policy ---
    remat_cfg = normalize_remat(cfg["model"].get("remat", "auto"))
    if remat_cfg == "auto":
        remat_cfg = resolve_remat(batch_size, device)
        memory = (torch.cuda.get_device_properties(device).total_memory / 2**30
                  if device.type == "cuda" else 0.0)
        print(f"model.remat=auto -> {remat_cfg} (batch {batch_size}, device "
              f"memory {memory:.1f} GiB)")
    cfg["model"]["remat"] = remat_cfg

    # --- Model / state ---
    model = init_weights(build_model(cfg), seed=seed)
    maybe_load_pretrained(model, cfg)
    model.to(device)
    n_params = param_count(model)
    print(f"Parameters: {n_params:,}")
    steps_per_epoch = len(train_loader)
    state = create_train_state(cfg, model, steps_per_epoch)

    # --- Resume ---
    start_epoch = 0
    best_val_acc = 0.0
    if resume:
        ckpt = load_checkpoint(resume)
        restore_train_state(state, ckpt, weights_only=reset_schedule)
        if reset_schedule:
            print(f"Loaded weights from {resume}, reset schedule (warm restart)")
        else:
            start_epoch = ckpt["epoch"] + 1
            best_val_acc = ckpt.get("best_val_acc", 0.0)
            print(f"Resumed from epoch {start_epoch}")

    train_step, eval_step = make_steps(
        state, cfg, class_weights, data_cfg["mean"], data_cfg["std"], seed=seed)
    stager = BatchStager(device)

    # --- Logging / checkpointing ---
    run_name = datetime.now().strftime("%Y%m%d_%H%M%S")
    tb_dir = os.path.join(cfg["logging"]["tensorboard_dir"], run_name)
    logger = MetricLogger(tb_dir)
    save_dir = cfg["checkpointing"]["save_dir"]
    os.makedirs(save_dir, exist_ok=True)
    patience = cfg["checkpointing"].get("early_stopping_patience")
    epochs_without_improvement = 0
    meta_path = write_run_meta(
        save_dir, cfg, device=f"1x{kind}", train_size=len(train_idx),
        val_size=len(val_idx), tb_dir=tb_dir, n_params=n_params)
    print(f"Run metadata: {meta_path}")

    # --- Training loop ---
    epochs = cfg["training"]["epochs"]
    epoch = start_epoch
    train_metrics = val_metrics = {}
    history = []
    for epoch in range(start_epoch, epochs):
        print(f"\nEpoch {epoch + 1}/{epochs}")
        t0 = time.time()
        profile_stop = None
        if profile_steps > 0 and epoch == start_epoch:
            profile_stop = _start_profile(profile_steps, tb_dir, device)
        train_metrics = run_train_epoch(
            train_step, state, train_loader, stager,
            step_log=logger.log_step, on_step=on_step,
            profile_stop=profile_stop)
        train_elapsed = time.time() - t0
        val_metrics = run_eval_epoch(eval_step, val_loader, stager, on_step)
        ood_metrics = (run_eval_epoch(eval_step, ood_loader, stager, on_step)
                       if ood_loader is not None else None)
        elapsed = time.time() - t0
        train_rate = steps_per_epoch * batch_size / max(train_elapsed, 1e-9)
        logger.flush_steps()

        for name, m in (("Train", train_metrics), ("Val  ", val_metrics)):
            print(f"  {name} — loss: {m['loss']:.4f}, "
                  f"sq_acc: {m['square_acc']:.4f}, board_acc: {m['board_acc']:.4f}, "
                  f"turn: {m['turn_acc']:.4f}, castling: {m['castling_acc']:.4f}, "
                  f"full_fen: {m['full_fen_acc']:.4f}")
        if ood_metrics is not None:
            print(f"  OOD   — loss: {ood_metrics['loss']:.4f}, "
                  f"sq_acc: {ood_metrics['square_acc']:.4f}, "
                  f"board_acc: {ood_metrics['board_acc']:.4f}")
        print(f"  LR: {state.schedule(state.step):.2e} | Time: {elapsed:.1f}s "
              f"({train_rate:.0f} train img/s)")
        logger.log_epoch("train", train_metrics, epoch)
        logger.log_epoch("val", val_metrics, epoch)
        if ood_metrics is not None:
            logger.log_ood(ood_metrics, epoch)
        history.append({"epoch": epoch, "train": train_metrics,
                        "val": val_metrics, "ood": ood_metrics,
                        "train_img_per_s": train_rate})

        save_checkpoint(os.path.join(save_dir, "latest.ckpt"), state,
                        epoch=epoch, best_val_acc=best_val_acc, config=cfg)
        if val_metrics["board_acc"] > best_val_acc:
            best_val_acc = val_metrics["board_acc"]
            save_checkpoint(os.path.join(save_dir, "best.ckpt"), state,
                            epoch=epoch, best_val_acc=best_val_acc, config=cfg)
            print(f"  >> New best val board_acc: {best_val_acc:.4f}")
            epochs_without_improvement = 0
        else:
            epochs_without_improvement += 1
        if patience and epochs_without_improvement >= patience:
            print(f"  Early stopping after {patience} epochs without improvement.")
            break

    logger.close()
    update_run_meta(meta_path, best_val_acc=best_val_acc,
                    total_epochs=epoch + 1, final_train_metrics=train_metrics,
                    final_val_metrics=val_metrics)
    print(f"\nTraining complete. Best val board_acc: {best_val_acc:.4f}")
    print(f"Checkpoints saved to {save_dir}/")
    return {"state": state, "history": history, "best_val_acc": best_val_acc}


def _start_profile(steps: int, tb_dir: str, device: torch.device):
    """Start a ``torch.profiler`` trace; returns ``(steps, stop)`` for
    ``run_train_epoch``: ``stop`` prints the kernels by device time and
    writes a Chrome trace into the TensorBoard directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()

    def stop():
        prof.stop()
        sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=sort, row_limit=25))
        path = os.path.join(tb_dir, "train_steps.trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace of {steps} steps written to {path}")

    return steps, stop


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train chess recognition model")
    parser.add_argument("--config", default="configs/vit.yaml")
    parser.add_argument("--resume", default=None)
    parser.add_argument("--reset-schedule", action="store_true",
                        help="Keep weights only when resuming (warm restart)")
    parser.add_argument("--set", nargs="*", default=[],
                        help="Override config values, e.g. training.epochs=10")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--auto-resume", action="store_true",
                        help="Resume from <save_dir>/latest.ckpt when present")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="Trace the first N steps of the first epoch with "
                             "torch.profiler into the TensorBoard dir")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    device = resolve_device(args.device)  # fail before any data is read
    if cfg["training"].get("debug_nans", False):
        torch.autograd.set_detect_anomaly(True)

    if args.auto_resume and not args.resume:
        candidate = os.path.join(cfg["checkpointing"]["save_dir"], "latest.ckpt")
        if os.path.exists(candidate):
            args.resume = candidate
            print(f"Auto-resuming from {candidate}")

    input_size = cfg["model"].get("input_size") or 224
    cache = dict(cache_decoded=bool(cfg["data"].get("cache_decoded", True)),
                 cache_budget_gb=float(cfg["data"].get("cache_budget_gb", 8.0)))
    dataset = ChessDataset(cfg["data"]["train_dir"],
                           max_samples=cfg["data"].get("max_samples"),
                           input_size=input_size, **cache)
    ood_dataset = None
    ood_dir = cfg["data"].get("ood_val_dir")
    if ood_dir and os.path.isdir(ood_dir):
        ood_dataset = ChessDataset(
            ood_dir, max_samples=cfg["data"].get("ood_val_max_samples", 2000),
            input_size=input_size, **cache)
    train(cfg, dataset, ood_dataset, seed=args.seed, resume=args.resume,
          reset_schedule=args.reset_schedule, device=device,
          profile_steps=args.profile_steps)


if __name__ == "__main__":
    main()
