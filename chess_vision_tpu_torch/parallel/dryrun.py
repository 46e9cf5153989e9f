"""Train steps over several ranks held against one device, and the
counterpart of the root ``__graft_entry__.py`` ``dryrun_multichip``.

``compare_ranks(world, runs, device, backend)`` spawns ``world`` processes
joined in one ``torch.distributed`` group (``tcp://localhost`` on a free
port) and runs each of ``runs`` there: the same model, weights, batches and
augmentation draws through ``train_steps`` on the (data, model) grid the run
names. It returns, per run, rank 0's step losses and the parameters gathered
into the single-device layout; ``train_steps`` with no group is the
one-device reference. The tests run it on the CPU over gloo; ``chip_smoke.py``
runs it with two ranks on one card over gloo (NCCL refuses two ranks on one
GPU), which shows the function, not a scaling.

``dryrun_multichip(n, device)`` runs the JAX package's three surfaces on
``n`` ranks over gloo: an FSDP data-parallel train step, a TP + FSDP train
step on a (n / tp, tp) grid, and int8 serving over ``n`` devices
(``serve.Predictor(devices=...)``). On CUDA rank r takes card r modulo the
visible cards (several ranks may share one: gloo, unlike NCCL, allows it);
``--device cpu`` rehearses it on the CPU. Its model is the JAX dryrun's,
ViT-B/16 at 64 px.

    python -m chess_vision_tpu_torch.parallel.dryrun [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile

import numpy as np
import torch

from chess_vision_tpu_torch.utils.device import resolve_device

MEAN = STD = (0.5, 0.5, 0.5)
# the JAX dryrun's model: ViT-B/16's width and depth (at tiny_config's 64 px)
FULL_WIDTH = {"embed_dim": 768, "depth": 12, "num_heads": 12}


def tiny_config(arch: str = "vit", mixed: bool = False, **model) -> dict:
    """A small model of ``arch`` at 64 px (ViT: embed 128, depth 2, 4 heads
    of 32: its patch embedding and MLP weights reach the 2^16 elements from
    which FSDP shards a leaf) with the ``configs/vit.yaml`` training
    values."""
    base = ({"arch": "vit", "input_size": 64, "embed_dim": 128, "depth": 2,
             "num_heads": 4} if arch == "vit" else
            {"arch": arch, "input_size": 64, "square_input_size": 32})
    return {"model": {**base, "head_dropout": 0.1, "drop_path_rate": 0.1,
                      "remat": False, **model},
            "training": {"mixed_precision": mixed, "lr": 1e-3, "epochs": 1,
                         "weight_decay": 0.01, "grad_clip_norm": 1.0,
                         "label_smoothing": 0.1, "turn_loss_weight": 1.0,
                         "castling_loss_weight": 1.0},
            "scheduler": {"warmup_epochs": 0}}


def random_batches(count: int, batch: int, size: int = 64, seed: int = 0,
                   padded: bool = True) -> list[dict]:
    """Loader-shaped numpy batches; with ``padded`` the last row of each is
    padding (mask 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        mask = np.ones(batch, np.float32)
        if padded:
            mask[-1] = 0.0
        out.append({
            "image": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
            "squares": rng.integers(0, 13, (batch, 64)).astype(np.int32),
            "turn": rng.integers(0, 2, (batch, 1)).astype(np.float32),
            "castling": rng.integers(0, 2, (batch, 4)).astype(np.float32),
            "legal": np.ones((batch, 1), np.float32),
            "mask": mask})
    return out


def train_steps(cfg: dict, batches: list, device=None, *, tp: int = 1,
                fsdp: bool = False, state_dict: dict | None = None,
                class_weights=None, aug: list | None = None,
                dropout: float = 0.0, plant: str | None = None,
                seed: int = 0) -> dict:
    """Train ``cfg``'s model (``init_weights(seed)``, or ``state_dict``) on
    ``batches`` (global batches), one optimizer step each, on this process's
    grid (``parallel.mesh.init_mesh``: no group, one device). ``aug``: the
    global batches' augmentation parameters, else the steps' own draws.
    ``dropout``: the rate of the backbone's dropouts (position, attention
    output, MLP hidden and output), which no config sets. ``plant`` puts a
    fault in, for the checks that must see it: ``"no_gradient_sum"`` skips
    the data axis's gradient sum, so each rank steps on its slice's
    gradient. Runs on the card unless ``device`` says otherwise. Returns the
    step losses, the parameters and buffers, full, on the CPU, this rank's
    attention launches (K2, K3; f32 K2, K3) over the steps, and how many of
    its parameters FSDP shards and TP cuts."""
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.models.layers import Dropout
    from chess_vision_tpu_torch.ops import attention as attn
    from chess_vision_tpu_torch.parallel import mesh as parallel
    from chess_vision_tpu_torch.train.loop import BatchStager, make_steps
    from chess_vision_tpu_torch.train.state import create_train_state

    device = resolve_device(device)
    mesh = parallel.init_mesh(device, tp, fsdp)
    model = init_weights(build_model(cfg), seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    for module in model.backbone.modules():
        if type(module) is Dropout:
            module.rate = dropout
    state = create_train_state(cfg, model.to(device), len(batches))
    parallel.shard_train_state(state, mesh)
    if plant == "no_gradient_sum":
        state._reduce_gradients = lambda grads: None
    elif plant is not None:
        raise ValueError(f"unknown plant {plant!r}")
    weights = None if class_weights is None else torch.as_tensor(class_weights)
    train_step, _ = make_steps(state, cfg, weights, MEAN, STD, seed=seed)
    stager = BatchStager(device)
    losses = []
    counters = ("LAUNCHES", "BWD_LAUNCHES", "F32_LAUNCHES", "F32_BWD_LAUNCHES")
    before = [getattr(attn, c) for c in counters]
    for i, batch in enumerate(batches):
        params = None
        if aug is not None:
            params = {k: torch.as_tensor(v).to(device) for k, v in aug[i].items()}
        sums = train_step(
            stager(parallel.shard_batch(batch, mesh.dp_rank, mesh.dp)), params)
        losses.append(sums["step_loss"].item())
    launches = [getattr(attn, c) - b for c, b in zip(counters, before)]
    sharded = sum(parallel.is_sharded(p) for p in state.params)
    sd, _, _ = parallel.full_state(state)
    return {"losses": losses, "launches": launches, "sharded": sharded,
            "tp_cut": len(state.tp_layout),
            "state": {k: v.detach().float().cpu() for k, v in sd.items()}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, device: str, backend: str,
            runs_path: str, out_path: str) -> None:
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a crash in a collective prints the Python stack
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        runs = torch.load(runs_path, weights_only=False)
        results = {name: train_steps(**run, device=device)
                   for name, run in runs.items()}
        if rank:  # the other ranks report their launches alone
            results = {name: {"launches": r["launches"]}
                       for name, r in results.items()}
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def compare_ranks(world: int, runs: dict, device: str | None = None,
                  backend: str = "gloo") -> dict:
    """Run every ``train_steps`` keyword set of ``runs`` (name -> kwargs) on
    ``world`` spawned ranks, on the card unless ``device`` says otherwise;
    returns name -> rank 0's result, with every rank's launches under
    ``launches_by_rank``."""
    import torch.multiprocessing as mp

    device = str(resolve_device(device))

    with tempfile.TemporaryDirectory() as tmp:
        runs_path = os.path.join(tmp, "runs.pt")
        out_path = os.path.join(tmp, "out.pt")
        torch.save(runs, runs_path)
        mp.spawn(_worker, args=(world, free_port(), device, backend,
                                runs_path, out_path), nprocs=world)
        ranks = [torch.load(f"{out_path}.{r}", weights_only=False)
                 for r in range(world)]
    for name, result in ranks[0].items():
        result["launches_by_rank"] = [r[name]["launches"] for r in ranks]
    return ranks[0]


def rank_device(device: str, rank: int) -> str:
    """Rank ``rank``'s device: on CUDA its card, modulo the visible cards."""
    if torch.device(device).type != "cuda":
        return device
    return f"cuda:{rank % torch.cuda.device_count()}"


def _surfaces_worker(rank: int, world: int, port: int, device: str,
                     cfg: dict, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        device = rank_device(device, rank)
        batches = random_batches(1, 2 * world)
        fsdp = train_steps(cfg, batches, device, fsdp=True)
        tp = 4 if world % 4 == 0 else 2 if world % 2 == 0 else 1
        both = train_steps(cfg, batches, device, tp=tp, fsdp=True)
        if rank == 0:
            torch.save({"fsdp": fsdp["losses"][0], "tp": tp,
                        "tp_fsdp": both["losses"][0],
                        "launches": [fsdp["launches"], both["launches"]]},
                       out_path)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | None = None,
                     cfg: dict | None = None) -> dict:
    """The three surfaces of the JAX package's ``dryrun_multichip`` on
    ``n_devices`` ranks (gloo) on ``device`` (module docstring; default the
    card, raising without one), with
    ``cfg``'s model (default: the JAX dryrun's, ViT-B/16 at 64 px in bf16);
    prints a line for each and returns the losses, rank 0's attention
    launches (``train_steps``) and the int8 predictions' count."""
    import torch.multiprocessing as mp

    from chess_vision_tpu_torch.convert.jax_params import tree_from_state_dict
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.serve import Predictor

    device = resolve_device(device).type
    cfg = cfg or tiny_config(mixed=True, **FULL_WIDTH)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.pt")
        mp.spawn(_surfaces_worker, nprocs=n_devices, args=(
            n_devices, free_port(), device, cfg, out_path))
        out = torch.load(out_path, weights_only=False)
    for key in ("fsdp", "tp_fsdp"):
        if not np.isfinite(out[key]):
            raise RuntimeError(f"non-finite {key} loss {out[key]}")
    if abs(out["tp_fsdp"] - out["fsdp"]) >= 5e-2:
        raise RuntimeError(f"tp step diverged from dp step: {out}")
    print(f"dryrun_multichip OK: {n_devices}-rank grid on {device}, fsdp+dp "
          f"sharded train step, loss={out['fsdp']:.4f}")
    print(f"dryrun_multichip OK: ({n_devices // out['tp']}x{out['tp']}) data "
          f"x model grid, tp+fsdp sharded train step, "
          f"loss={out['tp_fsdp']:.4f}")

    # third surface: int8 serving with one replica of the pack per device
    params = tree_from_state_dict(
        init_weights(build_model(cfg), seed=0).state_dict())
    predictor = Predictor(
        (cfg, params), batch_size=2 * n_devices, quant="int8",
        devices=[rank_device(device, r) for r in range(n_devices)])
    images = random_batches(1, 2 * n_devices)[0]["image"]
    fens = predictor.predict_array(images)
    if len(fens) != len(images):
        raise RuntimeError(f"{len(fens)} FENs for {len(images)} boards")
    print(f"dryrun_multichip OK: {n_devices}-device int8 serving, "
          f"{len(fens)} boards")
    out["int8_boards"] = len(fens)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None,
                        help="cpu to rehearse on the CPU (default: the card)")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
