"""Training over several devices (``chess_vision_tpu/parallel/mesh.py``).

The JAX package annotates shardings and lets GSPMD insert the collectives;
here each device is a process of a ``torch.distributed`` group, launched with
``python -m torch.distributed.run --nproc-per-node N -m
chess_vision_tpu_torch.train ...`` (NCCL on CUDA, gloo on the CPU). Ranks
form a (data, model) grid with the model axis fastest, as ``make_mesh_2d``
reshapes the devices: rank = data_rank * tp + model_rank. Without the
launcher's environment there is no group and the trainer takes its
single-device path unchanged.

Three modes compose, as in the JAX module:

* **data parallel** (always): every rank runs the same loader order and takes
  its contiguous slice of the global batch (``shard_rows``; the trainer's
  loaders decode only that slice). Random draws
  (augmentation, dropout, drop path) are made for the global batch from the
  same generator on every rank and sliced (``global_bernoulli``), the loss
  divides by the global batch's weights (``train/losses.py``), gradients are
  summed over the data axis by hand (so a parameter with no gradient, such
  as MobileNet's ``conv_head``, simply takes zeros) and clipped by the
  global norm, and unpinned BatchNorm reduces its sums over the data axis
  (``all_reduce_sum``). N ranks compute the function of one.
* **fsdp** (``training.fsdp``): FSDP2 (``fully_shard``) per transformer block
  or stage and at the root over the data axis, with ``param_sharding``'s
  leaf rule: leaves of at least 2^16 elements sharded on their largest
  dimension that the data axis divides (``fsdp_shard_dim``), the others
  replicated (left to the hand-written reduction). AdamW's moments are
  sharded like their parameters.
* **tensor parallel** (``training.tensor_parallel=T``, ViT only): Megatron's
  layout, the port's copy of ``_TP_RULES``: qkv and fc1 column-parallel,
  proj and fc2 row-parallel with one all-reduce after each
  (``reduce_from_model``; the input of a column-parallel product is
  ``copy_to_model``, whose backward all-reduces), LayerNorms, embeddings
  and heads replicated. The qkv columns are cut by head: rank r holds the
  q, k and v columns of heads [r H/T, (r+1) H/T), so the attention kernels
  (K2, K3) run on each rank on H/T whole heads; JAX cuts the 2304 columns
  contiguously and lets GSPMD reshard around XLA's attention. Where T does
  not divide the head count, attention stays replicated and only the MLP is
  cut (and a width that T does not divide stays replicated), as JAX falls
  back to replicated per leaf. With fsdp the parameters that TP does not
  cut are sharded over the data axis (``tp_tree_sharding(fsdp=True)``).

Checkpoints are gathered into the full, single-device layout on every rank
(``full_state``) and written by rank 0 alone, so the JAX package and a
1-rank port read them.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

FSDP_MIN_SIZE = 2**16  # param_sharding: smaller leaves stay replicated

# (module suffix, parameter) -> (dimension cut over the model axis, cut by
# head): the port's copy of the JAX module's _TP_RULES, in PyTorch's (out,
# in) weight layout
TP_RULES = {
    ("attn.qkv", "weight"): (0, True),
    ("attn.qkv", "bias"): (0, True),
    ("attn.proj", "weight"): (1, False),
    ("mlp.fc1", "weight"): (0, False),
    ("mlp.fc1", "bias"): (0, False),
    ("mlp.fc2", "weight"): (1, False),
}


@dataclass
class Mesh:
    """This process's place in the (data, model) grid; a world of one has no
    groups."""

    world: int = 1
    rank: int = 0
    dp: int = 1
    tp: int = 1
    fsdp: bool = False
    dp_group: object = None
    tp_group: object = None
    dp_mesh: object = None  # the data axis as a DeviceMesh, for FSDP2

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def launched() -> bool:
    """Whether ``torch.distributed.run`` (or another launcher) set the
    environment of a process group."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def local_device(device: torch.device) -> torch.device:
    """The device of this rank: on CUDA, ``LOCAL_RANK`` among the visible
    cards (several ranks may share one card, ``LOCAL_RANK`` modulo their
    count)."""
    if device.type != "cuda" or not launched():
        return device
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_mesh(device: torch.device, tp: int = 1, fsdp: bool = False) -> Mesh:
    """Join the launcher's process group (NCCL on CUDA, gloo on the CPU), or
    the one this process already joined, and build the (data, model) grid.
    Outside a launcher and a group: a world of one."""
    if not launched() and not dist.is_initialized():
        if tp != 1:
            raise ValueError(f"tp={tp} does not divide device count 1")
        return Mesh()
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"tp={tp} does not divide device count {world}")
    mesh = Mesh(world=world, rank=rank, dp=world // tp, tp=tp,
                fsdp=fsdp and world // tp > 1)
    # every rank creates every group, in the same order
    for d in range(mesh.dp):
        group = dist.new_group([d * tp + t for t in range(tp)])
        if d == mesh.dp_rank:
            mesh.tp_group = group
    for t in range(tp):
        group = dist.new_group([d * tp + t for d in range(mesh.dp)])
        if t == mesh.tp_rank:
            mesh.dp_group = group
    if mesh.fsdp:
        from torch.distributed.device_mesh import init_device_mesh

        grid = init_device_mesh(device.type, (mesh.dp, tp),
                                mesh_dim_names=("data", "model"))
        mesh.dp_mesh = grid["data"]
    return mesh


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# --- the data axis inside a step -------------------------------------------

_DATA: tuple[int, int, object] = (1, 0, None)  # (size, rank, group)


@contextmanager
def data_axis(mesh: Mesh | None):
    """Inside: random draws are made for the global batch and sliced, and
    BatchNorm's sums are reduced over the data axis of ``mesh``."""
    global _DATA
    before = _DATA
    if mesh is not None and mesh.dp > 1:
        _DATA = (mesh.dp, mesh.dp_rank, mesh.dp_group)
    try:
        yield
    finally:
        _DATA = before


def data_axis_size() -> int:
    return _DATA[0]


def global_bernoulli(shape, keep: float, device, cut=None) -> torch.Tensor:
    """A bool mask of ``shape`` (the local batch first) with P(True) = keep:
    this rank's slice of one draw for the global batch, so N ranks draw what
    one device draws. ``cut`` = (index, count): ``shape``'s last dimension
    is shard ``index`` of ``count`` contiguous ones (a column-parallel
    product's output, ``model_cut``), drawn at its full width and sliced
    like the rows."""
    size, rank, _ = _DATA
    n = shape[0]
    if cut is not None:
        shape = (*shape[:-1], shape[-1] * cut[1])
    full = torch.empty((n * size, *shape[1:]), dtype=torch.float32,
                       device=device).bernoulli_(keep)
    full = full[shard_rows(n * size, rank, size)]
    if cut is not None:
        full = full[..., shard_rows(shape[-1], *cut)]
    return full.bool()


def model_cut(group) -> tuple[int, int]:
    """(this rank's index, the count) over a model-axis group."""
    return dist.get_rank(group), dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangents over it too (each
    rank's loss reaches every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis (differentiable); ``x`` itself
    outside ``data_axis`` or on one rank."""
    size, _, group = _DATA
    return x if size == 1 else _AllReduceSum.apply(x, group)


def reduce_sums(sums: dict, mesh: Mesh | None) -> dict:
    """Metric sums of this rank's slice -> the global batch's, on every rank
    (one all-reduce of the stacked values)."""
    if mesh is None or mesh.dp == 1:
        return sums
    keys = list(sums)
    stacked = torch.stack([sums[k].float().reshape(()) for k in keys])
    dist.all_reduce(stacked, group=mesh.dp_group)
    return dict(zip(keys, stacked.unbind(0)))


def shard_rows(n: int, index: int, count: int) -> slice:
    """Shard ``index`` of ``count`` contiguous shards of ``n`` rows: the one
    way the port cuts a batch over ranks or devices. ``count`` must divide
    ``n``."""
    if n % count:
        raise ValueError(f"batch_size {n} not divisible by {count} devices")
    size = n // count
    return slice(index * size, (index + 1) * size)


def shard_batch(batch: dict, index: int, count: int) -> dict:
    """Shard ``index`` of ``count`` of a loader batch (numpy arrays or
    tensors with the batch first; ``shard_rows``); scalars (``n_real``)
    pass through."""
    if count == 1:
        return batch
    return {key: value if np.ndim(value) == 0
            else value[shard_rows(value.shape[0], index, count)]
            for key, value in batch.items()}


# --- tensor parallel --------------------------------------------------------


def _sum_in_f32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in f32 (bf16 partial sums are added as a
    single device's product accumulates them), in ``x``'s dtype."""
    y = x.float().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_in_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_in_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product: the identity, whose backward
    sums the input's gradient over the model axis."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel product: partial sums added over the
    model axis; the backward passes the (replicated) cotangent on."""
    return _ReduceFromModel.apply(x, group)


def _rule(name: str):
    for (module, leaf), rule in TP_RULES.items():
        if name.endswith(f"{module}.{leaf}"):
            return rule
    return None


def tp_layout(model: nn.Module, tp: int) -> dict:
    """Parameter name -> (dim, by_head, parts) for the leaves cut over a
    model axis of ``tp``: ``parts`` is 3 for qkv (q, k and v each cut), else
    1. Attention is cut only where tp divides the head count, a width only
    where tp divides it."""
    layout = {}
    if tp == 1:
        return layout
    for name, param in model.named_parameters():
        rule = _rule(name)
        if rule is None:
            continue
        dim, by_head = rule
        if ".attn." in name:
            heads = model.get_submodule(name.rsplit(".", 2)[0]).num_heads
            if heads % tp:
                continue  # attention replicated: its kernels need whole heads
        parts = 3 if by_head else 1
        if param.shape[dim] % (parts * tp):
            continue
        layout[name] = (dim, by_head, parts)
    return layout


def tp_slice(full: torch.Tensor, rule, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s cut of a full leaf: along ``dim``, the rank's share of
    each of the ``parts`` blocks (q, k and v for qkv: the rank's heads)."""
    dim, _, parts = rule
    blocks = full.chunk(parts, dim=dim)
    return torch.cat([b.chunk(tp, dim=dim)[rank] for b in blocks],
                     dim=dim).contiguous()


def tp_unslice(shards: list, rule) -> torch.Tensor:
    """The inverse of ``tp_slice`` over every rank's cut, in rank order."""
    dim, _, parts = rule
    per_rank = [s.chunk(parts, dim=dim) for s in shards]
    return torch.cat([torch.cat([p[i] for p in per_rank], dim=dim)
                      for i in range(parts)], dim=dim)


def shard_tensor_parallel(model: nn.Module, mesh: Mesh) -> dict:
    """Cut ``model``'s leaves in place by ``tp_layout`` and point its
    attention and MLP modules at the model axis; returns the layout."""
    layout = tp_layout(model, mesh.tp)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name in layout:
                param.data = tp_slice(param.data, layout[name], mesh.tp_rank,
                                      mesh.tp)
    for name, module in model.named_modules():
        if hasattr(module, "tp_group") and f"{name}.{_first_cut(module)}" in layout:
            module.tp_group = mesh.tp_group
            if hasattr(module, "num_heads"):
                module.num_heads //= mesh.tp
    return layout


def _first_cut(module: nn.Module) -> str:
    """The name of the leaf whose cut decides whether ``module`` (an
    ``Attention`` or an ``Mlp``) runs tensor-parallel."""
    return "qkv.weight" if hasattr(module, "qkv") else "fc1.weight"


# --- FSDP -------------------------------------------------------------------


def fsdp_shard_dim(shape, n: int) -> int | None:
    """``param_sharding``'s leaf rule: the largest dimension that ``n``
    divides, for leaves of at least 2^16 elements; None: replicated."""
    if not shape or int(np.prod(shape)) < FSDP_MIN_SIZE:
        return None
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] % n == 0:
            return d
    return None


def shard_fsdp(model: nn.Module, mesh: Mesh, keep: set) -> None:
    """FSDP2 over the data axis, per transformer block or stage and at the
    root; the parameters named in ``keep`` (cut by TP) and those the leaf
    rule leaves replicated stay out of it."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    ignored = {p for n, p in model.named_parameters()
               if n in keep or fsdp_shard_dim(p.shape, mesh.dp) is None}

    def placement(param):
        return Shard(fsdp_shard_dim(param.shape, mesh.dp))

    units = []
    for name in ("backbone.blocks", "backbone.stages"):
        try:
            units.extend(model.get_submodule(name))
        except AttributeError:
            pass
    # FSDP2 warns that the root returns views (the reshaped logits); no
    # caller updates them in place
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module")
    for unit in [*units, model]:
        fully_shard(unit, mesh=mesh.dp_mesh, shard_placement_fn=placement,
                    ignored_params=ignored)
    # the loss is the sum of the ranks' shares: sum the gradients, not their
    # mean, with a plain SUM (gloo has no PREMUL_SUM)
    for unit in [*units, model]:
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of an FSDP-sharded tensor (sharing its storage), or
    the tensor itself."""
    return t.to_local() if is_sharded(t) else t


def shard_train_state(state, mesh: Mesh) -> None:
    """Cut and shard ``state`` (a ``TrainState`` built on the full model,
    resumed or not) in place: TP cuts of the parameters and their moments,
    then FSDP of the model with the moments sharded like their
    parameters."""
    state.mesh = mesh
    layout = shard_tensor_parallel(state.model, mesh)
    state.tp_layout = layout
    with torch.no_grad():
        for moments in (state.mu, state.nu):
            for name, rule in layout.items():
                if name in moments:
                    moments[name] = tp_slice(moments[name], rule,
                                             mesh.tp_rank, mesh.tp)
    if mesh.fsdp and mesh.dp > 1:
        from torch.distributed.tensor import distribute_tensor

        shard_fsdp(state.model, mesh, set(layout))
        params = dict(state.model.named_parameters())
        for moments in (state.mu, state.nu):
            for name in moments:
                p = params[name]
                if is_sharded(p):
                    moments[name] = distribute_tensor(
                        moments[name], p.device_mesh, p.placements)
    state.params = [p for n, p in state.model.named_parameters()
                    if n in set(state.names)]


def _unshard(t) -> torch.Tensor:
    """The full tensor of an FSDP-sharded one (``Shard(d)`` over the data
    axis, torch.chunk's cuts), gathered with ``dist.all_gather``: the
    functional collective behind ``DTensor.full_tensor`` crashes over gloo on
    CUDA tensors."""
    d = t.placements[0].dim
    group = t.device_mesh.get_group()
    n, size = dist.get_world_size(group), t.shape[d]
    chunk = -(-size // n)
    part = t.to_local().detach()
    pad = [0, 0] * (part.dim() - d - 1) + [0, chunk - part.shape[d]]
    part = torch.nn.functional.pad(part, pad).contiguous()
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts, dim=d).narrow(d, 0, size)


def _gather(name: str, t: torch.Tensor, state) -> torch.Tensor:
    t = _unshard(t) if is_sharded(t) else t
    rule = state.tp_layout.get(name)
    if rule is None:
        return t.detach()
    shards = [torch.empty_like(t) for _ in range(state.mesh.tp)]
    dist.all_gather(shards, t.detach().contiguous(), group=state.mesh.tp_group)
    return tp_unslice(shards, rule)


def full_state(state) -> tuple[dict, dict, dict]:
    """(state_dict, mu, nu) of ``state`` in the full single-device layout; a
    collective on every rank of a sharded state."""
    sd = state.model.state_dict()
    if getattr(state, "mesh", None) is None or not (state.tp_layout
                                                      or state.mesh.fsdp):
        return sd, state.mu, state.nu
    return tuple({n: _gather(n, t, state) for n, t in tree.items()}
                 for tree in (sd, state.mu, state.nu))
