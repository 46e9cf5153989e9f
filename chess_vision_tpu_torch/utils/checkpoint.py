"""Read and write the JAX package's checkpoints without JAX or flax, so that
either package resumes or serves what the other trained.

``chess_vision_tpu/utils/checkpoint.py`` writes one msgpack file through
``flax.serialization``: a map with the parameter trees as nested maps whose
leaves are ndarrays, stored as msgpack ExtType 1 holding the msgpack-encoded
triple (shape, dtype name, raw bytes); numpy scalars are ExtType 3 with the
same payload. Arrays above flax's chunk size are split into
``{"__msgpack_chunked_array__": ..., "shape": ..., "chunks": ...}`` maps
(read here; the writer refuses an array that large, the model has none).

``save_checkpoint`` (through ``write_checkpoint``, which also writes the
converter's checkpoints) writes {epoch, step, params, opt_state, batch_stats,
best_val_acc, config_json} with the parameters and the BatchNorm running
statistics (``batch_stats``, empty for a model without BatchNorm) carried
through the inverse weight bridge and the AdamW moments laid out as the state optax gives
``chain(clip_by_global_norm, adamw(schedule))``: ``("0": {}, "1": ("0":
{count, mu, nu}, "1": {}, "2": {count}))``, wrapped in ``multi_transform``'s
``inner_states`` when the backbone is frozen (its moments are then empty
nodes). ``restore_train_state`` reads either package's checkpoint back.
``msgpack`` is imported at call time.

A state sharded over several devices (``parallel/mesh.py``) is gathered into
the full, single-device layout on every rank and written by rank 0 alone;
a trainer resumes into the full state before sharding it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from chess_vision_tpu_torch.convert.jax_params import (
    state_dict_from_tree,
    tree_from_state_dict,
    variables_from_state_dict,
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _indexed(d: dict) -> list:
    """flax stores tuples as maps keyed "0", "1", ..."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(_indexed(tree["shape"]))
        return np.concatenate(_indexed(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path: str) -> dict:
    """Raw checkpoint dict of nested dicts of numpy arrays; 'config' is
    parsed back to a dict (as ``chess_vision_tpu.utils.checkpoint``)."""
    import msgpack

    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    payload = _unchunk(payload)
    payload["config"] = json.loads(payload.pop("config_json"))
    return payload


_MAX_ARRAY_BYTES = 2**30  # flax chunks arrays above this size


def _ext_pack(obj):
    import msgpack

    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        if a.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(f"array of {a.nbytes} bytes needs flax's chunked "
                             "layout, which this writer does not produce")
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        return msgpack.ExtType(code, msgpack.packb(
            (a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(obj)}")


def _masked_like(params_tree: dict, moments_tree: dict) -> dict:
    """``moments_tree`` completed to the structure of ``params_tree``, with an
    empty node where a parameter has no moment (optax's ``MaskedNode``)."""
    out = {}
    for name, value in params_tree.items():
        have = moments_tree.get(name)
        if isinstance(value, dict):
            out[name] = _masked_like(value, have or {})
        else:
            out[name] = {} if have is None else have
    return out


def optax_state_dict(state, params_tree: dict, moments=None) -> dict:
    """The train state's AdamW moments (or ``moments``, a gathered (mu, nu)
    pair) and count as the serialized ``opt_state`` of the JAX package's
    optimizer."""
    count = np.asarray(state.step, np.int32)
    mu, nu = moments or (state.mu, state.nu)
    mu = _masked_like(params_tree, tree_from_state_dict(mu))
    nu = _masked_like(params_tree, tree_from_state_dict(nu))
    inner = {"0": {}, "1": {"0": {"count": count, "mu": mu, "nu": nu},
                            "1": {}, "2": {"count": count}}}
    if not state.freeze_backbone:
        return inner
    return {"inner_states": {"train": {"inner_state": inner},
                             "freeze": {"inner_state": {}}}}


def save_checkpoint(path: str, state, epoch: int, best_val_acc: float,
                    config: dict) -> None:
    """Write ``state`` (``train.state.TrainState``) in the JAX package's
    checkpoint layout, atomically. A sharded state is gathered (every rank
    must call this) and rank 0 writes."""
    from chess_vision_tpu_torch.parallel.mesh import full_state

    sd, mu, nu = full_state(state)
    mesh = getattr(state, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        return
    variables = variables_from_state_dict(sd)
    params_tree = variables["params"]
    write_checkpoint(path, params_tree, variables["batch_stats"],
                     step=state.step, epoch=epoch, best_val_acc=best_val_acc,
                     config=config,
                     opt_state=optax_state_dict(state, params_tree, (mu, nu)))


def write_checkpoint(path: str, params: dict, batch_stats: dict, *, step: int,
                     epoch: int, best_val_acc: float, config: dict,
                     opt_state: dict | None = None) -> None:
    """Write trees in the JAX layout (nested dicts of numpy arrays) as the
    JAX package's ``save_checkpoint`` does, atomically; ``opt_state`` empty
    unless given (a converted checkpoint has none)."""
    import msgpack

    payload = {
        "step": int(step),
        "epoch": int(epoch),
        "best_val_acc": float(best_val_acc),
        "config_json": json.dumps(config),
        "params": params,
        "opt_state": opt_state or {},
        "batch_stats": batch_stats,
    }
    blob = msgpack.packb(payload, default=_ext_pack, strict_types=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # a crash mid-write never corrupts latest.ckpt


def restore_train_state(state, ckpt: dict, weights_only: bool = False) -> None:
    """Load a checkpoint dict (``load_checkpoint``) into ``state`` in place:
    the parameters and running statistics, and unless ``weights_only`` the
    moments and step."""
    import torch

    sd = state_dict_from_tree(ckpt["params"])
    sd.update(state_dict_from_tree(ckpt.get("batch_stats") or {}))
    state.model.load_state_dict(sd)
    if weights_only:
        return
    opt = ckpt["opt_state"]
    if "inner_states" in opt:
        opt = opt["inner_states"]["train"]["inner_state"]
    adam = opt["1"]["0"]
    with torch.no_grad():
        for name, moments in (("mu", state.mu), ("nu", state.nu)):
            loaded = state_dict_from_tree(adam[name])
            if set(loaded) != set(moments):
                raise ValueError(
                    f"checkpoint {name} covers {len(loaded)} parameters, the "
                    f"train state {len(moments)} (model.freeze_backbone "
                    "differs?)")
            for key, value in loaded.items():
                moments[key].copy_(value)
    state.step = int(ckpt["step"])
