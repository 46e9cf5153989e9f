"""Read the JAX package's checkpoints without JAX or flax.

``chess_vision_tpu/utils/checkpoint.py`` writes one msgpack file through
``flax.serialization``: a map with the parameter trees as nested maps whose
leaves are ndarrays, stored as msgpack ExtType 1 holding the msgpack-encoded
triple (shape, dtype name, raw bytes); numpy scalars are ExtType 3 with the
same payload. Arrays above flax's chunk size are split into
``{"__msgpack_chunked_array__": ..., "shape": ..., "chunks": ...}`` maps.
"""

from __future__ import annotations

import json

import numpy as np

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
