"""Native (C++) JPEG decode + resize through ctypes.

The port's own copy of ``chess_vision_tpu/native``: ``decoder.cpp`` (libjpeg
decompress, PIL-parity triangle-filter resize, raw YCbCr 4:2:0 planes) is
compiled with ``g++`` at first use into ``chess_vision_tpu_torch/build/``
(not tracked by git) and loaded with ``ctypes``. The call releases the GIL, so
a Python thread pool decodes in parallel.

This is host I/O: when ``g++`` or libjpeg is missing, or a file is not a JPEG
the decoder takes, the functions return ``None`` and the caller decodes with
PIL instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "decoder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcvtdecoder.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
             "-shared", _SOURCE, "-o", tmp, "-ljpeg"],
            check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or (
                    os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SOURCE)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.decode_resize.restype = ctypes.c_int
            lib.decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.decode_ycbcr420.restype = ctypes.c_int
            lib.decode_ycbcr420.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        return _lib


def available() -> bool:
    return _load() is not None


def _read_jpeg(path: str) -> bytes | None:
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def decode_resize_jpeg(data: bytes, out_size: int) -> np.ndarray | None:
    """JPEG bytes -> uint8 (out_size, out_size, 3), or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.decode_resize(
        data, len(data), out_size, out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def decode_file(path: str, out_size: int) -> np.ndarray | None:
    data = _read_jpeg(path)
    return None if data is None else decode_resize_jpeg(data, out_size)


def decode_ycbcr420(data: bytes, size: int):
    """4:2:0 JPEG bytes -> (Y (size,size), Cb, Cr (size/2,size/2)) uint8
    planes without chroma upsampling, or None if the JPEG does not match
    (wrong size or subsampling): the caller then decodes RGB."""
    lib = _load()
    if lib is None or size % 16:
        return None
    y = np.empty((size, size), np.uint8)
    cb = np.empty((size // 2, size // 2), np.uint8)
    cr = np.empty((size // 2, size // 2), np.uint8)
    rc = lib.decode_ycbcr420(
        data, len(data), size,
        y.ctypes.data_as(ctypes.c_void_p),
        cb.ctypes.data_as(ctypes.c_void_p),
        cr.ctypes.data_as(ctypes.c_void_p),
    )
    return (y, cb, cr) if rc == 0 else None


def decode_file_ycbcr420(path: str, size: int):
    data = _read_jpeg(path)
    return None if data is None else decode_ycbcr420(data, size)
