"""Native (C++) JPEG decode + resize through ctypes.

The port's own copy of ``chess_vision_tpu/native``: ``decoder.cpp`` (libjpeg
decompress, PIL-parity triangle-filter resize, raw YCbCr 4:2:0 planes) is
compiled with ``g++`` at first use into ``chess_vision_tpu_torch/build/``
(not tracked by git) and loaded with ``ctypes``; so is the port's own
``convert.cpp`` (the RGB -> 4:2:0 host conversion of decoded boards), which
needs no libjpeg. The calls release the GIL, so a Python thread pool decodes
and converts in parallel.

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
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_I, _L, _P = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
# library -> (source, linker flags, {function: (restype, argtypes)})
_LIBRARIES = {
    "decoder": ("decoder.cpp", ["-ljpeg"], {
        "decode_resize": (_I, [ctypes.c_char_p, _L, _I, _P]),
        "decode_ycbcr420": (_I, [ctypes.c_char_p, _L, _I, _P, _P, _P])}),
    "convert": ("convert.cpp", [], {
        "rgb_to_ycbcr420": (None, [_P, _I, _I, _P, _P, _P])}),
}
_lock = threading.Lock()
_libs: dict = {}  # name -> CDLL, or None when it did not build


def _build(source: str, path: str, flags: list) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
             "-ffp-contract=off", "-shared", source, "-o", tmp, *flags],
            check=True, capture_output=True)
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(name: str = "decoder"):
    with _lock:
        if name in _libs:
            return _libs[name]
        source, flags, functions = _LIBRARIES[name]
        source = os.path.join(_DIR, source)
        path = os.path.join(_BUILD_DIR, f"libcvt{name}.so")
        try:
            if not os.path.exists(path) or (
                    os.path.getmtime(path) < os.path.getmtime(source)):
                _build(source, path, flags)
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in functions.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _libs[name] = lib
        return lib


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


def rgb_to_ycbcr420_into(images: np.ndarray, y: np.ndarray, cb: np.ndarray,
                         cr: np.ndarray) -> bool:
    """C-contiguous uint8 (B, S, S, 3) RGB boards -> their 4:2:0 planes in
    the C-contiguous uint8 arrays ``y`` (B, S, S), ``cb`` and ``cr`` (B, S/2,
    S/2), byte for byte ``ops/preprocess.rgb_to_ycbcr420``'s; False (nothing
    written) when the library is not there."""
    lib = _load("convert")
    if lib is None:
        return False
    B, S = images.shape[:2]
    for a in (images, y, cb, cr):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError("expected C-contiguous uint8 arrays")
    if (images.shape != (B, S, S, 3) or y.shape != (B, S, S) or S % 2
            or cb.shape != (B, S // 2, S // 2) or cr.shape != cb.shape):
        raise ValueError(f"shapes {images.shape} -> {y.shape}, {cb.shape}, "
                         f"{cr.shape}")
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.rgb_to_ycbcr420(ptr(images), B, S, ptr(y), ptr(cb), ptr(cr))
    return True
