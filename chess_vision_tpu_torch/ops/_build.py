"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

All kernels compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``: a few seconds to
build, where an extension that includes PyTorch's headers takes minutes. Each
``.cu`` file compiles in its own ``nvcc`` process, all started together, and
the objects are then linked. The library lands in
``chess_vision_tpu_torch/build/`` (not tracked by git) and is rebuilt when a
source or header is newer. Concurrent builds (threads or processes)
serialize on a lock file; the library is written under a temporary name and
renamed into place. A missing ``nvcc`` or a failed build raises: there is no
path around the kernels on a CUDA device.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcvt_kernels.so")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# Compiler output of the build this process ran (ptxas register and shared
# memory counts per kernel); empty when an up-to-date library was reused.
build_log = ""

_P = ctypes.c_void_p
_SIGNATURES = {
    "cvt_preprocess_u8": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P,
                          ctypes.c_int, _P],
    "cvt_attention_fwd": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, _P],
    "cvt_attention_bwd": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "cvt_attention_bwd_long": [_P, _P, _P, _P, _P, *[ctypes.c_int] * 7,
                               ctypes.c_float, _P],
    "cvt_attention_fwd_f32": [_P, _P, *[ctypes.c_int] * 5, ctypes.c_float,
                              ctypes.c_float, _P],
    "cvt_attention_bwd_f32": [_P, _P, _P, *[ctypes.c_int] * 5,
                              ctypes.c_float, _P],
    "cvt_attention_bwd_f32_long": [_P, _P, _P, _P, _P, *[ctypes.c_int] * 6,
                                   ctypes.c_float, _P],
    "cvt_attention_fwd_any": [_P, _P, *[ctypes.c_int] * 5, ctypes.c_float,
                              _P],
    "cvt_attention_bwd_any": [_P, _P, _P, _P, _P, *[ctypes.c_int] * 8,
                              ctypes.c_float, _P],
    "cvt_rowquant": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, _P, _P, ctypes.c_float, _P, _P, _P],
    "cvt_int8_matmul": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        _P, _P, ctypes.c_float, _P, _P, _P],
    "cvt_gelu_selftest": [ctypes.c_longlong, ctypes.c_int, _P, _P],
    "cvt_int8_res_route": [ctypes.c_int, ctypes.c_int, _P],
    "cvt_attention_quant": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_float, ctypes.c_int, _P],
    "cvt_attention_quant_flat": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                 _P],
    "cvt_attention_quant_max_clusters": [ctypes.c_int, ctypes.c_int],
    "cvt_attention_variant": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_float, ctypes.c_float, _P],
    "cvt_fused_block": [*[_P] * 23, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_float,
                        ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, _P, _P],
    "cvt_fused_block_scratch_bytes": [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int],
}
# Entry points that return something else than a cudaError_t.
_RESTYPES = {"cvt_fused_block_scratch_bytes": ctypes.c_longlong}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "chess_vision_tpu_torch cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands in parallel; wait for every one of them."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    done = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        done.append(subprocess.CompletedProcess(cmd, proc.returncode, out, err))
    return done


def _build() -> None:
    global build_log
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    units = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(u)}.{tag}.o")
            for u in units]
    tmp = f"{LIB_PATH}.{tag}"
    try:
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, u]
                          for u, o in zip(units, objs)])
        if all(p.returncode == 0 for p in steps):
            steps += _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
        for proc in steps:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n"
                    f"{' '.join(proc.args)}\n{proc.stdout}\n{proc.stderr}")
        build_log = "".join(p.stdout + p.stderr for p in steps)
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if _stale():
                _build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")
