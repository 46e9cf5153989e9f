"""Time this checkout's attention and int8 GEMM kernels against another
revision's, in turns on one card, and compare their outputs.

Two revisions compare only inside one process on one card (rates move by
~10% between machines), so this builds the other revision's
``attention.cu``, ``attention_quant.cu``, ``attention_bwd.cu`` and
``int8_matmul.cu`` (with the headers beside them) into a second library in a
temporary directory and calls both libraries through the same C interface on
the same inputs, at the ViT-B/16 shapes of the serving and training paths:

  K2   attention forward, (batch, 257, 2304) and (64, 257, 2304), 12 heads:
       ms in the order other, this, this, other; whether the two outputs are
       equal bit for bit, and their max |difference|
  K4   quantizing attention at (batch, 257, 2304) with the exact row max and
       with a fixed shift; K5, its flat form, at (batch * 288, 2304) with 257
       real rows an image: ms in the same order, and whether the codes and
       scales equal the other's bit for bit
  K3   attention backward, (batch, 257, 2304) and (64, 257, 2304), 12 heads:
       ms of each in the order other, this, this, other; max |difference| of
       the two outputs and of each against ``reference_attention_bwd``
  GEMM every epilogue of ``cvt_int8_matmul`` at batch * 257 rows (qkv 768 ->
       2304, proj 768 -> 768 and fc2 3072 -> 768 with residual + LN + requant,
       fc1 768 -> 3072 with GELU + requant, the last fc2 with residual): ms in
       the same order, and whether every output equals the other's bit for bit
       (int32 sums are exact in any order, so a main loop may change and the
       bits may not)

Usage, from the repository root on a machine with a Hopper GPU:
  git archive REV chess_vision_tpu_torch/csrc | tar -x -C DIR
  python -m chess_vision_tpu_torch.experiments.kernel_ab \\
      --other-csrc DIR/chess_vision_tpu_torch/csrc [--batch 256]

The other revision may have K3's older interface (a statistics scratch as its
fourth pointer) and K4's and K5's older one (an f32 (rows, D) scratch as their
second pointer); its fc1 epilogue gets an f32 (rows, 3072) scratch either way.
The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

_P = ctypes.c_void_p
_ORDER = ("other", "this", "this", "other")
# (name, K, O, epilogue, gelu) as csrc/int8_matmul.cu numbers them
_GEMMS = (("qkv scale_bias", 768, 2304, 0, 0),
          ("proj res_ln_quant", 768, 768, 2, 0),
          ("fc1 gelu_quant sigmoid", 768, 3072, 3, 1),
          ("fc2 res_ln_quant", 3072, 768, 2, 0),
          ("fc2 res", 3072, 768, 1, 0))


def _param_count(source: str, name: str) -> int:
    text = re.sub(r"//[^\n]*", "", open(source).read())
    params = re.search(rf"{name}\s*\(([^)]*)\)\s*\{{", text).group(1)
    return len(params.split(","))


def build_other(csrc: str, out_dir: str) -> tuple[ctypes.CDLL, dict]:
    """The other revision's four sources as one library; which older
    interfaces it has (``k3_stats``: K3 takes the statistics scratch;
    ``k4_scratch``: K4 and K5 take the f32 scratch)."""
    lib_path = os.path.join(out_dir, "libother.so")
    names = ("attention.cu", "attention_quant.cu", "attention_bwd.cu",
             "int8_matmul.cu")
    sources = {name: os.path.join(csrc, name) for name in names}
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    lib_path, *sources.values()], check=True,
                   capture_output=True, text=True)
    old = {"k3_stats": _param_count(sources["attention_bwd.cu"],
                                    "cvt_attention_bwd") == 10,
           "k4_scratch": _param_count(sources["attention_quant.cu"],
                                      "cvt_attention_quant") == 12}
    lib = ctypes.CDLL(lib_path)
    ints = [ctypes.c_int] * 4
    lib.cvt_attention_bwd.argtypes = [*[_P] * (4 if old["k3_stats"] else 3),
                                      *ints, ctypes.c_float, _P]
    lib.cvt_int8_matmul.argtypes = _build._SIGNATURES["cvt_int8_matmul"]
    lib.cvt_attention_fwd.argtypes = _build._SIGNATURES["cvt_attention_fwd"]
    extra = [_P] if old["k4_scratch"] else []
    for name in ("cvt_attention_quant", "cvt_attention_quant_flat"):
        getattr(lib, name).argtypes = [*extra, *_build._SIGNATURES[name]]
    return lib, old


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(runs: dict) -> dict:
    times = {name: [] for name in runs}
    for name in _ORDER:
        times[name].append(cuda_ms(runs[name]))
    return times


def k2_ab(libs: dict, batch: int, gen) -> dict:
    n, heads, dh = 257, 12, 64
    qkv = torch.randn((batch, n, 3 * heads * dh), device=gen.device,
                      generator=gen).bfloat16()
    outs = {name: torch.empty((batch, n, heads * dh), device=gen.device,
                              dtype=torch.bfloat16) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        rc = libs[name].cvt_attention_fwd(qkv.data_ptr(), outs[name].data_ptr(),
                                          batch, n, heads, dh, dh ** -0.5, stream)
        _build.check(rc, f"{name}'s attention forward")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs})
    return {"shape": list(qkv.shape), "ms": times,
            "bit_identical": torch.equal(outs["this"], outs["other"]),
            "max_abs_diff": (outs["this"].float()
                             - outs["other"].float()).abs().max().item()}


def k4_ab(libs: dict, k4_scratch: bool, batch: int, np_: int, fixed: bool,
          gen) -> dict:
    """K4 (np_ = 257: every row a token) or K5 (np_ = 288 rows an image, 257
    real) on the same values in both libraries."""
    n, heads, dh = 257, 12, 64
    D = heads * dh
    qkv = torch.randn((batch, np_, 3 * D), device=gen.device,
                      generator=gen).bfloat16()
    shift = 0.0
    if fixed:  # as calibrate_attn_shifts sets it
        q, k = qkv[:8, :n].float().reshape(8, n, 3, heads, dh)[:, :, :2].unbind(2)
        shift = torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() / 8 - 40
    outs = {name: (torch.empty((batch, np_, D), device=gen.device,
                               dtype=torch.int8),
                   torch.empty((batch, np_, 1), device=gen.device))
            for name in libs}
    scratch = torch.empty((batch, np_, D), device=gen.device) if k4_scratch else None
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        oq, os_ = outs[name]
        extra = [scratch.data_ptr()] if name == "other" and k4_scratch else []
        if np_ == n:
            rc = libs[name].cvt_attention_quant(
                qkv.data_ptr(), *extra, oq.data_ptr(), os_.data_ptr(), batch, n,
                heads, dh, dh ** -0.5, shift, int(fixed), stream)
        else:
            rc = libs[name].cvt_attention_quant_flat(
                qkv.data_ptr(), *extra, oq.data_ptr(), os_.data_ptr(), batch,
                np_, n, heads, dh, dh ** -0.5, shift, int(fixed), stream)
        _build.check(rc, f"{name}'s quantizing attention")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs})
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
    return {"name": "K4" if np_ == n else "K5", "shape": list(qkv.shape),
            "fixed_shift": fixed, "ms": times, "bit_identical": same}


def k3_ab(libs: dict, with_stats: bool, batch: int, gen) -> dict:
    n, heads, dh = 257, 12, 64
    dev = gen.device
    qkv = torch.randn((batch, n, 3 * heads * dh), device=dev,
                      generator=gen).bfloat16()
    g = torch.randn((batch, n, heads * dh), device=dev, generator=gen).bfloat16()
    stats = torch.empty((batch, heads, 3, n), device=dev)
    outs = {name: torch.empty_like(qkv) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        scratch = [stats.data_ptr()] if name == "other" and with_stats else []
        rc = libs[name].cvt_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), outs[name].data_ptr(), *scratch,
            batch, n, heads, dh, dh ** -0.5, stream)
        _build.check(rc, f"{name}'s attention backward")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs})
    ref = attn.reference_attention_bwd(qkv, g, heads).float()
    return {"shape": list(qkv.shape), "ms": times,
            "max_abs_diff": (outs["this"].float()
                             - outs["other"].float()).abs().max().item(),
            "max_abs_err": {name: (out.float() - ref).abs().max().item()
                            for name, out in outs.items()}}


def gemm_ab(libs: dict, case: tuple, rows: int, gen) -> dict:
    name, k, o, epilogue, gelu = case
    dev = gen.device
    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    xq, wq = ri(rows, k), ri(o, k)
    xs = torch.rand((rows, 1), device=dev, generator=gen) * 0.02 + 0.002
    ws = torch.rand(o, device=dev, generator=gen) * 0.0004 + 0.0002
    bias = torch.randn(o, device=dev, generator=gen) * 0.1
    res = torch.randn((rows, o), device=dev, generator=gen).bfloat16()
    ln_g = torch.rand(o, device=dev, generator=gen) + 0.5
    ln_b = torch.randn(o, device=dev, generator=gen) * 0.1
    outs = {}
    for which in libs:
        # epilogue 3: scratch for either design (f32 per element, or per row)
        out = torch.zeros((rows, o), device=dev,
                          dtype=torch.float32 if epilogue == 3 else torch.bfloat16)
        outs[which] = (out, torch.zeros((rows, o), device=dev, dtype=torch.int8),
                       torch.zeros((rows, 1), device=dev))
    stream = torch.cuda.current_stream().cuda_stream

    def run(which):
        out, yq, ys = outs[which]
        rc = libs[which].cvt_int8_matmul(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            bias.data_ptr(), res.data_ptr(), out.data_ptr(), rows, k, o,
            epilogue, gelu, ln_g.data_ptr(), ln_b.data_ptr(), 1e-6,
            yq.data_ptr(), ys.data_ptr(), stream)
        _build.check(rc, f"{which}'s int8 GEMM")

    times = in_turns({which: (lambda which=which: run(which)) for which in libs})
    # the scratch of epilogue 3 is not an output
    compared = slice(1, 3) if epilogue == 3 else slice(0, 1 if epilogue < 2 else 3)
    same = all(torch.equal(a, b) for a, b in
               zip(outs["this"][compared], outs["other"][compared]))
    return {"name": name, "shape": [rows, k, o], "ms": times,
            "bit_identical": same}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", required=True,
                        help="the csrc directory of the revision to compare with")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"card": smi, "order": list(_ORDER), "k2": [], "k4": [], "k3": [],
              "gemm": []}
    with tempfile.TemporaryDirectory() as tmp:
        other, old = build_other(args.other_csrc, tmp)
        libs = {"other": other, "this": _build.library()}
        for batch in (args.batch, 64):
            report["k2"].append(k2_ab(libs, batch, gen))
            print("K2", json.dumps(report["k2"][-1]), flush=True)
        for np_, fixed in ((257, False), (257, True), (288, True)):
            report["k4"].append(k4_ab(libs, old["k4_scratch"], args.batch, np_,
                                      fixed, gen))
            print("K4/K5", json.dumps(report["k4"][-1]), flush=True)
        for batch in (args.batch, 64):
            report["k3"].append(k3_ab(libs, old["k3_stats"], batch, gen))
            print("K3", json.dumps(report["k3"][-1]), flush=True)
        for case in _GEMMS:
            report["gemm"].append(gemm_ab(libs, case, args.batch * 257, gen))
            print("GEMM", json.dumps(report["gemm"][-1]), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
