"""Time this checkout's attention and int8 GEMM kernels against another
revision's, in turns on one card, and compare their outputs.

Two revisions compare only inside one process on one card (rates move by
~10% between machines), so this builds the other revision's
``attention.cu``, ``attention_quant.cu``, ``attention_bwd.cu``,
``int8_matmul.cu``, ``fused_block.cu``, ``attention_variants.cu`` and
``rowquant.cu`` (with the headers beside them) into
a second library in a temporary directory, one nvcc process per source, all
started together, and calls both libraries through the same C interface on
the same inputs, at the ViT-B/16 shapes of the serving and training paths.
Sections (``--sections``, all by default):

  k2       attention forward, (batch, 257, 2304) and (64, 257, 2304), 12
           heads: ms in the order other, this, this, other; whether the two
           outputs are equal bit for bit, and their max |difference|
  k4       quantizing attention at (batch, 257, 2304) with the exact row max
           and with a fixed shift; K5, its flat form, at (batch * 288, 2304)
           with 257 real rows an image: ms in the same order, and whether the
           codes and scales equal the other's bit for bit
  k3       attention backward, (batch, 257, 2304) and (64, 257, 2304), 12
           heads: ms in the same order; max |difference| of the two outputs
           and of each against ``reference_attention_bwd``
  variants K10 (residual) and K9 (residual + LN + requant) at the proj
           (768 -> 768) and fc2 (3072 -> 768) shapes at batch * 257 rows,
           through the other revision, this checkout and this checkout's
           ``int8_matmul.cu`` built again as timing-only probes
           (``CVT_GEMM_PROBE``, int8_gemm.cuh), in turns (other, this, each
           probe, each probe backwards, this, other): for K10
           ``probe_b_once`` and ``probe_no_epilogue_io`` (the split kernel
           with its weight tile loaded into each ring stage once, or with no
           residual loads and no x' stores), for K9 ``probe_ln_skipped`` (the
           cluster kernel without the LayerNorm's rows); the probes' outputs
           are not compared, this checkout's must equal the other's bit for
           bit; K9's and K10's routes and ptxas's registers and spills of each
           probe build
  gemm     every epilogue of ``cvt_int8_matmul`` at batch * 257 rows (qkv 768
           -> 2304, proj 768 -> 768 and fc2 3072 -> 768 with residual + LN +
           requant, fc1 768 -> 3072 with GELU + requant, the last fc2 with
           residual): ms in the order other, this, this, other, and whether
           every output equals the other's bit for bit (int32 sums are exact
           in any order, so a main loop may change and the bits may not)
  k14      the whole block at (batch, 257, 768), 12 heads, MLP 3072, random
           int8 weights, with the exact row max and with a fixed shift: ms in
           the same order, beside this checkout's chain of split kernels
           (``quant.block_int8``) timed after them, and whether x_new, yq and
           ys equal the other's bit for bit
  k15      the attention-variant sweep's kernel, each of its 8 variants at
           (batch, 257, 2304) with 12 heads of 64: ms in the order other,
           this, this, other, and whether the codes and scales equal the
           other's bit for bit; then bits alone at ragged shapes (17, 65 and
           300 tokens; 2, 5 and 12 heads; head dims 32 and 64; one and two
           images a block)
  k2f32    the f32 attention forward (``attention_f32.cu``) at (batch, 257,
           2304) and (64, 257, 2304) on f32 inputs: ms in the order other,
           this, this, other; the max |difference| of the two outputs and of
           each against ``reference_attention``
  k3f32    the f32 attention backward, the same shapes, against
           ``reference_attention_bwd``
  k3long   K3's long routes at 577 tokens (a ViT-B/16 at input_size 384),
           12 heads of 64: bf16 at (64, 577, 2304) and f32 at (16, 577,
           2304), each library's ``cvt_attention_bwd_long`` /
           ``cvt_attention_bwd_f32_long`` (whichever source of its csrc
           defines it; an older revision's two-kernel form with its
           statistics scratch, this checkout's on ``long_plan``'s
           clusters): ms in the order other, this, this, other, beside
           ``scaled_dot_product_attention``'s backward on the same values
           and the bound; the max |difference| of the outputs from the
           first's and from ``reference_attention_bwd``, and whether this
           checkout's call is the same twice, bit for bit
  k2any    the any-head-dim forward (``cvt_attention_fwd_any``: the other
           revision's ``attention_any.cu``, this checkout's) on ViT-B/16's
           width at 3 heads of 256 and 64 heads of 12, bf16 and f32, at
           (64, 257, 2304) and (64, 577, 2304): ms in the order other, this,
           this, other, beside ``scaled_dot_product_attention`` on the same
           values and the bound; the outputs' max |difference| from the
           first's and from ``reference_attention``
  k3any    the any-head-dim backward (``cvt_attention_bwd_any``, whichever
           source of a csrc defines it) at the same shapes: an older
           revision's three launches with their statistics scratch (B, H, 3,
           N), this checkout's on ``any_bwd_plan``'s clusters (no scratch in
           one cluster); ms in the same order, SDPA's backward, the bound,
           the max |difference| from the first's and from
           ``reference_attention_bwd``, and whether this checkout's call is
           the same twice, bit for bit. A record of either carries its head
           dim, heads, dtype and this checkout's plan
  legs     the int8 legs (``cvt_attention_quant_i8``: qk_int8, pv_int8
           alone and both) of K4 at (batch, 257, 2304) and of K5 at (batch *
           288, 2304) with 257 real rows an image: ms in the order other,
           this, this, other, the count of codes and of scales that differ
           from the other's, and the bound
  k7       the row quant (``cvt_rowquant``) in every form (none, ln, gelu,
           gelu_sigmoid, gelu_hard) at (batch * 257, 768) and (batch * 257,
           3072): ms in the same order, the counts of differing codes and
           scales, the bound and each time's share of it
  legsprobes  this checkout's ``attention_quant.cu`` built again as
           timing-only probes (``CVT_I8_PROBE``), each running one part of
           the int8 legs twice: ``legs_coding_x2`` (the head's coding pass),
           ``legs_walk1_x2`` (the row max), ``legs_walk2_x2`` (the row sums),
           ``legs_last_walk_x2`` (p and P V), ``legs_epilogue_x2`` (K4's
           epilogue); int8, int8pv and pv only at (batch, 257, 2304), ms in
           the order this, each probe, each probe backwards, this: what a
           probe adds is what its part costs
  longlegsprobes  this checkout's ``attention_quant.cu`` and
           ``attention_quant_long.cu`` built again as timing-only probes of
           the legs' long route (``CVT_I8_PROBE``): ``long_vscale_x2`` (V's
           column scales), ``long_kcode_x2`` (K's coding), ``long_vcode_x2``
           (V's coding), ``long_no_copies`` (the ring's copies after its
           first tiles: the walks run on stale tiles), ``legs_walk1_x2``,
           ``legs_walk2_x2``, ``legs_last_walk_x2`` (each walk twice),
           ``legs_epilogue_x2``; int8, int8pv and pv only on the long route
           at (batch, 1601, 2304), ms in the order this, each probe, each
           probe backwards, this, and the device bytes the design reads a
           call (``attention.i8_long_bytes``)
  k7probes  this checkout's ``rowquant.cu`` built again as timing-only
           probes (``CVT_K7_PROBE``) of the sigmoid GELU form's ring, each
           with one choice changed or one part taken out: ``k7_rows_4``,
           ``k7_rows_8``, ``k7_rows_1`` (rows a warp: 4, 8, or 1 with no
           prefetch; this checkout: 2), ``k7_persistent`` (the resident
           blocks' warps walk all rows at a stride), ``k7_no_recip`` (the
           GELU without its reciprocal); at (batch * 257, 3072), with none at
           3072 and 768 and ln at 768 beside them (forms that do not take the
           ring: the probes leave them as they are), in the order this, each
           probe, each probe backwards, this
  anyprobes  this checkout's ``attention_any.cu`` and ``attention_any_bwd.cu``
           built again as timing-only probes (``CVT_ANY_PROBE``,
           ``attention_any.cuh``'s ``AnyProbe``), each with one part taken
           out: ``any_no_scores`` (the forward's S product, the backward's
           first pass), ``any_no_values`` (P V, the backward's second pass),
           ``any_no_copies`` (every ring stage or tile copy after the first),
           ``any_no_outer`` (dV and dK), ``any_no_dq`` (the dQ product and
           its stores), ``any_no_exchange`` (the cluster barriers and remote
           accesses: the CTA's own), ``any_no_reduce`` (the dQ slices' sum);
           K2 and K3 bf16 at (64, 257, 2304) on 3 heads of 256 and 64 of 12,
           ms in the order this, each probe, each probe backwards, this
  longprobes  this checkout's ``attention_bwd_cluster.cu`` built again as
           timing-only probes (``CVT_LONG_PROBE``, the source's
           ``LongProbe``), each with one part of the bf16 long route taken
           out: ``long_no_pass1`` (S, dP and the warps' statistics),
           ``long_no_pass2`` (S and dP again, pn, dS, dV and dK),
           ``long_no_dq`` (the dQ partial's product), ``long_no_exchange``
           (the cluster barriers and remote reads: the CTA's own instead),
           ``long_no_reduce`` (the dQ partials' sum and stores),
           ``long_no_stats`` (the cluster's row statistics: the CTA's
           own); at (64, 577, 2304), ms in the
           order this, each probe, each probe backwards, this, as
           ``f32probes``
  f32probes  this checkout's ``attention_f32.cu`` built again as timing-only
           probes (``CVT_F32_PROBE``, attention_f32.cuh), each with one part
           of K2 f32 and of K3 f32 taken out, forward / backward:
           ``no_products_1`` the S product / the S and dP products (the
           scores read from the operand instead), ``no_products_2`` the P V
           product / the dV and dK products, ``no_products_3`` - / the dQ
           product, ``no_exchange`` the cluster barrier before the partials'
           reduction (a CTA barrier instead) and the reduction (the
           forward's with its output stores, the backward's loads of the
           partials), ``no_stats`` - / the cluster barrier before the row
           statistics' combine (a CTA barrier; its remote reads stay); at
           (64, 257, 2304), ms in the order this, each probe, each probe
           backwards, this. A probe's outputs are wrong by design and are
           not compared; what it saves against this checkout's time is what
           the part costs on the path (less where another CTA on the SM was
           hiding it)

Usage, from the repository root on a machine with a Hopper GPU:
  git archive REV chess_vision_tpu_torch/csrc | tar -x -C DIR
  python -m chess_vision_tpu_torch.experiments.kernel_ab \\
      --other-csrc DIR/chess_vision_tpu_torch/csrc [--batch 256] \\
      [--sections variants,gemm]

``--any-shapes 257x2x384`` sets k2any's and k3any's (tokens, heads, head
dim) at batch 64 (default: 3 heads of 256 and 64 of 12 at 257 and 577
tokens).
The other revision may have K3's older interface (a statistics scratch as its
fourth pointer), K4's and K5's older one (an f32 (rows, D) scratch as their
second pointer) and K15's (the same scratch as its second pointer); its fc1
epilogue gets an f32 (rows, 3072) scratch either way. The f32 sections read
the other revision's ``attention_f32.cu`` (present since the f32 kernels
were ported) and call its entries by their parameters' names: the two-kernel
backward's statistics scratch, a cluster's CTA count, whichever it takes.
``--head-dims 64,80,128`` runs the sections k2, k3, k2f32, k3f32 and k3long
at each of those head dims on ViT-B/16's width of 768 (6 heads of 128) or,
where 768 does not split, ViT-Huge's 1280 (16 heads of 80); above a head dim
of 64, k3 times the bf16 backward's cluster route at 257 tokens
(``cvt_attention_bwd_long``), as ``bwd_route`` sends it. A record of these
sections carries its head dim.
The first line is the card's name and power limit (nvidia-smi); the last is
one JSON object with every number.
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

from chess_vision_tpu_torch.experiments import attn_variants as av
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

_P = ctypes.c_void_p
_ORDER = ("other", "this", "this", "other")
# (name, K, O, epilogue, gelu) as csrc/int8_matmul.cu numbers them
_GEMMS = (("qkv scale_bias", 768, 2304, 0, 0),
          ("proj res_ln_quant", 768, 768, 2, 0),
          ("fc1 gelu_quant sigmoid", 768, 3072, 3, 1),
          ("fc2 res_ln_quant", 3072, 768, 2, 0),
          ("fc2 res", 3072, 768, 1, 0))


def _params(source: str, name: str) -> list[tuple[str, str]]:
    """(type, name) of each parameter of the C function ``name`` in
    ``source``."""
    text = re.sub(r"//[^\n]*", "", open(source).read())
    params = re.search(rf"{name}\s*\(([^)]*)\)\s*\{{", text).group(1)
    return [tuple(p.strip().rsplit(None, 1)) for p in params.split(",")]


def _param_count(source: str, name: str) -> int:
    return len(_params(source, name))


def c_entry(lib: ctypes.CDLL, source: str, name: str):
    """lib's function ``name`` typed from its definition in ``source``, and
    a call that takes its arguments by their parameters' names."""
    params = _params(source, name)
    fn = getattr(lib, name)
    fn.argtypes = [_P if "*" in kind else ctypes.c_float if kind == "float"
                   else ctypes.c_int for kind, _ in params]

    def call(**values):
        missing = [arg for _, arg in params if arg not in values]
        if missing:
            raise SystemExit(f"{name} in {source} takes {missing}, which "
                             "this tool does not know")
        return fn(*[values[arg] for _, arg in params])
    return call


def build_libs(jobs: dict, out_dir: str) -> tuple[dict, dict]:
    """Build one library per job (name -> (csrc directory, source names,
    extra nvcc flags)), one nvcc process per source, all started together;
    returns name -> library path, and name -> the compiler's output."""
    nvcc = _build.find_nvcc()
    compiles, links, paths, logs = [], [], {}, {}
    for name, (csrc, sources, flags) in jobs.items():
        objs = [os.path.join(out_dir, f"{name}.{src}.o") for src in sources]
        compiles += [[nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", obj,
                      os.path.join(csrc, src)] for obj, src in zip(objs, sources)]
        paths[name] = os.path.join(out_dir, f"lib{name}.so")
        logs[name] = ""
        links.append([nvcc, *_build._ARCH, "-shared", "-o", paths[name], *objs])
    steps = _build._run_all(compiles)
    if all(step.returncode == 0 for step in steps):
        steps += _build._run_all(links)
    for step in steps:
        if step.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(step.args)}\n"
                               f"{step.stdout}\n{step.stderr}")
    for step in steps:
        name = os.path.basename(step.args[step.args.index("-o") + 1])
        name = name[3:-3] if name.startswith("lib") else name.split(".")[0]
        logs[name] += step.stdout + step.stderr
    for step in steps:  # ptxas's registers, spills and warnings of the variants
        if "-D" in " ".join(step.args):
            for line in (step.stdout + step.stderr).splitlines():
                if re.search(r"int8_wgmma|int8_res|registers|spill|warning", line):
                    print("  ptxas " + line.strip(), flush=True)
    return paths, logs


# the attention kernels whose registers and spills are compared across builds
_ATTN_KERNELS = ("attention_fwd_kernel", "attention_quant_kernel",
                 "fused_block_kernel", "attention_variant_kernel",
                 "attention_fwd_f32_kernel", "attention_bwd_f32_kernel",
                 "attention_bwd_dq_f32_kernel", "attention_bwd_dkv_f32_kernel",
                 "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel",
                 "attention_bwd_cluster_kernel", "attention_quant_i8_kernel",
                 "attention_quant_i8_long_kernel")


def ptxas_counts(log: str) -> dict:
    """{kernel<template arguments>: [registers, spill-store bytes]} of the
    attention kernels in a build's ptxas output (the mangled names carry a
    hash of the build's paths, which the keys leave out)."""
    counts = {}
    for block in log.split("Compiling entry function '")[1:]:
        found = re.search(rf"({'|'.join(_ATTN_KERNELS)})((?:ILi\d+E)?(?:L[ib]\d+E)*)",
                          block.split("'")[0])
        spills = re.search(r"(\d+) bytes spill stores", block)
        regs = re.search(r"Used (\d+) registers", block)
        if found and spills and regs:
            args = ",".join(re.findall(r"L[ib](\d+)E", found.group(2)))
            counts[f"{found.group(1)}<{args}>"] = [int(regs.group(1)),
                                                   int(spills.group(1))]
    return counts


def load_other(lib_path: str, csrc: str) -> tuple[ctypes.CDLL, dict]:
    """The other revision's library; which older interfaces it has
    (``k3_stats``: K3 takes the statistics scratch; ``k4_scratch``: K4 and K5
    take the f32 scratch; ``k15_scratch``: K15 takes it; ``i8_no_route``: the
    int8 legs' entry takes no route, the short route its only one;
    ``i8_no_scratch``: it takes no scratch, its long route coding each tile
    as it lands)."""
    quant_src = os.path.join(csrc, "attention_quant.cu")
    old = {"k3_stats": _param_count(os.path.join(csrc, "attention_bwd.cu"),
                                    "cvt_attention_bwd") == 10,
           "k4_scratch": _param_count(quant_src, "cvt_attention_quant") == 12,
           "k15_scratch": _param_count(os.path.join(csrc, "attention_variants.cu"),
                                       "cvt_attention_variant") == 13,
           "i8_no_route": _param_count(quant_src, "cvt_attention_quant_i8") == 11,
           "i8_no_scratch": _param_count(quant_src, "cvt_attention_quant_i8") <= 12}
    lib = ctypes.CDLL(lib_path)
    ints = [ctypes.c_int] * 4
    lib.cvt_attention_bwd.argtypes = [*[_P] * (4 if old["k3_stats"] else 3),
                                      *ints, ctypes.c_float, _P]
    for name in ("cvt_int8_matmul", "cvt_attention_fwd", "cvt_rowquant"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
    i8 = list(_build._SIGNATURES["cvt_attention_quant_i8"])
    if old["i8_no_scratch"]:
        del i8[3]
    if old["i8_no_route"]:
        del i8[-2]
    lib.cvt_attention_quant_i8.argtypes = i8
    extra = [_P] if old["k4_scratch"] else []
    for name in ("cvt_attention_quant", "cvt_attention_quant_flat"):
        getattr(lib, name).argtypes = [*extra, *_build._SIGNATURES[name]]
    lib.cvt_attention_variant.argtypes = [
        *([_P] if old["k15_scratch"] else []),
        *_build._SIGNATURES["cvt_attention_variant"]]
    for name in ("cvt_fused_block", "cvt_fused_block_scratch_bytes"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = _build._RESTYPES.get(name, ctypes.c_int)
    return lib, old


def load_gemm_variant(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.cvt_int8_matmul.argtypes = _build._SIGNATURES["cvt_int8_matmul"]
    return lib


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


def in_turns(runs: dict, order=_ORDER) -> dict:
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_ms(runs[name]))
    return times


def model_heads(dh: int) -> int:
    """Heads of head dim ``dh`` on ViT-B/16's width of 768, or on
    ViT-Huge's 1280 where 768 does not split into them (80: 16 heads)."""
    return 768 // dh if 768 % dh == 0 else 1280 // dh


def k2_ab(libs: dict, batch: int, gen, dh: int = 64) -> dict:
    n, heads = 257, model_heads(dh)
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
    return {"shape": list(qkv.shape), "head_dim": dh, "ms": times,
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
    return {"shape": list(qkv.shape), "head_dim": dh, "ms": times,
            "max_abs_diff": (outs["this"].float()
                             - outs["other"].float()).abs().max().item(),
            "max_abs_err": {name: (out.float() - ref).abs().max().item()
                            for name, out in outs.items()}}


def gemm_operands(rows: int, k: int, o: int, gen) -> dict:
    dev = gen.device
    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    return {"xq": ri(rows, k), "wq": ri(o, k),
            "xs": torch.rand((rows, 1), device=dev, generator=gen) * 0.02 + 0.002,
            "ws": torch.rand(o, device=dev, generator=gen) * 0.0004 + 0.0002,
            "bias": torch.randn(o, device=dev, generator=gen) * 0.1,
            "res": torch.randn((rows, o), device=dev, generator=gen).bfloat16(),
            "ln_g": torch.rand(o, device=dev, generator=gen) + 0.5,
            "ln_b": torch.randn(o, device=dev, generator=gen) * 0.1}


def gemm_call(lib, ops: dict, outs: tuple, epilogue: int, gelu: int,
              what: str) -> None:
    out, yq, ys = outs
    rows, k = ops["xq"].shape
    o = ops["wq"].shape[0]
    rc = lib.cvt_int8_matmul(
        ops["xq"].data_ptr(), ops["xs"].data_ptr(), ops["wq"].data_ptr(),
        ops["ws"].data_ptr(), ops["bias"].data_ptr(), ops["res"].data_ptr(),
        out.data_ptr(), rows, k, o, epilogue, gelu, ops["ln_g"].data_ptr(),
        ops["ln_b"].data_ptr(), 1e-6, yq.data_ptr(), ys.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, what)


def gemm_outputs(rows: int, o: int, epilogue: int, dev) -> tuple:
    # epilogue 3: scratch for either design (f32 per element, or per row)
    return (torch.zeros((rows, o), device=dev,
                        dtype=torch.float32 if epilogue == 3 else torch.bfloat16),
            torch.zeros((rows, o), device=dev, dtype=torch.int8),
            torch.zeros((rows, 1), device=dev))


def gemm_ab(libs: dict, case: tuple, rows: int, gen) -> dict:
    name, k, o, epilogue, gelu = case
    ops = gemm_operands(rows, k, o, gen)
    outs = {which: gemm_outputs(rows, o, epilogue, gen.device) for which in libs}
    times = in_turns({which: (lambda which=which: gemm_call(
        libs[which], ops, outs[which], epilogue, gelu, f"{which}'s int8 GEMM"))
        for which in libs})
    # the scratch of epilogue 3 is not an output
    compared = slice(1, 3) if epilogue == 3 else slice(0, 1 if epilogue < 2 else 3)
    same = all(torch.equal(a, b) for a, b in
               zip(outs["this"][compared], outs["other"][compared]))
    return {"name": name, "shape": [rows, k, o], "ms": times,
            "bit_identical": same}


def variants_ab(libs: dict, variants: dict, rows: int, gen) -> list:
    """K10 (epilogue 1) and K9 (epilogue 2) at the proj (768 -> 768) and fc2
    (3072 -> 768) shapes through the other revision, this checkout and its
    timing-only probe builds (``_PROBES``), in turns: the split-kernel
    probes on K10, the LayerNorm probe on K9. The probes' outputs are not
    compared; this checkout's are, against the other revision's; and the
    routes of this checkout and the cluster probe are printed."""
    report = []
    for name, lib in {"this": libs["this"], **variants}.items():
        if name not in _SPLIT_PROBES:
            lib.cvt_int8_res_route.argtypes = _build._SIGNATURES["cvt_int8_res_route"]
            for epilogue in (2, 1):
                info = (ctypes.c_int * 4)()
                rc = lib.cvt_int8_res_route(768, epilogue, ctypes.addressof(info))
                _build.check(rc, f"{name}'s route query")
                print(f"ROUTE {name} epilogue {epilogue} O=768: "
                      f"{mm.ROUTES[info[0]]}, clusters of {info[1]} blocks, "
                      f"{info[2]} clusters (or blocks) at once, {info[3]} bytes "
                      f"of shared memory a block", flush=True)
    for k, o, epilogue in ((3072, 768, 1), (768, 768, 1), (768, 768, 2),
                           (3072, 768, 2)):
        ops = gemm_operands(rows, k, o, gen)
        here = {name: lib for name, lib in variants.items()
                if (name in _SPLIT_PROBES) == (epilogue == 1)
                or name not in _PROBES}
        runs = {"other": libs["other"], "this": libs["this"], **here}
        outs = {which: gemm_outputs(rows, o, epilogue, gen.device)
                for which in runs}
        order = ["other", "this", *here, *reversed(here), "this", "other"]
        times = in_turns({which: (lambda which=which: gemm_call(
            runs[which], ops, outs[which], epilogue, 0,
            f"{which}'s int8 GEMM")) for which in runs}, order)
        compared = slice(0, 1 if epilogue == 1 else 3)
        same = {which: all(torch.equal(a, b) for a, b in zip(
                    outs[which][compared], outs["other"][compared]))
                for which in runs if which not in _PROBES and which != "other"}
        report.append({"shape": [rows, k, o], "epilogue": epilogue,
                       "order": order, "ms": times,
                       "bit_identical_to_other": same})
        print("VARIANTS", json.dumps(report[-1]), flush=True)
    return report


_LEGS = {"int8": 1, "pv only": 2, "int8pv": 3}


def legs_ab(libs: dict, batch: int, np_: int, legs: str, gen,
            order=_ORDER, no_route: tuple = (), n: int = 257,
            route: str = "short", no_scratch: tuple = ()) -> dict:
    """K4's (np_ = n) or K5's (np_ rows an image, n real) int8 legs,
    ``cvt_attention_quant_i8`` in each library on the same values on
    ``route`` (``no_route`` names the libraries whose entry takes no route:
    the short route, their only one; ``no_scratch`` those that take no
    scratch): ms in turns, the codes and scales that differ from the
    other's (or, of a width variant, from this checkout's), and the bound
    (the larger of the bytes, qkv read once, codes and scales written once,
    and the products: int8 at 1,979 TOP/s, a bf16 leg's at 989 TFLOP/s)."""
    heads, dh = 12, 64
    D = heads * dh
    qkv = torch.randn((batch, np_, 3 * D), device=gen.device,
                      generator=gen).bfloat16()
    outs = {name: (torch.empty((batch, np_, D), device=gen.device,
                               dtype=torch.int8),
                   torch.empty((batch, np_, 1), device=gen.device))
            for name in libs}
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty(batch * heads * attn.i8_long_scratch_bytes(n, dh, _LEGS[legs])
                          if route == "long" else 16, dtype=torch.uint8,
                          device=gen.device)

    def run(name):
        oq, os_ = outs[name]
        how = () if name in no_route else (attn.I8_ROUTES.index(route),)
        where = () if name in no_scratch else (scratch.data_ptr(),)
        rc = libs[name].cvt_attention_quant_i8(
            qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(), *where, batch, np_,
            n, heads, dh, dh ** -0.5, _LEGS[legs], *how, stream)
        _build.check(rc, f"{name}'s int8 legs")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs}, order)
    nbytes = 2 * qkv.numel() + batch * np_ * (D + 4)
    products = 2 * batch * heads * np_ * n * dh  # each of QK^T and P V
    ops_s = (2 * products / 1979e12 if _LEGS[legs] == 3
             else products / 1979e12 + products / 989e12)
    record = {"name": "K4" if np_ == n else "K5", "legs": legs, "route": route,
              "keys": n, "shape": list(qkv.shape), "ms": times,
              "bound_ms": max(nbytes / 3.35e12, ops_s) * 1e3,
              "bound_by": "bytes" if nbytes / 3.35e12 > ops_s else "operations"}
    if "other" in libs:
        record["codes_differ"] = int((outs["this"][0] != outs["other"][0]).sum())
        record["scales_differ"] = int((outs["this"][1] != outs["other"][1]).sum())
    widths = [name for name in libs if name in _I8_LONG_WIDTHS]
    if widths:  # the probes are wrong by design; a width variant is exact
        record["widths_differ"] = {
            name: int((outs[name][0] != outs["this"][0]).sum()
                      + (outs[name][1] != outs["this"][1]).sum()) for name in widths}
    return record


def routes_ab(batch: int, n: int, legs: str, gen) -> dict:
    """This checkout's two routes of the int8 legs on K4 at (batch, n, 2304)
    in turns (short, long, long, short), and whether their codes and scales
    are equal bit for bit."""
    heads, dh = 12, 64
    qkv = torch.randn((batch, n, 3 * heads * dh), device=gen.device,
                      generator=gen).bfloat16()
    outs = {}

    def run(route):
        oq = torch.empty((batch, n, heads * dh), device=gen.device, dtype=torch.int8)
        os_ = torch.empty((batch, n, 1), device=gen.device)
        attn._launch_quant(qkv, oq, os_, batch, n, n, heads, dh, None, "max",
                           bool(_LEGS[legs] & 1), bool(_LEGS[legs] & 2), False,
                           "kernel_ab's int8 legs", route)
        outs[route] = (oq, os_)

    times = in_turns({route: (lambda route=route: run(route)) for route in attn.I8_ROUTES},
                     ("short", "long", "long", "short"))
    same = all(torch.equal(a, b) for a, b in zip(outs["short"], outs["long"]))
    return {"legs": legs, "shape": list(qkv.shape), "ms": times,
            "plan": attn.i8_plan(n, dh, _LEGS[legs])[0], "bit_equal": same}


def k7_ab(libs: dict, rows: int, d: int, mode: str, gen, order=_ORDER) -> dict:
    """K7 (``cvt_rowquant``) in form ``mode`` on bf16 (rows, d) in both
    libraries: ms in turns, the codes and scales that differ from the
    other's, and the bound (bytes: x read once, codes and scales written
    once) with each time's share of it."""
    dev = gen.device
    x = (torch.randn((rows, d), device=dev, generator=gen) * 2).bfloat16()
    g = torch.rand(d, device=dev, generator=gen) + 0.5
    b = torch.randn(d, device=dev, generator=gen) * 0.1
    outs = {name: (torch.empty((rows, d), device=dev, dtype=torch.int8),
                   torch.empty((rows, 1), device=dev)) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        q, s = outs[name]
        rc = libs[name].cvt_rowquant(
            x.data_ptr(), 0, rows, d, rq.MODES[mode], g.data_ptr(),
            b.data_ptr(), 1e-6, q.data_ptr(), s.data_ptr(), stream)
        _build.check(rc, f"{name}'s row quant")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs}, order)
    bound = (3 * rows * d + 4 * rows + 8 * d) / 3.35e12 * 1e3
    record = {"mode": mode, "shape": [rows, d], "ms": times, "bound_ms": bound,
              "share_of_bound": {name: [bound / t for t in ts]
                                 for name, ts in times.items()}}
    if "other" in libs:
        record["codes_differ"] = int((outs["this"][0] != outs["other"][0]).sum())
        record["scales_differ"] = int((outs["this"][1] != outs["other"][1]).sum())
    return record


def k14_ab(libs: dict, batch: int, fixed: bool, gen) -> dict:
    """The whole block on the same values in both libraries, and this
    checkout's split chain on them."""
    n, heads, dh, o1 = 257, 12, 64, 3072
    D = heads * dh
    dev = gen.device

    def dense(k, o):
        return {"wq": torch.randint(-127, 128, (o, k), device=dev, generator=gen,
                                    dtype=torch.int8),
                "scale": torch.rand(o, device=dev, generator=gen) * 4e-4 + 2e-4,
                "bias": torch.randn(o, device=dev, generator=gen) * 0.1}

    def norm():
        return {"scale": torch.rand(D, device=dev, generator=gen) + 0.5,
                "bias": torch.randn(D, device=dev, generator=gen) * 0.1}

    q = {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
         "proj": dense(D, D), "fc1": dense(D, o1), "fc2": dense(o1, D)}
    nxt = norm()
    x = (torch.randn((batch, n, D), device=dev, generator=gen) * 0.5).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"], q["norm1"]["bias"])
    shift = 0.0
    if fixed:  # as calibrate_attn_shifts sets it, from this block's own qkv
        qkv = mm.int8_matmul_scale_bias(xq, xs, q["qkv"]["wq"], q["qkv"]["scale"],
                                        q["qkv"]["bias"])
        qh, kh = qkv[:8].float().reshape(8, n, 3, heads, dh)[:, :, :2].unbind(2)
        shift = torch.einsum("bqhd,bkhd->bhqk", qh, kh).max().item() / 8 - 40
        del qkv, qh, kh
    operands = [t.data_ptr() for t in (
        q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"], q["proj"]["wq"],
        q["proj"]["scale"], q["proj"]["bias"], q["norm2"]["scale"],
        q["norm2"]["bias"], q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"],
        q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"], nxt["scale"],
        nxt["bias"])]
    outs = {name: (torch.empty_like(x), torch.empty_like(xq),
                   torch.empty_like(xs)) for name in libs}
    scratch = {name: torch.empty(
        lib.cvt_fused_block_scratch_bytes(batch * n, D, o1), device=dev,
        dtype=torch.uint8) for name, lib in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        xn, yq, ys = outs[name]
        rc = libs[name].cvt_fused_block(
            xq.data_ptr(), xs.data_ptr(), x.data_ptr(), *operands,
            scratch[name].data_ptr(), xn.data_ptr(), yq.data_ptr(),
            ys.data_ptr(), batch, n, heads, dh, o1, dh ** -0.5, shift,
            int(fixed), 1, 1e-6, None, stream)  # gelu 1: sigmoid
        _build.check(rc, f"{name}'s whole-block kernel")

    times = in_turns({name: (lambda name=name: run(name)) for name in libs})
    split = [cuda_ms(lambda: quant.block_int8(x, xq, xs, q, nxt, heads,
                                              shift if fixed else None))
             for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
    return {"shape": [batch, n, D], "fixed_shift": fixed, "ms": times,
            "split_chain_ms": split, "bit_identical": same}


def k15_ab(libs: dict, k15_scratch: bool, name: str, case: tuple, gen,
           timed: bool = True) -> dict:
    """One variant of the sweep's kernel on the same values in both
    libraries: case (batch, tokens, heads, head dim, images a block); ms in
    turns when ``timed``, and whether the codes and scales are equal."""
    batch, n, heads, dh, bb = case
    D = heads * dh
    qkv = torch.randn((batch, n, 3 * D), device=gen.device,
                      generator=gen).bfloat16()
    outs = {which: (torch.empty((batch, n, D), device=gen.device,
                                dtype=torch.int8),
                    torch.empty((batch, n, 1), device=gen.device))
            for which in libs}
    scratch = torch.empty((batch, n, D), device=gen.device) if k15_scratch else None
    stream = torch.cuda.current_stream().cuda_stream

    def run(which):
        oq, os_ = outs[which]
        extra = [scratch.data_ptr()] if which == "other" and k15_scratch else []
        rc = libs[which].cvt_attention_variant(
            qkv.data_ptr(), *extra, oq.data_ptr(), os_.data_ptr(),
            av.VARIANTS[name], batch, n, heads, dh, bb, dh ** -0.5,
            av._fold(name, dh), stream)
        _build.check(rc, f"{which}'s attention variant {name}")

    runs = {which: (lambda which=which: run(which)) for which in libs}
    if timed:
        times = in_turns(runs)
    else:
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        times = None
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
    return {"variant": name, "shape": [batch, n, 3 * D], "heads": heads,
            "bb": bb, "ms": times, "bit_identical": same}


_LONG_ENTRIES = ("cvt_attention_bwd_long", "cvt_attention_bwd_f32_long")


def _defining_source(csrc: str, name: str) -> str:
    """The ``.cu`` file of ``csrc`` that defines the C function ``name``."""
    for source in sorted(os.listdir(csrc)):
        if source.endswith(".cu") and re.search(
                rf'extern "C" int {name}\(', open(os.path.join(csrc, source)).read()):
            return os.path.join(csrc, source)
    raise SystemExit(f"no source of {csrc} defines {name}")


def long_entries(lib: ctypes.CDLL, csrc: str) -> dict:
    """K3's long-route entries of a library built from ``csrc``: name ->
    (call by parameter names, the parameters' names)."""
    out = {}
    for name in _LONG_ENTRIES:
        source = _defining_source(csrc, name)
        out[name] = (c_entry(lib, source, name),
                     {arg for _, arg in _params(source, name)})
    return out


def sdpa_bwd_ms(qkv: torch.Tensor, g: torch.Tensor, heads: int) -> float:
    """``scaled_dot_product_attention``'s backward alone on contiguous
    (B, H, N, Dh) copies of the same q, k, v and cotangent: the library
    yardstick of K3, which the port never calls."""
    B, n, C3 = qkv.shape
    dh = C3 // 3 // heads
    q, k, v = (t.permute(0, 2, 1, 3).contiguous().requires_grad_()
               for t in qkv.reshape(B, n, 3, heads, dh).unbind(2))
    go = g.reshape(B, n, heads, dh).permute(0, 2, 1, 3).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), go,
                                               retain_graph=True))


def k3long_ab(entries: dict, dtype: torch.dtype, batch: int, gen,
              order=_ORDER, n: int = 577, dh: int = 64) -> dict:
    """K3's long route of ``dtype`` of each of ``entries`` (name ->
    ``long_entries``) at (batch, n, 3 D), ``model_heads(dh)`` heads (577
    tokens, 12 heads of 64 by default): ms in ``order``, SDPA's backward,
    the bound, and the outputs' max |difference| from the first entry's and
    from the plain version's."""
    heads = model_heads(dh)
    qkv = torch.randn((batch, n, 3 * heads * dh), device=gen.device,
                      generator=gen).to(dtype)
    g = torch.randn((batch, n, heads * dh), device=gen.device,
                    generator=gen).to(dtype)
    f32 = dtype == torch.float32
    name = _LONG_ENTRIES[f32]
    clusters, ctas, warps = attn.long_plan(n, dtype, dh)
    scratch = dict(dtype=torch.float32, device=qkv.device)
    old_stats = torch.empty((batch, heads, 3, n), **scratch)
    split = ([torch.empty((batch, heads, clusters, 3, n), **scratch),
              torch.empty((batch, heads, clusters, n, dh), **scratch)]
             if clusters > 1 else None)
    outs = {who: torch.empty_like(qkv) for who in entries}

    def run(who):
        call, params = entries[who][name]
        args = {"qkv": qkv.data_ptr(), "grad": g.data_ptr(),
                "dqkv": outs[who].data_ptr(), "batch": batch, "n": n,
                "heads": heads, "head_dim": dh, "scale": dh ** -0.5,
                "stream": torch.cuda.current_stream().cuda_stream}
        if "clusters" in params:  # this design: the plan, no scratch in one cluster
            args.update(stats=split and split[0].data_ptr(),
                        dq_parts=split and split[1].data_ptr(),
                        clusters=clusters, ctas=ctas, warps=warps)
        else:  # the two-kernel design's statistics scratch
            args["stats"] = old_stats.data_ptr()
        _build.check(call(**args), f"{who}'s {name}")

    times = in_turns({who: (lambda who=who: run(who)) for who in entries}, order)
    again = outs["this"].clone()
    run("this")
    torch.cuda.synchronize()
    ref = attn.reference_attention_bwd(qkv, g, heads)
    first = outs[order[0]]
    ops = 10 * batch * heads * n * n * dh
    nbytes = qkv.element_size() * (2 * qkv.numel() + g.numel())
    bound = max(nbytes / 3.35e12, ops / (67e12 if f32 else 989e12)) * 1e3
    return {"dtype": str(dtype).removeprefix("torch."), "shape": list(qkv.shape),
            "head_dim": dh, "plan": [clusters, ctas, warps], "ms": times,
            "sdpa_bwd_ms": sdpa_bwd_ms(qkv, g, heads), "bound_ms": bound,
            "bound_by": "operations" if ops / (67e12 if f32 else 989e12)
            > nbytes / 3.35e12 else "bytes",
            "max_abs_diff": {who: (out.float() - first.float()).abs().max().item()
                             for who, out in outs.items()},
            "max_abs_err": {who: (out.float() - ref.float()).abs().max().item()
                            for who, out in outs.items()},
            "this_bit_identical_twice": torch.equal(again, outs["this"])}


_ANY_ENTRIES = ("cvt_attention_fwd_any", "cvt_attention_bwd_any")
# (tokens, heads, head dim) of k2any and k3any, at batch 64
_ANY_SHAPES = ((257, 3, 256), (257, 64, 12), (577, 3, 256), (577, 64, 12))


def any_entries(lib: ctypes.CDLL, csrc: str) -> dict:
    """The any-head-dim entries of a library built from ``csrc``: name ->
    (call by parameter names, the parameters' names)."""
    return {name: (c_entry(lib, _defining_source(csrc, name), name),
                   {arg for _, arg in _params(_defining_source(csrc, name), name)})
            for name in _ANY_ENTRIES}


def sdpa_backend(qkv: torch.Tensor, heads: int) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these values
    (PyTorch's own choice, ``torch._fused_sdp_choice``)."""
    B, n, C3 = qkv.shape
    q, k, v = (t.permute(0, 2, 1, 3).contiguous()
               for t in qkv.reshape(B, n, 3, heads, C3 // 3 // heads).unbind(2))
    return torch.nn.attention.SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def sdpa_fwd_ms(qkv: torch.Tensor, heads: int) -> float:
    """``scaled_dot_product_attention`` alone on contiguous (B, H, N, Dh)
    copies of the same q, k and v: the library yardstick of K2."""
    B, n, C3 = qkv.shape
    q, k, v = (t.permute(0, 2, 1, 3).contiguous()
               for t in qkv.reshape(B, n, 3, heads, C3 // 3 // heads).unbind(2))
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))


def any_ab(entries: dict, backward: bool, dtype: torch.dtype, shape: tuple,
           gen, batch: int = 64, order=_ORDER) -> dict:
    """K2 (or K3) on the any-head-dim route of each of ``entries`` (who ->
    ``any_entries``) at (batch, n, 3 heads dh): ms in ``order``, SDPA's
    time, the bound, and the outputs' max |difference| from the first's and
    from the plain version's."""
    n, heads, dh = shape
    qkv = torch.randn((batch, n, 3 * heads * dh), device=gen.device,
                      generator=gen).to(dtype)
    g = torch.randn((batch, n, heads * dh), device=gen.device,
                    generator=gen).to(dtype)
    f32 = dtype == torch.float32
    clusters, ctas, keys = attn.any_bwd_plan(n, dh)
    scratch = dict(dtype=torch.float32, device=qkv.device)
    old_stats = torch.empty((batch, heads, 3, n), **scratch)
    chunks = attn.any_plan(dh)[0]
    split = ([torch.empty((batch, heads * chunks, clusters, 3, n), **scratch),
              torch.empty((batch, heads, clusters, n, dh), **scratch)]
             if clusters > 1 else None)
    outs = {who: torch.empty_like(qkv if backward else g) for who in entries}
    name = _ANY_ENTRIES[backward]

    def run(who):
        call, params = entries[who][name]
        args = {"qkv": qkv.data_ptr(), "batch": batch, "n": n, "heads": heads,
                "head_dim": dh, "f32": int(f32), "scale": dh ** -0.5,
                "stream": torch.cuda.current_stream().cuda_stream}
        if not backward:
            args["out"] = outs[who].data_ptr()
        elif "clusters" in params:  # this design: the plan, no scratch in one cluster
            args.update(grad=g.data_ptr(), dqkv=outs[who].data_ptr(),
                        stats=split and split[0].data_ptr(),
                        dq_parts=split and split[1].data_ptr(),
                        clusters=clusters, ctas=ctas, keys=keys)
        else:  # the three-launch design's statistics scratch
            args.update(grad=g.data_ptr(), dqkv=outs[who].data_ptr(),
                        stats=old_stats.data_ptr())
        _build.check(call(**args), f"{who}'s {name}")

    times = in_turns({who: (lambda who=who: run(who)) for who in entries}, order)
    again = outs["this"].clone()
    run("this")
    torch.cuda.synchronize()
    ref = (attn.reference_attention_bwd(qkv, g, heads) if backward
           else attn.reference_attention(qkv, heads))
    first = outs[order[0]]
    ops = (10 if backward else 4) * batch * heads * n * n * dh
    nbytes = qkv.element_size() * (2 * qkv.numel() + g.numel() if backward
                                   else qkv.numel() + g.numel())
    peak = 67e12 if f32 else 989e12
    return {"dtype": str(dtype).removeprefix("torch."), "shape": list(qkv.shape),
            "heads": heads, "head_dim": dh,
            "plan": {"chunks_cols": list(attn.any_plan(dh)),
                     "backward_clusters_ctas_keys": [clusters, ctas, keys]},
            "ms": times,
            "sdpa_ms": sdpa_bwd_ms(qkv, g, heads) if backward else sdpa_fwd_ms(qkv, heads),
            "sdpa_backend": sdpa_backend(qkv, heads),
            "bound_ms": max(nbytes / 3.35e12, ops / peak) * 1e3,
            "bound_by": "operations" if ops / peak > nbytes / 3.35e12 else "bytes",
            "max_abs_diff": {who: (out.float() - first.float()).abs().max().item()
                             for who, out in outs.items()},
            "max_abs_err": {who: (out.float() - ref.float()).abs().max().item()
                            for who, out in outs.items()},
            "this_bit_identical_twice": torch.equal(again, outs["this"])}


def f32_entries(lib: ctypes.CDLL, csrc: str) -> tuple:
    """The f32 forward and backward entries of a library built from
    ``csrc``'s ``attention_f32.cu``, called by parameter names."""
    source = os.path.join(csrc, "attention_f32.cu")
    return (c_entry(lib, source, "cvt_attention_fwd_f32"),
            c_entry(lib, source, "cvt_attention_bwd_f32"))


def f32_args(qkv: torch.Tensor, heads: int) -> dict:
    """The arguments the f32 entries may take for ``qkv``, by name, as
    ``ops/attention``'s wrappers pass them."""
    B, n, C3 = qkv.shape
    dh = C3 // 3 // heads
    scale = dh ** -0.5
    q_scale, s_scale = (scale, 1.0) if attn._pow2(scale) else (1.0, scale)
    stats = torch.empty((B, heads, 3, n), device=qkv.device)
    return {"qkv": qkv.data_ptr(), "batch": B, "n": n, "heads": heads,
            "head_dim": dh, "q_scale": q_scale, "s_scale": s_scale,
            "scale": scale, "stats": stats.data_ptr(), "_stats": stats,
            "stream": torch.cuda.current_stream().cuda_stream}


def f32_ab(entries: dict, backward: bool, batch: int, gen,
           order=_ORDER, dh: int = 64) -> dict:
    """K2 f32 (or K3 f32) of each of ``entries`` (name -> (forward,
    backward)) on the same f32 inputs at (batch, 257, 3 D),
    ``model_heads(dh)`` heads (12 of 64 by default): ms in ``order``, and
    each output's max |difference| from the first entry's and from the
    plain version's."""
    n, heads = 257, model_heads(dh)
    qkv = torch.randn((batch, n, 3 * heads * dh), device=gen.device, generator=gen)
    g = torch.randn((batch, n, heads * dh), device=gen.device, generator=gen)
    args = f32_args(qkv, heads)
    args["grad"] = g.data_ptr()
    args["ctas"] = attn.f32_plan(n, backward=backward, head_dim=dh)[1]
    outs = {name: torch.empty_like(qkv if backward else g) for name in entries}

    def run(name):
        fwd, bwd = entries[name]
        where = {"dqkv": outs[name].data_ptr()} if backward else {
            "out": outs[name].data_ptr()}
        rc = (bwd if backward else fwd)(**args, **where)
        _build.check(rc, f"{name}'s f32 attention {'backward' if backward else 'forward'}")

    times = in_turns({name: (lambda name=name: run(name)) for name in entries},
                     order)
    ref = (attn.reference_attention_bwd(qkv, g, heads) if backward
           else attn.reference_attention(qkv, heads))
    first = outs[order[0]]
    return {"shape": list(qkv.shape), "head_dim": dh, "ms": times,
            "max_abs_diff": {name: (out - first).abs().max().item()
                             for name, out in outs.items()},
            "max_abs_err": {name: (out - ref).abs().max().item()
                            for name, out in outs.items()}}


_SECTIONS = ("k2", "k4", "k3", "variants", "gemm", "k14", "k15", "k2f32",
             "k3f32", "k3long", "k2any", "k3any", "longprobes", "f32probes",
             "anyprobes", "legs", "k7", "legsprobes", "longlegsprobes",
             "k7probes")
_OTHER_SOURCES = ("attention.cu", "attention_quant.cu", "attention_bwd.cu",
                  "int8_matmul.cu", "fused_block.cu", "attention_variants.cu",
                  "rowquant.cu")
# (batch, tokens, heads, head dim, images a block) of k15's bits-only cases
_K15_RAGGED = ((2, 17, 2, 32, 1), (4, 65, 5, 64, 2), (2, 300, 12, 64, 2),
               (3, 257, 2, 32, 1))
# this checkout's int8_matmul.cu built with timing-only macros (int8_gemm.cuh)
_PROBES = {"probe_b_once": ["-DCVT_GEMM_PROBE=1"],
           "probe_no_epilogue_io": ["-DCVT_GEMM_PROBE=2"],
           "probe_ln_skipped": ["-DCVT_GEMM_PROBE=3"]}
# the probes that time the split kernel (K10's shape only)
_SPLIT_PROBES = ("probe_b_once", "probe_no_epilogue_io")
# this checkout's attention_f32.cu built with timing-only macros
# (attention_f32.cuh's Probe)
# this checkout's attention_bwd_cluster.cu built with timing-only macros
# (its LongProbe)
_LONG_PROBES = {"long_no_pass1": 1, "long_no_pass2": 2, "long_no_dq": 3,
                "long_no_exchange": 4, "long_no_reduce": 5, "long_no_stats": 6}
_F32_PROBES = {"no_products_1": 1, "no_products_2": 2, "no_products_3": 3,
               "no_exchange": 4, "no_stats": 5}
# this checkout's attention_any.cu and attention_any_bwd.cu built with
# timing-only macros (attention_any.cuh's AnyProbe)
# this checkout's attention_quant.cu and rowquant.cu built with timing-only
# macros (CVT_I8_PROBE: one part of the int8 legs run twice; CVT_K7_PROBE:
# one part of K7 taken out)
_I8_PROBES = {"legs_coding_x2": 1, "legs_walk1_x2": 2, "legs_walk2_x2": 3,
              "legs_last_walk_x2": 4, "legs_epilogue_x2": 5}
# the long route's probes (the walks' and the epilogue's numbers as above)
_I8_LONG_PROBES = {"long_vscale_x2": 6, "long_kcode_x2": 7, "long_vcode_x2": 8,
                   "long_no_copies": 9, "legs_walk1_x2": 2, "legs_walk2_x2": 3,
                   "legs_last_walk_x2": 4, "legs_epilogue_x2": 5}
# the long route built at other block widths (CVT_I8_LONG_WARPS; probe 10
# changes nothing and builds head dim 64 alone): exact, timed beside it
_I8_LONG_WIDTHS = {"long_w3": 3, "long_w6": 6, "long_w12": 12}
_K7_PROBES = {"k7_rows_4": 1, "k7_rows_8": 2, "k7_rows_1": 3,
              "k7_persistent": 4, "k7_no_recip": 5}
_ANY_PROBES = {"any_no_scores": 1, "any_no_values": 2, "any_no_copies": 3,
               "any_no_outer": 4, "any_no_dq": 5, "any_no_exchange": 6,
               "any_no_reduce": 7}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", required=True,
                        help="the csrc directory of the revision to compare with")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sections", default=",".join(_SECTIONS),
                        help=f"comma-separated subset of {','.join(_SECTIONS)}")
    parser.add_argument("--head-dims", default="64",
                        help="comma-separated head dims of the sections k2, "
                             "k3, k2f32, k3f32 and k3long")
    parser.add_argument("--route-keys", default="257,960,1504",
                        help="comma-separated key counts at which the legs "
                             "section times this checkout's two routes")
    parser.add_argument("--any-shapes", default=None,
                        help="comma-separated TOKENSxHEADSxHEAD_DIM of the "
                             "sections k2any and k3any (batch 64)")
    args = parser.parse_args()
    dims = [int(d) for d in args.head_dims.split(",")]
    any_shapes = (tuple(tuple(int(x) for x in shape.split("x"))
                        for shape in args.any_shapes.split(","))
                  if args.any_shapes else _ANY_SHAPES)
    sections = args.sections.split(",")
    if not set(sections) <= set(_SECTIONS):
        raise SystemExit(f"unknown sections {sections}; expected {_SECTIONS}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"card": smi, "order": list(_ORDER),
              **{name: [] for name in _SECTIONS}}
    with tempfile.TemporaryDirectory() as tmp:
        f32 = {"k2f32", "k3f32"} & set(sections)
        sources = list(_OTHER_SOURCES) + (["attention_f32.cu"] if f32 else [])
        if os.path.exists(os.path.join(args.other_csrc, "attention_quant_long.cu")):
            sources.append("attention_quant_long.cu")  # the int8 legs' long route
        if "k3long" in sections or ("k3" in sections and set(dims) != {64}):
            sources += [os.path.basename(_defining_source(args.other_csrc, name))
                        for name in _LONG_ENTRIES]
        if {"k2any", "k3any"} & set(sections):
            sources += [os.path.basename(_defining_source(args.other_csrc, name))
                        for name in _ANY_ENTRIES]
        jobs = {"other": (args.other_csrc, tuple(dict.fromkeys(sources)), [])}
        if "variants" in sections:
            jobs.update({name: (_build.CSRC_DIR, ("int8_matmul.cu",), flags)
                         for name, flags in _PROBES.items()})
        if "longprobes" in sections:
            jobs.update({name: (_build.CSRC_DIR, ("attention_bwd_cluster.cu",),
                                [f"-DCVT_LONG_PROBE={number}"])
                         for name, number in _LONG_PROBES.items()})
        if "f32probes" in sections:
            jobs.update({name: (_build.CSRC_DIR, ("attention_f32.cu",),
                                [f"-DCVT_F32_PROBE={number}"])
                         for name, number in _F32_PROBES.items()})
        i8_probes = {**(_I8_PROBES if "legsprobes" in sections else {}),
                     **(_I8_LONG_PROBES if "longlegsprobes" in sections else {})}
        jobs.update({name: (_build.CSRC_DIR,
                            ("attention_quant.cu", "attention_quant_long.cu"),
                            [f"-DCVT_I8_PROBE={number}"])
                     for name, number in i8_probes.items()})
        if "longlegsprobes" in sections:
            jobs.update({name: (_build.CSRC_DIR,
                                ("attention_quant.cu", "attention_quant_long.cu"),
                                ["-DCVT_I8_PROBE=10", f"-DCVT_I8_LONG_WARPS={warps}"])
                         for name, warps in _I8_LONG_WIDTHS.items()})
        if "k7probes" in sections:
            jobs.update({name: (_build.CSRC_DIR, ("rowquant.cu",),
                                [f"-DCVT_K7_PROBE={number}"])
                         for name, number in _K7_PROBES.items()})
        if "anyprobes" in sections:
            jobs.update({name: (_build.CSRC_DIR, ("attention_any.cu", "attention_any_bwd.cu"),
                                [f"-DCVT_ANY_PROBE={number}"])
                         for name, number in _ANY_PROBES.items()})
        paths, logs = build_libs(jobs, tmp)
        other, old = load_other(paths.pop("other"), args.other_csrc)
        libs = {"other": other, "this": _build.library()}
        report["ptxas"] = {"other": ptxas_counts(logs["other"]),
                           "this": ptxas_counts(_build.build_log)}
        for name in sorted(set(report["ptxas"]["other"]) | set(report["ptxas"]["this"])):
            print(f"PTXAS {name}: other {report['ptxas']['other'].get(name)}, "
                  f"this {report['ptxas']['this'].get(name)} "
                  "([registers, spill-store bytes])", flush=True)
        f32_probes = {name: f32_entries(ctypes.CDLL(paths.pop(name)), _build.CSRC_DIR)
                      for name in _F32_PROBES if name in paths}
        cluster_src = os.path.join(_build.CSRC_DIR, "attention_bwd_cluster.cu")
        long_probes = {name: {_LONG_ENTRIES[0]: (
            c_entry(ctypes.CDLL(paths.pop(name)), cluster_src, _LONG_ENTRIES[0]),
            {arg for _, arg in _params(cluster_src, _LONG_ENTRIES[0])})}
            for name in _LONG_PROBES if name in paths}
        any_probes = {name: any_entries(ctypes.CDLL(paths.pop(name)), _build.CSRC_DIR)
                      for name in _ANY_PROBES if name in paths}
        probe_libs = {}
        for name in (*_I8_PROBES, *_I8_LONG_PROBES, *_I8_LONG_WIDTHS, *_K7_PROBES):
            if name in paths:
                probe_libs[name] = ctypes.CDLL(paths.pop(name))
                entry = "cvt_rowquant" if name in _K7_PROBES else "cvt_attention_quant_i8"
                getattr(probe_libs[name], entry).argtypes = _build._SIGNATURES[entry]
        variants = {name: load_gemm_variant(path) for name, path in paths.items()}
        rows = args.batch * 257
        for dh in dims if "k2" in sections else ():
            for batch in (args.batch, 64):
                report["k2"].append(k2_ab(libs, batch, gen, dh))
                print("K2", json.dumps(report["k2"][-1]), flush=True)
        if "k4" in sections:
            for np_, fixed in ((257, False), (257, True), (288, True)):
                report["k4"].append(k4_ab(libs, old["k4_scratch"], args.batch,
                                          np_, fixed, gen))
                print("K4/K5", json.dumps(report["k4"][-1]), flush=True)
        for dh in dims if "k3" in sections else ():
            for batch in (args.batch, 64):
                if dh == 64:
                    record = k3_ab(libs, old["k3_stats"], batch, gen)
                else:  # the cluster route, as bwd_route sends it above 64
                    both = {"this": long_entries(libs["this"], _build.CSRC_DIR),
                            "other": long_entries(other, args.other_csrc)}
                    record = k3long_ab(both, torch.bfloat16, batch, gen, n=257,
                                       dh=dh)
                report["k3"].append(record)
                print("K3", json.dumps(report["k3"][-1]), flush=True)
        if "variants" in sections:
            report["variants"] = variants_ab(libs, variants, rows, gen)
        if "gemm" in sections:
            for case in _GEMMS:
                report["gemm"].append(gemm_ab(libs, case, rows, gen))
                print("GEMM", json.dumps(report["gemm"][-1]), flush=True)
        if "k14" in sections:
            for fixed in (False, True):
                report["k14"].append(k14_ab(libs, args.batch, fixed, gen))
                print("K14", json.dumps(report["k14"][-1]), flush=True)
        if "legs" in sections:
            # the short route at 257 tokens (K5: 288 rows, 257 real), the
            # long route at 1,601 (K5: 1,632 rows), then this checkout's two
            # routes in turns where both take a head
            for n, np_, route in ((257, 257, "short"), (257, 288, "short"),
                                  (1601, 1601, "long"), (1601, 1632, "long")):
                for legs in _LEGS:
                    report["legs"].append(legs_ab(
                        libs, args.batch, np_, legs, gen, n=n, route=route,
                        no_route=("other",) if old["i8_no_route"] else (),
                        no_scratch=("other",) if old["i8_no_scratch"] else ()))
                    print("LEGS", json.dumps(report["legs"][-1]), flush=True)
            for n in (int(k) for k in args.route_keys.split(",")):
                for legs in _LEGS:
                    if not attn.i8_short_fits(n, 64, _LEGS[legs]):
                        continue
                    report["legs"].append(routes_ab(args.batch, n, legs, gen))
                    print("ROUTES", json.dumps(report["legs"][-1]), flush=True)
        if "k7" in sections:
            for d in (768, 3072):
                for mode in rq.MODES:
                    report["k7"].append(k7_ab(libs, rows, d, mode, gen))
                    print("K7", json.dumps(report["k7"][-1]), flush=True)
        if "legsprobes" in sections:
            order = ["this", *_I8_PROBES, *reversed(_I8_PROBES), "this"]
            both = {"this": libs["this"], **{k: probe_libs[k] for k in _I8_PROBES}}
            for legs in ("int8", "int8pv", "pv only"):
                report["legsprobes"].append(
                    {"order": order, **legs_ab(both, args.batch, 257, legs, gen, order)})
                print("LEGSPROBES", json.dumps(report["legsprobes"][-1]), flush=True)
        if "longlegsprobes" in sections:
            names = [*_I8_LONG_PROBES, *_I8_LONG_WIDTHS]
            order = ["this", *names, *reversed(names), "this"]
            both = {"this": libs["this"], **{k: probe_libs[k] for k in names}}
            n = 1601  # ViT-B/16 at 640 px
            for legs in ("int8", "int8pv", "pv only"):
                report["longlegsprobes"].append(
                    {"order": order,
                     "device_bytes": attn.i8_long_bytes(args.batch, n, n, 12, 64,
                                                        _LEGS[legs]),
                     **legs_ab(both, args.batch, n, legs, gen, order, n=n,
                               route="long")})
                print("LONGLEGSPROBES", json.dumps(report["longlegsprobes"][-1]),
                      flush=True)
        if "k7probes" in sections:
            order = ["this", *_K7_PROBES, *reversed(_K7_PROBES), "this"]
            both = {"this": libs["this"], **{k: probe_libs[k] for k in _K7_PROBES}}
            for d, mode in ((3072, "gelu_sigmoid"), (3072, "none"), (768, "none"),
                            (768, "ln")):
                report["k7probes"].append(
                    {"order": order, **k7_ab(both, rows, d, mode, gen, order)})
                print("K7PROBES", json.dumps(report["k7probes"][-1]), flush=True)
        if "k15" in sections:
            for name in av.VARIANTS:
                report["k15"].append(k15_ab(libs, old["k15_scratch"], name,
                                            (args.batch, 257, 12, 64, 1), gen))
                print("K15", json.dumps(report["k15"][-1]), flush=True)
            for case in _K15_RAGGED:
                same = {name: k15_ab(libs, old["k15_scratch"], name, case, gen,
                                     timed=False)["bit_identical"]
                        for name in av.VARIANTS}
                report["k15"].append({"shape": list(case), "bit_identical": same})
                print("K15", json.dumps(report["k15"][-1]), flush=True)
        entries = {"this": f32_entries(libs["this"], _build.CSRC_DIR)}
        if f32:
            entries["other"] = f32_entries(other, args.other_csrc)
        for section in ("k2f32", "k3f32"):
            for dh in dims if section in sections else ():
                for batch in (args.batch, 64):
                    report[section].append(f32_ab(entries, section == "k3f32",
                                                  batch, gen, dh=dh))
                    print(section.upper(), json.dumps(report[section][-1]),
                          flush=True)
        for dh in dims if "k3long" in sections else ():
            both = {"this": long_entries(libs["this"], _build.CSRC_DIR),
                    "other": long_entries(other, args.other_csrc)}
            for dtype, batch in ((torch.bfloat16, 64), (torch.float32, 16)):
                report["k3long"].append(k3long_ab(both, dtype, batch, gen,
                                                  dh=dh))
                print("K3LONG", json.dumps(report["k3long"][-1]), flush=True)
        if {"k2any", "k3any"} & set(sections):
            both = {"this": any_entries(libs["this"], _build.CSRC_DIR),
                    "other": any_entries(other, args.other_csrc)}
            for section in ("k2any", "k3any"):
                for shape in any_shapes if section in sections else ():
                    for dtype in (torch.bfloat16, torch.float32):
                        report[section].append(any_ab(both, section == "k3any",
                                                      dtype, shape, gen))
                        print(section.upper(), json.dumps(report[section][-1]),
                              flush=True)
                        torch.cuda.empty_cache()
        if "longprobes" in sections:
            order = ["this", *_LONG_PROBES, *reversed(_LONG_PROBES), "this"]
            both = {"this": long_entries(libs["this"], _build.CSRC_DIR), **long_probes}
            report["longprobes"].append(
                {"order": order, **k3long_ab(both, torch.bfloat16, 64, gen, order)})
            print("LONGPROBES", json.dumps(report["longprobes"][-1]), flush=True)
        if "anyprobes" in sections:
            order = ["this", *_ANY_PROBES, *reversed(_ANY_PROBES), "this"]
            both = {"this": any_entries(libs["this"], _build.CSRC_DIR), **any_probes}
            for backward in (False, True):
                for shape in _ANY_SHAPES[:2]:
                    report["anyprobes"].append(
                        {"backward": backward, "order": order,
                         **any_ab(both, backward, torch.bfloat16, shape, gen, order=order)})
                    print("ANYPROBES", json.dumps(report["anyprobes"][-1]), flush=True)
        if "f32probes" in sections:
            order = ["this", *_F32_PROBES, *reversed(_F32_PROBES), "this"]
            both = {"this": entries["this"], **f32_probes}
            for backward in (False, True):
                report["f32probes"].append(
                    {"backward": backward, "order": order,
                     **f32_ab(both, backward, 64, gen, order)})
                print("F32PROBES", json.dumps(report["f32probes"][-1]), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
