"""Sweep attention-kernel variants on the GPU (serving shapes).

Counterpart of ``experiments/attn_variants.py`` (K15): the quantizing
attention with eight ways of doing the softmax's scale, shift and
exponential, each a template instance of ``csrc/attention_variants.cu``:

  base       scores multiplied by the scale in f32, row max, exp
  foldscale  the scale folded into q (in bf16) instead
  noshift    foldscale with the fixed shift 24 and no max pass
  noexp      foldscale with p = s - max: no exponential, a cost probe
  fexp       scale * log2(e) folded into q; 2^t by a cubic on the fraction
             spliced with the exponent bits
  fexp_ns    fexp with the fixed shift 110
  bf16s      foldscale with the scores rounded to bf16 and max, subtraction
             and exp in bf16
  normbound  foldscale with the per-row shift sqrt(|q_i|^2 max_j |k_j|^2) - 40

The kernel runs the quantizing attention's loop (``csrc/attention_loop.cuh``)
with each variant's row statistic fixed before its walk over the keys, and
its blocks of a row chunk's heads form a thread-block cluster that exchanges
the per-token row maxima on chip: one launch, no f32 scratch, at most
``MAX_HEADS`` heads.

``normbound_bd`` exists in the JAX script but raises ``NameError`` when it
is traced (it appends to a list that is never defined), so it has nothing to
be held against and is not ported. ``score_range``, the JAX script's other
mode, is plain JAX on a trained checkpoint and is not a kernel.

Usage:
  python -m chess_vision_tpu_torch.experiments.attn_variants sweep [batch]
"""

from __future__ import annotations

import math
import sys

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops.rowquant import quantize_rows
from chess_vision_tpu_torch.utils.device import resolve_device

# name -> the kernel's Variant enum (csrc/attention_variants.cu)
VARIANTS = {"base": 0, "foldscale": 1, "noshift": 2, "noexp": 3, "fexp": 4,
            "fexp_ns": 5, "bf16s": 6, "normbound": 7}
# Kernel launches per variant since the last reset (chip_smoke.py proves the
# sweep went through the kernel with them).
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_LOG2E = 1.4426950408889634
_SHIFT = 24.0       # noshift
_SHIFT_EXP2 = 110.0  # fexp_ns
_HEAD_DIMS = (32, 64)  # instantiations in csrc/attention_variants.cu
MAX_HEADS = 16  # kMaxHeads in csrc/attention_variants.cu: one cluster's blocks


def _check_name(name: str) -> None:
    if name == "normbound_bd":
        raise ValueError(
            "variant 'normbound_bd' is not ported: the JAX kernel raises "
            "NameError when traced, so it defines no result")
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; expected one of "
                         f"{list(VARIANTS)}")


def _fold(name: str, head_dim: int) -> float:
    """The factor a variant multiplies q by, rounded to bf16 as
    ``jnp.asarray(fold, q.dtype)`` rounds it."""
    scale = 1.0 / math.sqrt(head_dim)
    fold = scale * _LOG2E if "fexp" in name else scale
    return torch.tensor(fold, dtype=torch.bfloat16).item()


def _fastexp2(t: torch.Tensor) -> torch.Tensor:
    """2^t via a cubic on the fraction and an exponent-bit splice."""
    t = t.clamp(-120.0, 120.0)
    i = torch.floor(t)
    f = t - i
    p = 1.0 + f * (0.6931471 + f * (0.2401536 + f * 0.0558282))
    e = (i.to(torch.int32) + 127) << 23
    return e.view(torch.float32) * p


def plain_softmax(name: str, q: torch.Tensor, k: torch.Tensor):
    """The softmax of the named variant on bf16 q, k (B, N, H, Dh), with the
    JAX kernel's rounding points: (s, shift, p) with s (B, H, N, N) f32 the
    scores as the variant's softmax reads them (its factor folded into q
    where it has one), shift the float or (B, H, N, 1) tensor each row's p is
    taken against, and p before its rounding to bf16."""
    _check_name(name)
    bf16 = q.dtype
    head_dim = q.shape[-1]
    if name != "base":
        q = (q.float() * _fold(name, head_dim)).to(bf16)  # both bf16, one rounding
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if name == "base":
        s = s * (1.0 / math.sqrt(head_dim))
    if name == "bf16s":
        s = s.to(bf16).float()
    if name == "noshift":
        return s, _SHIFT, torch.exp(s - _SHIFT)
    if name == "fexp_ns":
        return s, _SHIFT_EXP2, _fastexp2(s - _SHIFT_EXP2)
    if name == "normbound":
        qn2 = q.float().square().sum(-1)                    # (B, N, H)
        kn2max = k.float().square().sum(-1).amax(dim=1)     # (B, H)
        m = (torch.sqrt(qn2 * kn2max[:, None]) - 40.0).permute(0, 2, 1).unsqueeze(-1)
        return s, m, torch.exp(s - m)
    m = s.amax(dim=-1, keepdim=True)
    if name == "noexp":
        return s, m, s - m
    if name == "fexp":
        return s, m, _fastexp2(s - m)
    if name == "bf16s":  # subtraction and exp in bf16
        return s, m, torch.exp((s - m).to(bf16).float())
    return s, m, torch.exp(s - m)


def variant_plain(name: str, num_heads: int, N: int, D: int, bb: int = 1):
    """The plain PyTorch version of ``make_variant``: the JAX kernel's steps
    with their rounding points (``plain_softmax``, then P V over the row sum
    of the rounded p, then the row quant). ``bb`` groups images and changes
    nothing."""
    _check_name(name)
    head_dim = D // num_heads

    def run(qkv: torch.Tensor):
        B = _check_shape(qkv, N, D, bb)
        q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2)
        p = plain_softmax(name, q, k)[2].to(qkv.dtype).float()
        rowsum = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)   # (B, N, H, 1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / rowsum  # no floor
        return quantize_rows(o.reshape(B, N, D))

    return run


def _check_shape(qkv: torch.Tensor, N: int, D: int, bb: int) -> int:
    if qkv.dim() != 3 or qkv.shape[1:] != (N, 3 * D):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, {N}, {3 * D})")
    if bb < 1 or qkv.shape[0] % bb:
        raise ValueError(f"batch {qkv.shape[0]} is not a multiple of bb={bb}")
    return qkv.shape[0]


def make_variant(name: str, num_heads: int, N: int, D: int, bb: int = 1):
    """A function qkv (B, N, 3D) bf16 -> (int8 (B, N, D), f32 (B, N, 1)): the
    attention + row quant of the named variant, ``bb`` images per thread
    block (a grouping only: the output does not depend on it).

    The function runs ``variant_plain`` on a CPU tensor; on a CUDA tensor it
    launches the kernel (bf16, head dim 32 or 64, at most ``MAX_HEADS``
    heads) or raises."""
    _check_name(name)
    head_dim = D // num_heads
    plain = variant_plain(name, num_heads, N, D, bb)

    def run(qkv: torch.Tensor):
        if qkv.device.type == "cpu":
            return plain(qkv)
        B = _check_shape(qkv, N, D, bb)
        if qkv.device.type != "cuda":
            raise ValueError(f"unsupported device {qkv.device}")
        if qkv.dtype != torch.bfloat16:
            raise TypeError(f"the variant kernel takes bf16, got {qkv.dtype}")
        if D % num_heads or head_dim not in _HEAD_DIMS:
            raise ValueError(f"head dim {D}/{num_heads} not in {_HEAD_DIMS}")
        if D % 8 or D > 4096:
            raise ValueError(f"model width {D} must be a multiple of 8 up to "
                             "4096")
        if num_heads > MAX_HEADS:
            raise ValueError(f"{num_heads} heads exceed the variant kernel's "
                             f"{MAX_HEADS} (one thread-block cluster holds "
                             "every head of a row chunk)")
        if not qkv.is_contiguous() or qkv.data_ptr() % 16:
            raise ValueError("qkv must be contiguous and 16-byte aligned")
        oq = torch.empty((B, N, D), dtype=torch.int8, device=qkv.device)
        os_ = torch.empty((B, N, 1), dtype=torch.float32, device=qkv.device)
        if oq.numel() == 0:
            return oq, os_
        lib = _build.library()
        with torch.cuda.device(qkv.device):
            rc = lib.cvt_attention_variant(
                qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
                VARIANTS[name], B, N, num_heads, head_dim, bb,
                1.0 / math.sqrt(head_dim), _fold(name, head_dim),
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"attention variant {name}")
        LAUNCHES[name] += 1
        return oq, os_

    return run


def sweep(batch: int, device=None) -> dict:
    """Time every variant at the serving shape (257 tokens, 12 heads of 64)
    on ``batch`` random images, 16 calls after a warm-up call; prints one
    line per variant and returns {name: ms per batch}. Runs on the CUDA
    device unless ``device`` says otherwise (on the CPU it times the plain
    versions)."""
    import time

    dev = resolve_device(device)
    iters = 16
    N, H, Dh = 257, 12, 64
    D = H * Dh
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((batch, N, 3 * D), generator=gen).to(torch.bfloat16).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = {}
    for name in VARIANTS:
        fn = make_variant(name, H, N, D)
        fn(qkv)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(qkv)
        sync()
        dt = (time.perf_counter() - t0) / iters
        times[name] = dt * 1e3
        print(f"{name:10s} bb=1: {dt * 1e3:7.2f} ms/batch "
              f"({batch / dt:.0f} img/s attn-only)", flush=True)
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "sweep"
    if mode != "sweep":
        raise SystemExit(f"unknown mode {mode}")
    sweep(int(argv[1]) if len(argv) > 1 else 512)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
