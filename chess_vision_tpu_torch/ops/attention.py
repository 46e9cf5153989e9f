"""Multi-head attention on the packed qkv projection, forward and backward.

Counterpart of ``chess_vision_tpu/ops/attention.py`` ``fused_qkv_attention``
and its custom VJP. The forward kernel, ``csrc/attention.cu``, reads Q, K and
V straight out of the packed (B, N, 3*H*Dh) projection and keeps the scores
on chip; ``reference_attention`` is the plain PyTorch version, with the same
math as the JAX package's ``_reference_attention``. ``fused_qkv_attention`` is
differentiable through a ``torch.autograd.Function`` that saves only ``qkv``
(as ``_tpu_attention_fwd`` does); its backward is the kernel
``csrc/attention_bwd.cu`` (``fused_qkv_attention_bwd``: one block per
(image, head) holds the head's Q, K, V and g in shared memory, recomputes the
softmax statistics into registers in a first sweep over the keys and forms
dQ, dK and dV in a second, with no scratch in device memory; above
``BWD_MAX_TOKENS`` tokens ``csrc/attention_bwd_cluster.cu``, a thread-block
cluster per (image, head) whose CTAs hold the head's keys, ``long_plan``),
with ``reference_attention_bwd`` as the plain version: the arithmetic of the
JAX package's ``_attn_bwd_kernel`` step by step, with its rounding points.

f32 inputs (an f32 model: ``training.mixed_precision=false``, or an f32
checkpoint served) take the f32 kernels of ``csrc/attention_f32.cu``, IEEE
f32 throughout (no TF32): one thread-block cluster per (image, head) whose
CTAs hold the head's keys in ranges of at most ``F32_CTA_KEYS``
(``f32_plan``), for the forward at every token count and for the backward
(one launch, the five products, no scratch) up to ``F32_MAX_TOKENS``; above
it the backward's long route runs the same kernel on clusters of up to 16
CTAs (``long_plan``). Both long routes split a head's keys over several
clusters where one cannot hold them, through a statistics pass and f32
scratches. They count in ``F32_LAUNCHES`` and
``F32_BWD_LAUNCHES``, not in the bf16 counters. The plain versions are the
same two functions, which compute in f32 for either dtype.

Any other head dim (not a multiple of 8, or above 128), and a qkv that does
not start on a 16-byte boundary, takes ``csrc/attention_any.cu`` (forward)
and ``csrc/attention_any_bwd.cu`` (backward) in either dtype
(``head_dim_route`` ``"any"``): the same function at any head dim and
any token count, bf16 products on the tensor cores, one CTA over all of a
head's output columns up to 256 (``any_plan``; above, chunks of 256 that
compute the scores again, the depth 256 columns at a time); the forward a
CTA of 4 warps over 16-row blocks, the backward one launch on a
thread-block cluster per (image, head), no scratch (``any_bwd_plan``; past
the keys one cluster holds, a split through f32 scratches). Its calls count in the counters of their dtype and in
``ANY_LAUNCHES`` / ``ANY_BWD_LAUNCHES``.

``fused_qkv_attention_quant`` is the int8 serving path's form (the JAX
package's function of that name, K4): attention, then per-token int8
quantization of the (B, N, H*Dh) output, in ``csrc/attention_quant.cu`` (one
launch: the blocks of a row chunk's heads form a thread-block cluster and
exchange their row maxima on chip, so at most ``QUANT_MAX_HEADS`` heads);
``reference_attention_quant`` is its plain version. Both take the JAX
function's modes: the softmax shift (``shift_mode``: "bound", the JAX
default without a calibrated shift, |q_i| max_j |k_j| - 45 per row and
head; "fixed"; "max"), the bf16 exp and the int8 legs (``qk_int8``,
``pv_int8``: the kernel's second entry, ``cvt_attention_quant_i8``, on two
routes by ``i8_plan``: a head's codes in a block's shared memory, or past
it the head streamed in key tiles, ``csrc/attention_quant_long.cu``).
``fused_qkv_attention_quant_flat`` (K5) is the same on the ``"flat"`` int8
layout's (images * NP, 3*H*Dh) stream, whose token axis is padded to NP rows
per image: keys at token index >= ``n_real`` are masked out of the softmax.
It runs the same kernel through its second entry point, which keeps the rows
per image and the valid keys apart; ``reference_attention_quant_flat`` is its
plain version.
"""

from __future__ import annotations

import math

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops.rowquant import quantize_rows

# Kernel launches since the last reset, of the attention forward kernel, of
# the backward one, of the quantizing one and of its flat form (chip_smoke.py
# proves the main path went through the kernels with them).
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_LONG_LAUNCHES = 0  # of BWD_LAUNCHES, those of the long route
QUANT_LAUNCHES = 0
FLAT_LAUNCHES = 0
F32_LAUNCHES = 0  # of the f32 forward kernel (csrc/attention_f32.cu)
F32_BWD_LAUNCHES = 0  # of the f32 backward, one a call on either route
F32_BWD_LONG_LAUNCHES = 0  # of F32_BWD_LAUNCHES, those of the long route
QUANT_I8_LAUNCHES = 0  # of QUANT_LAUNCHES and FLAT_LAUNCHES, the int8 legs'
QUANT_I8_LONG_LAUNCHES = 0  # of QUANT_I8_LAUNCHES, those of the long route
ANY_LAUNCHES = 0  # of LAUNCHES and F32_LAUNCHES, csrc/attention_any.cu's
ANY_BWD_LAUNCHES = 0  # of BWD_LAUNCHES and F32_BWD_LAUNCHES, the same

# The attention kernels' (K2, K3) instantiations in csrc/attention*.cu
# (cvt::flash_head_dim): a head dim that is a multiple of 8 up to 128 runs
# the smallest that holds it, its extra columns zero (``kernel_head_dim``);
# any other head dim runs csrc/attention_any.cu (``head_dim_route``).
# The quantizing kernels (K4/K5) take QUANT_HEAD_DIMS alone, as the JAX
# int8 path.
HEAD_DIMS = (16, 32, 64, 80, 128)
QUANT_HEAD_DIMS = (16, 32, 64)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
BWD_MAX_TOKENS = 288  # kMaxN in csrc/attention_bwd.cu
BWD_SHORT_MAX_HEAD_DIM = 64  # attention_bwd.cu's largest instantiation
QUANT_MAX_HEADS = 16  # kMaxHeads in csrc/attention_quant.cu
# kMaxSmem there: the int8 legs' short route keeps a head's codes in a
# block's shared memory up to this many bytes; past them the long route
# streams the head in key tiles (``i8_plan``). Its layout's constants:
# kRows query rows a chunk, kStages tiles in the ring, kFlashKTile keys a tile
# (csrc/attention_quant_i8.cuh, attention_loop.cuh).
I8_MAX_SMEM = 232448
I8_ROUTES = ("short", "long")  # cvt_attention_quant_i8's route, by index
_I8_ROWS = 96
_I8_STAGES = 2
# the long route's block (attention_quant_i8.cuh kLongWarps, kLongStages):
# warps of 32 query rows, and its ring's depth of 64-key tiles
_I8_LONG_WARPS = 4
_I8_LONG_STAGES = 3
# (head dim, legs) -> the last key count the short route takes: at head dim
# 64 it was faster at 257 keys and slower at 289 in turns on an H100 in every
# form (kernel_ab --sections legs); 258-288 keys take both routes' layouts of
# 257 (keys rounded up to 32 and to 64). Head dims 16 and 32, not measured,
# keep the short route wherever it fits.
_I8_SHORT_LAST = {(64, 1): 288, (64, 2): 288, (64, 3): 288}
_KEY_TILE = 64
_MAX_GRID_YZ = 65535
# The f32 kernels' cluster (csrc/attention_f32.cuh): a CTA holds at most
# F32_CTA_KEYS keys (kCtaKeys: 4 warps of 16), a cluster at most
# F32_MAX_CTAS CTAs (kMaxCtas, the portable size), so the backward's cluster
# route takes up to F32_MAX_TOKENS tokens and ``f32_long`` the rest; the
# forward walks a longer range in 64-key windows, so it takes every count.
F32_CTA_KEYS = 64
F32_MAX_CTAS = 8
F32_MAX_TOKENS = F32_MAX_CTAS * F32_CTA_KEYS
F32_KEY_STEP = 16  # kWarpKeys: a CTA's key range is a multiple of it
# The long routes' clusters: f32 (csrc/attention_f32.cuh kMaxLongCtas) up
# to 16 CTAs of 64 keys, 1,024 tokens; bf16 (csrc/attention_bwd_cluster.cu)
# up to 8 CTAs (kMaxCtas) of 8 warps of 16 keys (kMaxWarps), 1,024 tokens.
# Above a cluster's reach a head's keys split over several clusters.
F32_LONG_MAX_CTAS = 16
LONG_MAX_CTAS = 8  # also the f32 long route's above a head dim of 64
LONG_MAX_WARPS = 8
_SMEM_LIMIT = 232448  # the dynamic shared memory a Hopper block may have
# csrc/attention_any.cuh: the any-head-dim kernels. Output columns a CTA
# (kMaxCols; any_cols: 16 ... 256), a backward cluster's CTAs (kMaxCtas,
# above 8 non-portable). The header owns the rest of the layout and its
# shared memory, which fits a block at every head dim (every_plan_fits).
ANY_MAX_COLS = 256
ANY_MAX_CTAS = 16


def reference_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention: (B, N, 3*H*Dh) -> (B, N, H*Dh).

    Scores in the input dtype, softmax in f32, probabilities cast back to
    the input dtype for the product with V, as in the JAX reference."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(_accum_dtype(qkv)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.reshape(B, N, D)


def reference_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention backward: saved qkv (B, N, 3*H*Dh) and the
    cotangent g (B, N, H*Dh) of the output -> dqkv (B, N, 3*H*Dh).

    The steps and rounding points of the JAX package's ``_attn_bwd_kernel``:
    scores, the max-shifted softmax, its normalization, dP and r in f32; pn
    rounded to the input dtype only as the operand of dV = pn^T g; dS rounded
    to the input dtype after the scale is folded in, then dQ = dS K and
    dK = dS^T Q; f32 accumulation and one rounding of each output."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    acc = _accum_dtype(qkv)
    scale = 1.0 / math.sqrt(head_dim)
    q, k, v = (t.to(acc) for t in
               qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2))
    gh = g.reshape(B, N, num_heads, head_dim).to(acc)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.to(qkv.dtype).to(acc), gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    r = (dp * pn).sum(dim=-1, keepdim=True)
    ds = (pn * (dp - r) * scale).to(qkv.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(B, N, C3).to(qkv.dtype)


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16, f16 and f32 inputs; f64 stays f64."""
    return torch.promote_types(x.dtype, torch.float32)


def kernel_head_dim(head_dim: int) -> int:
    """The instantiation of K2 and K3 that runs ``head_dim``: the smallest of
    ``HEAD_DIMS`` that holds it (48 -> 64, 72 -> 80, 96 -> 128), for a
    multiple of 8 from 8 to 128 (those kernels copy a head's columns 16
    bytes at a time from column h * head_dim, which stays 16-byte aligned in
    bf16); 0 for another head dim, which ``csrc/attention_any.cu`` runs.
    Raises for a head dim below 1."""
    if head_dim < 1:
        raise ValueError(f"head dim {head_dim} is below 1: no attention "
                         "kernel takes it")
    if head_dim % 8 or head_dim > HEAD_DIMS[-1]:
        return 0
    return next(d for d in HEAD_DIMS if d >= head_dim)


def head_dim_route(head_dim: int, aligned: bool = True) -> str:
    """Which kernels run K2 and K3 at ``head_dim``: ``"flash"``, the
    instantiated ones (``kernel_head_dim``), where qkv starts on a 16-byte
    boundary (``aligned``); ``"any"`` (``csrc/attention_any.cu``, which
    copies element by element) for every other head dim or address."""
    return "flash" if kernel_head_dim(head_dim) and aligned else "any"


def any_cols(head_dim: int) -> int:
    """The output columns an any-head-dim CTA keeps (``any_cols`` in
    ``csrc/attention_any.cuh``): the smallest of 16, 32, 64, 128 and 256
    that holds ``head_dim``, else 256. Raises below 1."""
    kernel_head_dim(head_dim)
    return next((c for c in (16, 32, 64, 128) if head_dim <= c), ANY_MAX_COLS)


def any_plan(head_dim: int) -> tuple[int, int]:
    """The any-head-dim kernels' output chunks at ``head_dim``: (chunks,
    cols). One CTA (forward) or cluster (backward) keeps all ``cols``
    (``any_cols``) output columns up to a head dim of 256, so no score
    product is computed twice; above, the head dim goes in ``chunks``
    chunks of 256, each computing the scores over the whole head dim, which
    the tiles then hold 256 columns at a time: 12 -> (1, 16), 100 -> (1,
    128), 256 -> (1, 256), 384 -> (2, 256), 1,100 -> (5, 256)."""
    cols = any_cols(head_dim)
    return -(-head_dim // cols), cols


def any_bwd_plan(n: int, head_dim: int) -> tuple[int, int, int]:
    """The any-head-dim backward's layout for ``n`` tokens: (clusters,
    ctas, keys) per (image, head, column chunk). A CTA holds at most 128
    keys, 64 at 256 columns (``bwd_max_keys``), the head's 16-key steps
    shared out evenly (``f32_key_ranges(n, clusters * ctas)``); one cluster
    of up to ``ANY_MAX_CTAS`` CTAs where that holds the head (one launch:
    1,024 tokens at every head dim), else the fewest clusters that do (three
    launches through f32 scratches). keys: the most any CTA holds, a
    multiple of 16. 257 tokens at 3 heads of 256: (1, 5, 64); 577: (1, 10,
    64); 64 heads of 12 at 257: (1, 3, 96)."""
    if n < 1:
        raise ValueError(f"no plan for {n} tokens")
    cap = 64 if any_cols(head_dim) >= ANY_MAX_COLS else 128
    steps = -(-n // F32_KEY_STEP)
    needed = -(-steps // (cap // F32_KEY_STEP))
    clusters = -(-needed // ANY_MAX_CTAS)
    ctas = -(-needed // clusters)
    return clusters, ctas, 16 * -(-steps // (clusters * ctas))


def _check_kernel_input(qkv: torch.Tensor, num_heads: int,
                        dtypes: tuple = _KERNEL_DTYPES,
                        head_dims: tuple | None = None) -> int:
    """Raise on what the attention kernels do not take (the quantizing ones
    take bf16 alone and ``QUANT_HEAD_DIMS`` at a 16-byte aligned address, as
    the JAX int8 path; K2 and K3 any head dim from 1 at any address,
    ``head_dim_route`` picks the kernels); returns the head dim."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"this attention kernel takes {names}, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} does not split into "
                         f"3 x {num_heads} heads")
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    if head_dims is None:
        chunks = any_plan(head_dim)[0]
    elif head_dim not in head_dims:
        raise ValueError(f"head dim {head_dim} not in {head_dims}")
    else:
        chunks = 1
    if B > _MAX_GRID_YZ or num_heads * chunks > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {num_heads} exceed the grid")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if head_dims is not None and qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    return head_dim


def f32_plan(n: int, backward: bool = True,
             head_dim: int = 64) -> tuple[str, int]:
    """The f32 kernels' layout for ``n`` tokens: (route, ctas).

    Route ``"f32"``: one thread-block cluster of ``ctas`` CTAs per (image,
    head), the fewest that hold the keys at ``F32_CTA_KEYS`` a CTA, at most
    ``F32_MAX_CTAS`` (the forward walks a longer range in 64-key windows);
    the keys of each in ``f32_key_ranges``. The kernels' header
    (``csrc/attention_f32.cuh``) owns the rest of the layout and its shared
    memory, and the C entries refuse a CTA count that does not fit. Route
    ``"f32_long"`` (the backward above ``F32_MAX_TOKENS``): the same kernel
    on ``long_plan``'s clusters, ``ctas`` CTAs each."""
    if n < 1:
        raise ValueError(f"no f32 plan for {n} tokens")
    if backward and n > F32_MAX_TOKENS:
        return "f32_long", long_plan(n, torch.float32, head_dim)[1]
    steps = -(-n // F32_KEY_STEP)
    return "f32", min(F32_MAX_CTAS, -(-steps // (F32_CTA_KEYS // F32_KEY_STEP)))


def f32_key_ranges(n: int, ctas: int) -> list[tuple[int, int]]:
    """The keys [start, end) of each CTA of an f32 cluster (``cta_keys`` in
    ``csrc/attention_f32.cuh``): the n tokens' 16-key steps shared out
    evenly, the first ones taking one step more; the last step may be
    short. 257 tokens over 5 CTAs: 64, 64, 48, 48 and 33 keys."""
    steps = -(-n // F32_KEY_STEP)
    base, extra = divmod(steps, ctas)
    ranges = []
    for rank in range(ctas):
        start = (rank * base + min(rank, extra)) * F32_KEY_STEP
        end = start + (base + (rank < extra)) * F32_KEY_STEP
        ranges.append((start, min(end, n)))
    return ranges


def long_plan(n: int, dtype: torch.dtype = torch.bfloat16,
              head_dim: int = 64) -> tuple[int, int, int]:
    """The long backward routes' layout for ``n`` tokens: (clusters, ctas,
    warps) per (image, head). The head's 16-key steps go evenly to the
    clusters * ctas CTAs (``f32_key_ranges(n, clusters * ctas)``), each warp
    of a CTA owning 16 keys: the fewest clusters that hold the head (one up
    to 1,024 tokens), then the fewest CTAs of ``LONG_MAX_WARPS`` warps in
    bf16 (577 tokens: 5 CTAs of 8 warps, two such CTAs an SM; 8 CTAs of 5
    warps, three an SM, were 7% slower), of 4 warps in f32 (577 tokens:
    10). Above a head dim of 64 an f32 CTA fills an SM, so its clusters keep
    to the portable 8 CTAs (512 tokens; 577 tokens: 2 clusters of 5). More
    than one cluster: the kernels' statistics pass and f32 scratches
    (``fused_qkv_attention_bwd``). The C entries refuse a plan that does
    not fit."""
    if n < 1:
        raise ValueError(f"no plan for {n} tokens")
    steps = -(-n // F32_KEY_STEP)
    if dtype == torch.float32:
        warps = F32_CTA_KEYS // F32_KEY_STEP
        most = (F32_LONG_MAX_CTAS if kernel_head_dim(head_dim) <= 64
                else LONG_MAX_CTAS)
        clusters = -(-steps // (most * warps))
    else:
        clusters = -(-steps // (LONG_MAX_CTAS * LONG_MAX_WARPS))
    per = -(-steps // clusters)  # a cluster's steps, at most
    if dtype != torch.float32:
        warps = min(LONG_MAX_WARPS, per)
    return clusters, -(-per // warps), warps


def long_smem_bytes(head_dim: int, warps: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a long-route CTA (``smem_bytes`` in
    ``csrc/attention_bwd_cluster.cu``, ``bwd_smem_bytes`` in
    ``csrc/attention_f32.cuh``) for an instantiated ``head_dim``: in bf16 K
    and V of the CTA's keys, the Q and g tiles of 64 rows, dS^T and, in
    f32, pn^T (its place, which the dQ partials reuse, at least 64 x
    head_dim), the dQ slices it receives and the row statistics."""
    if dtype == torch.float32:
        ld = head_dim + 4
        pt = max(F32_CTA_KEYS * 72, 64 * head_dim)
        return 4 * (2 * F32_CTA_KEYS * ld + 2 * 64 * ld + pt + F32_CTA_KEYS * 72
                    + 3 * 4 * 64 + 6 * 64)
    keys, ld = warps * F32_KEY_STEP, head_dim + 8
    return (2 * (2 * keys * ld + 2 * 64 * ld + keys * 72)
            + 4 * (70 * head_dim + 4 * 64 + 3 * warps * 64 + 3 * 64))


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3*H*Dh) packed qkv -> (B, N, H*Dh) attention output,
    differentiable in ``qkv``.

    A CPU tensor takes ``reference_attention`` (and
    ``reference_attention_bwd`` for its gradient); a CUDA tensor launches the
    kernels (bf16 or f32, any head dim from 1, ``head_dim_route``) or
    raises."""
    if qkv.requires_grad and torch.is_grad_enabled():
        return _FusedAttention.apply(qkv, num_heads)
    return fused_qkv_attention_fwd(qkv, num_heads)


class _FusedAttention(torch.autograd.Function):
    """The forward saves only ``qkv``; the backward recomputes the softmax
    statistics from it inside its kernel (``fused_qkv_attention_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return fused_qkv_attention_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return fused_qkv_attention_bwd(qkv, g, ctx.num_heads), None


def attention_recomputing_qkv(x: torch.Tensor, make_qkv, params: list,
                              num_heads: int) -> torch.Tensor:
    """``fused_qkv_attention(make_qkv(x), num_heads)`` that keeps only ``x``
    for the backward: there ``make_qkv`` (a differentiable function of
    ``x`` and the tensors ``params``, such as LayerNorm then the qkv
    product) runs again for the attention backward's qkv, and the attention
    forward does not. ``remat="attn_out"`` (``models/layers.py``) runs each
    block's attention so."""
    return _RecomputedQkvAttention.apply(x, make_qkv, num_heads, *params)


class _RecomputedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, make_qkv, num_heads, *params):
        with torch.no_grad():
            qkv = make_qkv(x)
        ctx.save_for_backward(x, *params)
        ctx.make_qkv, ctx.num_heads = make_qkv, num_heads
        return fused_qkv_attention_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[0])
        with torch.enable_grad():
            qkv = ctx.make_qkv(x)
        dqkv = fused_qkv_attention_bwd(qkv.detach(), g, ctx.num_heads)
        wants = [x, *params]
        which = [i for i, t in enumerate(wants) if t.requires_grad]
        found = torch.autograd.grad(qkv, [wants[i] for i in which], dqkv)
        grads = [None] * len(wants)
        for i, grad in zip(which, found):
            grads[i] = grad
        return grads[0], None, None, *grads[1:]


def fused_qkv_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward alone, outside autograd: ``reference_attention`` for a CPU
    tensor, the kernel for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return reference_attention(qkv, num_heads)
    head_dim = _check_kernel_input(qkv, num_heads)
    B, N, C3 = qkv.shape
    D = C3 // 3
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    scale = 1.0 / math.sqrt(head_dim)
    f32 = qkv.dtype == torch.float32
    any_route = head_dim_route(head_dim, qkv.data_ptr() % 16 == 0) == "any"
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if any_route:
            rc = lib.cvt_attention_fwd_any(
                qkv.data_ptr(), out.data_ptr(), B, N, num_heads, head_dim,
                int(f32), scale, stream)
        elif f32:  # the scale folds into q where that is exact, as in JAX
            q_scale, s_scale = (scale, 1.0) if _pow2(scale) else (1.0, scale)
            rc = lib.cvt_attention_fwd_f32(
                qkv.data_ptr(), out.data_ptr(), B, N, num_heads, head_dim,
                f32_plan(N, False, head_dim)[1], q_scale, s_scale, stream)
        else:
            rc = lib.cvt_attention_fwd(
                qkv.data_ptr(), out.data_ptr(), B, N, num_heads, head_dim,
                scale, stream)
    _build.check(rc, ("f32 attention" if f32 else "attention")
                 + (" (any head dim)" if any_route else ""))
    global LAUNCHES, F32_LAUNCHES, ANY_LAUNCHES
    ANY_LAUNCHES += any_route
    if f32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def bwd_route(n: int, dtype: torch.dtype = torch.bfloat16,
              head_dim: int = 64, aligned: bool = True) -> str:
    """The backward kernel that takes ``n`` tokens of ``head_dim``: ``"any"``
    (``csrc/attention_any.cu``, either dtype, every count) where
    ``head_dim_route`` says so; else in bf16
    ``"short"`` (``csrc/attention_bwd.cu``, a head in shared memory) up to
    ``BWD_MAX_TOKENS`` and a head dim of ``BWD_SHORT_MAX_HEAD_DIM``,
    ``"long"`` (``csrc/attention_bwd_cluster.cu``, a head's keys in
    thread-block clusters, ``long_plan``) otherwise: above 64 a head's four
    tiles alone outgrow a block's shared memory (191,488 bytes at 257
    tokens and 80). In f32 ``"f32"`` (``csrc/attention_f32.cu``, a head's
    keys in one cluster of up to 8 CTAs) up to ``F32_MAX_TOKENS``,
    ``"f32_long"`` (the same kernel on ``long_plan``'s clusters) above."""
    if head_dim_route(head_dim, aligned) == "any":
        return "any"
    if dtype == torch.float32:
        return "f32" if n <= F32_MAX_TOKENS else "f32_long"
    short = (n <= BWD_MAX_TOKENS
             and kernel_head_dim(head_dim) <= BWD_SHORT_MAX_HEAD_DIM)
    return "short" if short else "long"


def fused_qkv_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Saved qkv (B, N, 3*H*Dh) and the output's cotangent g (B, N, H*Dh) ->
    dqkv (B, N, 3*H*Dh).

    A CPU tensor takes ``reference_attention_bwd``; a CUDA tensor launches
    a backward kernel (bf16 or f32, any head dim from 1) or raises. The
    kernels are hand-written and give the same function; dtype, shape and
    address pick one (``bwd_route``): ``csrc/attention_any.cu`` where
    ``head_dim_route`` gives ``"any"`` (``any_bwd_plan``: one launch on a
    cluster per (image, head), no scratch, up to the keys one cluster holds;
    past them three launches through the clusters' statistics (B, H chunks,
    clusters, 3, N) and dQ partials (B, H, clusters, N, Dh)); else in bf16 up to
    ``BWD_MAX_TOKENS`` tokens and a head dim of 64 the one-block-per-head
    kernel of ``csrc/attention_bwd.cu``, otherwise
    ``csrc/attention_bwd_cluster.cu`` on ``long_plan``'s thread-block
    clusters; in f32 up to ``F32_MAX_TOKENS`` the one cluster launch of
    ``csrc/attention_f32.cu`` (``f32_plan``), above it the same kernel on
    ``long_plan``'s clusters. A long route whose plan has more than one
    cluster a head runs three launches through two f32 scratches, the
    clusters' row statistics (B, H, clusters, 3, N) and dQ partials
    (B, H, clusters, N, Dh). ``g`` is made contiguous first (autograd may
    hand a strided one)."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    if g.shape != (B, N, D) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"does not match qkv {tuple(qkv.shape)} {qkv.dtype} "
                         f"on {qkv.device}")
    if qkv.device.type == "cpu":
        return reference_attention_bwd(qkv, g, num_heads)
    head_dim = _check_kernel_input(qkv, num_heads)
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    lib = _build.library()
    route = bwd_route(N, qkv.dtype, head_dim, qkv.data_ptr() % 16 == 0)
    ptrs = [qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr()]
    shape = [B, N, num_heads, head_dim]
    if route == "any":
        clusters, ctas, keys = any_bwd_plan(N, head_dim)
        scratch = [None, None]
        if clusters > 1:
            chunks = any_plan(head_dim)[0]
            f32 = dict(dtype=torch.float32, device=qkv.device)
            stats = torch.empty((B, num_heads * chunks, clusters, 3, N), **f32)
            parts = torch.empty((B, num_heads, clusters, N, head_dim), **f32)
            scratch = [stats.data_ptr(), parts.data_ptr()]
        ptrs += scratch
        shape += [int(qkv.dtype == torch.float32), clusters, ctas, keys]
    elif route in ("long", "f32_long"):
        clusters, ctas, warps = long_plan(N, qkv.dtype, head_dim)
        scratch = [None, None]
        if clusters > 1:
            f32 = dict(dtype=torch.float32, device=qkv.device)
            stats = torch.empty((B, num_heads, clusters, 3, N), **f32)
            parts = torch.empty((B, num_heads, clusters, N, head_dim), **f32)
            scratch = [stats.data_ptr(), parts.data_ptr()]
        ptrs += scratch
        shape += [clusters, ctas] + ([warps] if route == "long" else [])
    elif route == "f32":
        shape.append(f32_plan(N, True, head_dim)[1])
    entry = {"short": lib.cvt_attention_bwd, "long": lib.cvt_attention_bwd_long,
             "f32": lib.cvt_attention_bwd_f32,
             "f32_long": lib.cvt_attention_bwd_f32_long,
             "any": lib.cvt_attention_bwd_any}[route]
    with torch.cuda.device(qkv.device):
        rc = entry(*ptrs, *shape, 1.0 / math.sqrt(head_dim),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"attention backward ({route})")
    global BWD_LAUNCHES, BWD_LONG_LAUNCHES, F32_BWD_LAUNCHES
    global F32_BWD_LONG_LAUNCHES, ANY_BWD_LAUNCHES
    ANY_BWD_LAUNCHES += route == "any"
    if qkv.dtype == torch.float32:
        F32_BWD_LAUNCHES += 1
        F32_BWD_LONG_LAUNCHES += route == "f32_long"
    else:
        BWD_LAUNCHES += 1
        BWD_LONG_LAUNCHES += route == "long"
    return dqkv


def _pow2(x: float) -> bool:
    """True when x is an exact power of two (the JAX kernel then folds the
    softmax scale into q and honours a fixed or bound shift)."""
    return math.frexp(x)[0] == 0.5


# The quantizing attention's softmax shift (CHESS_VISION_ATTN_SOFTMAX), as
# the C entry points number them (csrc/attention_loop.cuh FlashShift).
SHIFT_MODES = {"max": 0, "fixed": 1, "bound": 2}
FIXED_SHIFT = 24.0   # the JAX package's _FIXED_SHIFT
BOUND_OFFSET = 45.0  # its _BOUND_OFFSET
_EXP_BF16_FLAG = 4   # in the C entry points' mode: the bf16 exp
_LANES = 128         # the JAX kernel splits the key axis at a multiple of it


def _shift(shift_mode: str, softmax_shift: float | None, head_dim: int,
           legacy: bool = False) -> tuple[str, float]:
    """The shift the JAX kernel takes, by its rules: the int8 legs (legacy)
    take the exact row max; a calibrated shift overrides the mode; "fixed"
    and "bound" need a power-of-two softmax scale (the fold), else the exact
    row max. Returns ("max" | "fixed" | "bound", the fixed shift)."""
    if shift_mode not in SHIFT_MODES:
        raise ValueError(f"unknown softmax shift mode {shift_mode!r}; "
                         f"expected one of {list(SHIFT_MODES)}")
    if legacy or not _pow2(1.0 / math.sqrt(head_dim)):
        return "max", 0.0
    if softmax_shift is not None:
        return "fixed", float(softmax_shift)
    if shift_mode == "fixed":
        return "fixed", FIXED_SHIFT
    return shift_mode, 0.0


def _block_exp_bf16(exp_bf16: bool, kind: str, n: int) -> bool:
    """Whether K4 rounds s - shift to bf16 before the exp: the JAX kernel
    does so everywhere but on its wide-exp path, which a fixed shift takes at
    128 k + 1..2 tokens (``_attn_quant_image``: ``wide``)."""
    nm = (n // _LANES) * _LANES
    return exp_bf16 and not (kind == "fixed" and nm >= _LANES
                             and 0 < n - nm <= 2)


def _rowq8(x: torch.Tensor, dim: int = -1):
    """The JAX kernel's ``_rowq8`` (dim -1) and ``_colq8`` (over the keys) of
    f32 x: codes rint(x * fl(127 / amax)) clipped, and fl(amax * fl(1/127)),
    amax floored at 1e-8. (``127.0 / amax`` would be PyTorch's reciprocal
    times 127, not always fl(127 / amax).)"""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8)
    q = torch.round(x * (torch.full_like(amax, 127.0) / amax)).clamp(-127, 127)
    return q, amax * (1.0 / 127.0)


def _pair_sq(x: torch.Tensor) -> torch.Tensor:
    """(..., Dh) f32 -> (..., Dh / 2): x0^2 + x1^2 of each column pair, each
    product and the sum rounded (the kernels' ``flash_pair_sq``)."""
    return x[..., 0::2] * x[..., 0::2] + x[..., 1::2] * x[..., 1::2]


def _bound_shift(q: torch.Tensor, k: torch.Tensor, n_real: int,
                 scale: float) -> torch.Tensor:
    """(B, H, N, 1) shifts |q_i| max_j |k_j| - 45, as the JAX ``_bound_shift``
    defines them: sums of squares in f32 over each head's columns of the
    folded q and of the keys below n_real, then sqrt(qn2 * kn2max) - 45.
    The sums are taken in the kernels' order (``attention_loop.cuh``
    ``flash_key_norm_max``, ``flash_norm_bound``), so that a kernel and its
    plain version take the same shift bit for bit: a key's column pairs one
    after another; a row's pairs as the four threads of its fragments hold
    them, then the threads' sums two and two; |q|^2 of the unfolded q times
    scale^2 (exactly that of the folded q, for a power-of-two scale); the
    square root correctly rounded. The JAX code adds in another order."""
    kp = _pair_sq(k[:, :n_real].float())                  # (B, n, H, Dh/2)
    kn2 = torch.zeros_like(kp[..., 0])
    for c in range(kp.shape[-1]):
        kn2 = kn2 + kp[..., c]
    kn2max = kn2.amax(dim=1, keepdim=True)                # (B, 1, H)
    qp = _pair_sq(q.float()).unflatten(-1, (-1, 2, 4))    # (..., kk, half, t)
    acc = torch.zeros_like(qp[..., 0, 0, :])
    for kk in range(qp.shape[-3]):
        acc = acc + (qp[..., kk, 0, :] + qp[..., kk, 1, :])
    qn2 = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    prod = qn2 * torch.tensor(scale * scale, dtype=torch.float32) * kn2max
    bound = torch.sqrt(prod.double()).float() - BOUND_OFFSET
    return bound.permute(0, 2, 1).unsqueeze(-1)


def _row_sum_kernel_order(p: torch.Tensor) -> torch.Tensor:
    """(..., Nk) f32 -> (..., 1): the row sums of the int8 P V leg's p in
    the kernel's order (``attention_quant.cu`` walk 2): each of a row's four
    threads adds keys 8 m + 2 t and 8 m + 2 t + 1 for m = 0, 1, ..., then the
    threads' sums two and two."""
    pad = -p.shape[-1] % 8
    pk = torch.nn.functional.pad(p, (0, pad)).unflatten(-1, (-1, 4, 2))
    acc = torch.zeros_like(pk[..., 0, :, 0])
    for m in range(pk.shape[-3]):
        acc = acc + pk[..., m, :, 0]
        acc = acc + pk[..., m, :, 1]
    return ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]))[..., None]


def _legacy_scores(q, k, scale: float, qk_int8: bool) -> torch.Tensor:
    """(B, H, N, N) f32 scores of the int8 legs (``_head_scores``, no fold):
    f32(q . k) * scale, or with qk_int8 f32(int32 qq . kq) * (qs * scale) * ks
    with q and k quantized per (row, head). The integer sums are exact in f64."""
    if not qk_int8:
        return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qq, qs = _rowq8(q.float())
    kq, ks = _rowq8(k.float())
    s32 = torch.einsum("bqhd,bkhd->bhqk", qq.double(), kq.double()).float()
    return (s32 * (qs * scale).permute(0, 2, 1, 3)
            * ks.permute(0, 2, 3, 1))


def _attention_quant_plain(qkv: torch.Tensor, n_real: int, num_heads: int,
                           softmax_shift: float | None,
                           shift_mode: str = "bound", qk_int8: bool = False,
                           pv_int8: bool = False, exp_bf16: bool = False):
    """(B, N, 3*H*Dh) -> (int8 (B, N, H*Dh), f32 (B, N, 1)), keys at token
    index >= n_real masked: the arithmetic shared by the plain versions of
    K4 (n_real = N) and K5.

    f32 scores; a masked key's score is -1e30, so its p is exactly 0;
    p = exp(s - shift) rounded to the input dtype feeds both P V and the row
    sum (the JAX kernel's ones column of V); the output is
    P V / max(rowsum, 1e-30) in f32, then quantized per token over all
    heads. The shift as ``_shift`` picks it: the bound, a fixed shift or the
    exact row max. exp_bf16 rounds s - shift to bf16 before the exp (the
    caller applies ``_block_exp_bf16``). With qk_int8 or pv_int8, the JAX
    kernel's int8 legs: the exact row max, p = exp(s - max) in f32, then
    either p rounded to the input dtype as above or (pv_int8) p / rowsum
    quantized per row and V per column over all N rows, o =
    f32(int32 pq . vq) * ps * vs."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    scale = 1.0 / math.sqrt(head_dim)
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2)
    legacy = qk_int8 or pv_int8
    kind, fixed = _shift(shift_mode, softmax_shift, head_dim, legacy)
    if legacy:
        s = _legacy_scores(q, k, scale, qk_int8)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if n_real < N:
        s[..., n_real:] = -1e30
    if kind == "fixed":
        shift = fixed
    elif kind == "bound":
        shift = _bound_shift(q, k, n_real, scale)
    else:
        shift = s.amax(dim=-1, keepdim=True)
    if pv_int8:
        p = torch.exp(s - shift)
        p = p / _row_sum_kernel_order(p)
        pq, ps = _rowq8(p)                       # (B, H, N, N), (B, H, N, 1)
        vq, vs = _rowq8(v.float(), dim=1)        # (B, N, H, Dh), (B, 1, H, Dh)
        o32 = torch.einsum("bhqk,bkhd->bqhd", pq.double(), vq.double()).float()
        o = o32 * ps.permute(0, 2, 1, 3) * vs
        return quantize_rows(o.reshape(B, N, D))
    d = s - shift
    if exp_bf16 and not legacy:
        d = d.to(torch.bfloat16).float()
    p = torch.exp(d).to(qkv.dtype).float()
    rowsum = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, N, H, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / rowsum.clamp_min(1e-30)
    return quantize_rows(o.reshape(B, N, D))


def reference_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None,
                              shift_mode: str = "bound", qk_int8: bool = False,
                              pv_int8: bool = False, exp_bf16: bool = False):
    """Plain PyTorch version of the quantizing attention: (B, N, 3*H*Dh) ->
    (int8 (B, N, H*Dh), f32 (B, N, 1)); see ``_attention_quant_plain``."""
    head_dim = qkv.shape[-1] // 3 // num_heads
    kind, _ = _shift(shift_mode, softmax_shift, head_dim, qk_int8 or pv_int8)
    return _attention_quant_plain(
        qkv, qkv.shape[1], num_heads, softmax_shift, shift_mode, qk_int8,
        pv_int8, _block_exp_bf16(exp_bf16, kind, qkv.shape[1]))


def _check_quant_shape(D: int, num_heads: int) -> None:
    if D % 8 or D > 4096:
        raise ValueError(f"model width {D} must be a multiple of 8 up to 4096")
    if num_heads > QUANT_MAX_HEADS:
        raise ValueError(f"{num_heads} heads exceed the quantizing attention's "
                         f"{QUANT_MAX_HEADS} (one thread-block cluster holds "
                         "every head of a row chunk)")


def _i8_short_bytes(n_keys: int, head_dim: int, qk: bool, pv: bool) -> int:
    """``I8Layout``'s bytes: K's codes and scales (or bf16 rows) and V's
    codes (or bf16 rows) over the keys rounded up to 32, the chunk's output
    codes, V's column scales and maxima, the epilogue's row maxima."""
    row = 2 * (head_dim + 8)  # a bf16 row in shared memory
    tail = (_I8_ROWS * head_dim + 2 * _I8_ROWS * 4
            + (5 * head_dim * 4 if pv else 0))
    kp = -(-n_keys // 32) * 32
    vld = kp + 32 if kp % 64 == 0 else kp
    return ((kp * (head_dim + 20) if qk else kp * row)
            + (head_dim * vld if pv else kp * row) + tail)


def i8_short_fits(n_keys: int, head_dim: int, legs: int) -> bool:
    """Whether the short route takes a head of ``n_keys`` keys at all (its
    codes fit a block's ``I8_MAX_SMEM`` bytes)."""
    return _i8_short_bytes(n_keys, head_dim, bool(legs & 1),
                           bool(legs & 2)) <= I8_MAX_SMEM


def i8_plan(n_keys: int, head_dim: int, legs: int) -> tuple[str, int]:
    """The int8 legs' route for a head of ``n_keys`` keys at ``head_dim``
    (16, 32 or 64) and its block's shared memory in bytes; ``legs`` as the
    C entry takes them: 1 qk_int8, 2 pv_int8, 3 both.

    ``"short"`` (``attention_quant_i8_kernel``) where the head's codes, or a
    bf16 leg's rows, fit a block's ``I8_MAX_SMEM`` bytes (``i8_short_fits``:
    at head dim 64 up to 960 keys under qk_int8 alone, 1,056 under pv_int8
    alone, 1,504 under both) and, at head dim 64, up to 288 keys, past which
    the long route was measured faster (``_I8_SHORT_LAST``). ``"long"``
    (``attention_quant_i8_long_kernel``) past that, for any key count: a ring
    of ``_I8_LONG_STAGES`` tiles of K's and V's codes (or a bf16 leg's rows)
    in place of the head, and the tail for a pass of ``32 * _I8_LONG_WARPS``
    rows (``I8LongLayout``), the same bytes at every length; the head's codes
    go to a device scratch (``i8_long_scratch_bytes``)."""
    if legs not in (1, 2, 3):
        raise ValueError(f"legs {legs}: 1 (qk_int8), 2 (pv_int8) or 3 (both)")
    qk, pv = bool(legs & 1), bool(legs & 2)
    short = _i8_short_bytes(n_keys, head_dim, qk, pv)
    if short <= I8_MAX_SMEM and n_keys <= _I8_SHORT_LAST.get((head_dim, legs), n_keys):
        return "short", short
    row = 2 * (head_dim + 8)
    rows = 32 * _I8_LONG_WARPS
    tile = ((_KEY_TILE * (head_dim + 20) if qk else _KEY_TILE * row)
            + (head_dim * (_KEY_TILE + 32) if pv else _KEY_TILE * row))
    return "long", (_I8_LONG_STAGES * tile + rows * head_dim + 2 * rows * 4
                    + ((2 + _I8_LONG_WARPS) * head_dim * 4 if pv else 0))


def i8_long_scratch_bytes(n_keys: int, head_dim: int, legs: int) -> int:
    """The long route's device scratch for one (image, head) of ``n_keys``
    keys (``attention_quant_long.cu`` ``long_scratch_bytes``): K's codes
    [kp][head_dim] and f32 scales [kp] under qk_int8, V's codes
    [head_dim][kp] under pv_int8, kp the keys rounded up to a 64-key tile."""
    kp = -(-n_keys // _KEY_TILE) * _KEY_TILE
    return ((kp * (head_dim + 4) if legs & 1 else 0)
            + (head_dim * kp if legs & 2 else 0))


def i8_long_bytes(images: int, n: int, n_keys: int, heads: int,
                  head_dim: int, legs: int) -> int:
    """The bytes the int8 legs' long route reads from device memory a call
    (through L2 or not) for ``images`` of ``n`` rows, ``n_keys`` keys. Each
    (image, head) reads its Q rows once; to code the head once, K's rows
    (qk_int8), V's rows for the column scales (all n) and for the codes
    (pv_int8); then in each pass of ``32 * _I8_LONG_WARPS`` rows, once a
    walk (two walks, three with pv_int8), K's tiles (its codes and scales
    from the scratch, or its bf16 rows), and V's in the last walk (its codes,
    or its bf16 rows). Zero rows past the last key come from the scratch as
    codes and are not read as bf16."""
    row = 2 * head_dim  # a bf16 row of one head
    kp = -(-n_keys // _KEY_TILE) * _KEY_TILE
    qk, pv = bool(legs & 1), bool(legs & 2)
    passes = -(-(-(-n // 16)) // (2 * _I8_LONG_WARPS))
    k_tiles = kp * (head_dim + 4) if qk else n_keys * row
    v_tiles = head_dim * kp if pv else n_keys * row
    coding = (n_keys * row if qk else 0) + ((n + n_keys) * row if pv else 0)
    walks = 3 if pv else 2
    per_head = n * row + coding + passes * (walks * k_tiles + v_tiles)
    return images * heads * per_head


def _launch_quant(qkv, oq, os_, images: int, np_: int, n_real: int,
                  num_heads: int, head_dim: int, softmax_shift, shift_mode,
                  qk_int8: bool, pv_int8: bool, exp_bf16: bool, what: str,
                  route: str | None = None):
    """Launch K4 (np_ = n_real = the rows per image) or K5 on qkv into the
    codes oq and scales os_. The int8 legs take ``i8_plan``'s route;
    ``route`` forces one (the card tests compare the two routes bit for
    bit), and the C entry refuses a short route that does not fit."""
    scale = 1.0 / math.sqrt(head_dim)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    legs = int(qk_int8) | 2 * int(pv_int8)
    if legs:
        route = route or i8_plan(n_real, head_dim, legs)[0]
    scratch = None
    if route == "long":  # the head's codes, written and read by the launch
        scratch = torch.empty(
            images * num_heads * i8_long_scratch_bytes(n_real, head_dim, legs),
            dtype=torch.uint8, device=qkv.device)
    with torch.cuda.device(qkv.device):
        if legs:
            rc = lib.cvt_attention_quant_i8(
                qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, images,
                np_, n_real, num_heads, head_dim, scale, legs,
                I8_ROUTES.index(route), stream)
        else:
            kind, fixed = _shift(shift_mode, softmax_shift, head_dim)
            mode = SHIFT_MODES[kind] + (_EXP_BF16_FLAG if exp_bf16 else 0)
            if np_ == n_real:
                rc = lib.cvt_attention_quant(
                    qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(), images,
                    np_, num_heads, head_dim, scale, fixed, mode, stream)
            else:
                rc = lib.cvt_attention_quant_flat(
                    qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(), images,
                    np_, n_real, num_heads, head_dim, scale, fixed, mode,
                    stream)
    _build.check(rc, what + (f" (int8 legs, {route} route)" if legs else ""))
    global QUANT_I8_LAUNCHES, QUANT_I8_LONG_LAUNCHES
    QUANT_I8_LAUNCHES += bool(legs)
    QUANT_I8_LONG_LAUNCHES += bool(legs) and route == "long"


def fused_qkv_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None,
                              shift_mode: str = "bound", qk_int8: bool = False,
                              pv_int8: bool = False, exp_bf16: bool = False):
    """(B, N, 3*H*Dh) packed qkv -> (int8 (B, N, H*Dh), f32 (B, N, 1)).

    As the JAX function of this name, whose keywords these are: softmax_shift,
    a calibrated per-layer shift (``ops/quant.py`` ``calibrate_attn_shifts``),
    overrides shift_mode (``CHESS_VISION_ATTN_SOFTMAX``: "bound", the
    default, "fixed" or "max"); qk_int8 / pv_int8 (``CHESS_VISION_ATTN_QK``
    int8 / int8pv) run the int8 legs; exp_bf16 (``CHESS_VISION_ATTN_EXP``)
    the bf16 exp. A CPU tensor takes ``reference_attention_quant``; a CUDA
    tensor launches the kernel (bf16, head dim 16, 32 or 64) or raises. The
    int8 legs take any token count, on one of two routes of the same
    arithmetic (``i8_plan``): a head's codes held in a block's shared memory
    where they fit, else coded once into a device scratch and streamed
    through a block's shared memory in 64-key tiles; the two give the same
    bits."""
    if qkv.device.type == "cpu":
        return reference_attention_quant(qkv, num_heads, softmax_shift,
                                         shift_mode, qk_int8, pv_int8,
                                         exp_bf16)
    head_dim = _check_kernel_input(qkv, num_heads, (torch.bfloat16,),
                                   QUANT_HEAD_DIMS)
    B, N, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    kind, _ = _shift(shift_mode, softmax_shift, head_dim)
    oq = torch.empty((B, N, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((B, N, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    _launch_quant(qkv, oq, os_, B, N, N, num_heads, head_dim, softmax_shift,
                  shift_mode, qk_int8, pv_int8,
                  _block_exp_bf16(exp_bf16, kind, N), "quantizing attention")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return oq, os_


def _flat_images(qkv: torch.Tensor, images: int, n_real: int) -> int:
    """Check the flat stream's shape; returns NP, the rows per image."""
    if qkv.dim() != 2 or images < 1 or qkv.shape[0] % images:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not {images} images of "
                         "equally many rows")
    NP = qkv.shape[0] // images
    if not 1 <= n_real <= NP:
        raise ValueError(f"n_real {n_real} outside 1..{NP} rows per image")
    return NP


def reference_attention_quant_flat(qkv: torch.Tensor, images: int,
                                   n_real: int, num_heads: int,
                                   softmax_shift: float | None = None,
                                   shift_mode: str = "bound",
                                   qk_int8: bool = False,
                                   pv_int8: bool = False,
                                   exp_bf16: bool = False):
    """Plain PyTorch version of the flat quantizing attention: (images * NP,
    3*H*Dh) -> (int8 (images * NP, H*Dh), f32 (images * NP, 1)), keys at
    token index >= n_real masked (and left out of the bound's key norms); see
    ``_attention_quant_plain``. A padded query row attends to the real keys
    like any other row: what it holds stays in its own output row. The JAX
    flat kernel has no wide-exp path: exp_bf16 holds in every mode."""
    NP = _flat_images(qkv, images, n_real)
    oq, os_ = _attention_quant_plain(qkv.reshape(images, NP, -1), n_real,
                                     num_heads, softmax_shift, shift_mode,
                                     qk_int8, pv_int8, exp_bf16)
    return oq.reshape(images * NP, -1), os_.reshape(images * NP, 1)


def fused_qkv_attention_quant_flat(qkv: torch.Tensor, images: int,
                                   n_real: int, num_heads: int,
                                   softmax_shift: float | None = None,
                                   shift_mode: str = "bound",
                                   qk_int8: bool = False,
                                   pv_int8: bool = False,
                                   exp_bf16: bool = False):
    """(images * NP, 3*H*Dh) flat packed qkv -> (int8 (images * NP, H*Dh),
    f32 (images * NP, 1)): the quantizing attention of the ``"flat"`` int8
    layout. Each image holds NP rows of which the first ``n_real`` are
    tokens; keys at index >= n_real take no part in any row's softmax.

    The keywords as for ``fused_qkv_attention_quant``; the int8 legs take
    its two routes by ``n_real`` (``i8_plan``), V's column scales over all NP
    rows of an image on either. A CPU tensor takes
    ``reference_attention_quant_flat``; a CUDA tensor launches the kernel
    (bf16, head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention_quant_flat(qkv, images, n_real, num_heads,
                                              softmax_shift, shift_mode,
                                              qk_int8, pv_int8, exp_bf16)
    NP = _flat_images(qkv, images, n_real)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    head_dim = _check_kernel_input(qkv.view(images, NP, -1), num_heads,
                                   (torch.bfloat16,), QUANT_HEAD_DIMS)
    M, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    _shift(shift_mode, softmax_shift, head_dim)
    oq = torch.empty((M, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((M, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    _launch_quant(qkv, oq, os_, images, NP, n_real, num_heads, head_dim,
                  softmax_shift, shift_mode, qk_int8, pv_int8, exp_bf16,
                  "flat quantizing attention")
    global FLAT_LAUNCHES
    FLAT_LAUNCHES += 1
    return oq, os_
