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
``reference_attention_quant`` is its plain version.
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
    softmax scale into q and honours a fixed shift)."""
    return math.frexp(x)[0] == 0.5


def _fixed_shift(softmax_shift: float | None, head_dim: int) -> bool:
    """Whether a calibrated shift is used as given. The JAX kernel uses it
    only where the softmax scale folds exactly (``_attn_quant_image``); other
    head dims keep the exact row max."""
    return softmax_shift is not None and _pow2(1.0 / math.sqrt(head_dim))


def _attention_quant_plain(qkv: torch.Tensor, n_real: int, num_heads: int,
                           softmax_shift: float | None):
    """(B, N, 3*H*Dh) -> (int8 (B, N, H*Dh), f32 (B, N, 1)), keys at token
    index >= n_real masked: the arithmetic shared by the plain versions of
    K4 (n_real = N) and K5.

    f32 scores; a masked key's score is -1e30, so its p is exactly 0;
    p = exp(s - shift) rounded to the input dtype feeds both P V and the row
    sum (the JAX kernel's ones column of V); the output is
    P V / max(rowsum, 1e-30) in f32, then quantized per token over all
    heads. The shift is ``softmax_shift`` where the JAX kernel takes it as a
    fixed shift, else the exact row max."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    head_dim = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(head_dim))
    if n_real < N:
        s[..., n_real:] = -1e30
    if _fixed_shift(softmax_shift, head_dim):
        shift = float(softmax_shift)
    else:
        shift = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - shift).to(qkv.dtype).float()
    rowsum = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, N, H, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / rowsum.clamp_min(1e-30)
    return quantize_rows(o.reshape(B, N, D))


def reference_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None):
    """Plain PyTorch version of the quantizing attention: (B, N, 3*H*Dh) ->
    (int8 (B, N, H*Dh), f32 (B, N, 1)); see ``_attention_quant_plain``."""
    return _attention_quant_plain(qkv, qkv.shape[1], num_heads, softmax_shift)


def _check_quant_shape(D: int, num_heads: int) -> None:
    if D % 8 or D > 4096:
        raise ValueError(f"model width {D} must be a multiple of 8 up to 4096")
    if num_heads > QUANT_MAX_HEADS:
        raise ValueError(f"{num_heads} heads exceed the quantizing attention's "
                         f"{QUANT_MAX_HEADS} (one thread-block cluster holds "
                         "every head of a row chunk)")


def fused_qkv_attention_quant(qkv: torch.Tensor, num_heads: int,
                              softmax_shift: float | None = None):
    """(B, N, 3*H*Dh) packed qkv -> (int8 (B, N, H*Dh), f32 (B, N, 1)).

    softmax_shift: a calibrated per-layer shift (``ops/quant.py``
    ``calibrate_attn_shifts``), else the exact row max. A CPU tensor takes
    ``reference_attention_quant``; a CUDA tensor launches the kernel (bf16,
    head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention_quant(qkv, num_heads, softmax_shift)
    head_dim = _check_kernel_input(qkv, num_heads, (torch.bfloat16,),
                                   QUANT_HEAD_DIMS)
    B, N, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    fixed = _fixed_shift(softmax_shift, head_dim)
    oq = torch.empty((B, N, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((B, N, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        rc = lib.cvt_attention_quant(
            qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
            B, N, num_heads, head_dim, 1.0 / math.sqrt(head_dim),
            float(softmax_shift) if fixed else 0.0, int(fixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "quantizing attention")
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
                                   softmax_shift: float | None = None):
    """Plain PyTorch version of the flat quantizing attention: (images * NP,
    3*H*Dh) -> (int8 (images * NP, H*Dh), f32 (images * NP, 1)), keys at
    token index >= n_real masked; see ``_attention_quant_plain``. A padded
    query row attends to the real keys like any other row: what it holds
    stays in its own output row."""
    NP = _flat_images(qkv, images, n_real)
    oq, os_ = _attention_quant_plain(qkv.reshape(images, NP, -1), n_real,
                                     num_heads, softmax_shift)
    return oq.reshape(images * NP, -1), os_.reshape(images * NP, 1)


def fused_qkv_attention_quant_flat(qkv: torch.Tensor, images: int,
                                   n_real: int, num_heads: int,
                                   softmax_shift: float | None = None):
    """(images * NP, 3*H*Dh) flat packed qkv -> (int8 (images * NP, H*Dh),
    f32 (images * NP, 1)): the quantizing attention of the ``"flat"`` int8
    layout. Each image holds NP rows of which the first ``n_real`` are
    tokens; keys at index >= n_real take no part in any row's softmax.

    softmax_shift as for ``fused_qkv_attention_quant``. A CPU tensor takes
    ``reference_attention_quant_flat``; a CUDA tensor launches the kernel
    (bf16, head dim 16, 32 or 64) or raises."""
    if qkv.device.type == "cpu":
        return reference_attention_quant_flat(qkv, images, n_real, num_heads,
                                              softmax_shift)
    NP = _flat_images(qkv, images, n_real)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    head_dim = _check_kernel_input(qkv.view(images, NP, -1), num_heads,
                                   (torch.bfloat16,), QUANT_HEAD_DIMS)
    M, C3 = qkv.shape
    D = C3 // 3
    _check_quant_shape(D, num_heads)
    fixed = _fixed_shift(softmax_shift, head_dim)
    oq = torch.empty((M, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((M, 1), dtype=torch.float32, device=qkv.device)
    if oq.numel() == 0:
        return oq, os_
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        rc = lib.cvt_attention_quant_flat(
            qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
            images, NP, n_real, num_heads, head_dim,
            1.0 / math.sqrt(head_dim),
            float(softmax_shift) if fixed else 0.0, int(fixed),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flat quantizing attention")
    global FLAT_LAUNCHES
    FLAT_LAUNCHES += 1
    return oq, os_
