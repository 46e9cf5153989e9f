"""int8 (W8A8) GEMM with the serving path's fused epilogues.

Counterpart of ``chess_vision_tpu/ops/int8_matmul.py``. Every function takes
activations as (..., K) int8 rows with (..., 1) f32 per-row scales, so each
stands for both the JAX package's per-image kernel and its flat twin:

  int8_matmul_gelu_quant    yq, ys = rowquant(gelu(y))               K8, K11
  int8_matmul_res_ln_quant  x' = bf16(res + y); yq, ys = rowquant(LN(x'))
                                                                     K9, K12
  int8_matmul_res           x' = bf16(res + y)                       K10, K13
  int8_matmul_scale_bias    bf16(y), the qkv product (``quant_dense_q``,
                            which the JAX package leaves to XLA)

with y = f32(xq @ wq) * xs * ws + bias. ``int8_matmul_gelu_quant(...,
bf16_epilogue=True)`` is K8 in the JAX package's bf16 epilogue
(``CHESS_VISION_EPILOGUE=bf16``, ``_gelu_quant_kernel``'s ``bf16_epi``):
the GELU on bf16 values (``gelu_bf16``) and the amax in bf16, the codes from
f32. The JAX flat kernel K11 has no such epilogue, so the flat layout never
passes it. Weights are int8 stored (O, K), K
contiguous (``convert/jax_params.int8_pack_from_jax``). On a CUDA tensor each
runs the hand-written kernel ``csrc/int8_matmul.cu``; on a CPU tensor its
plain version (``*_plain``), the same arithmetic in PyTorch with an exact
int32 product.

K9 runs on thread-block clusters (``res_cluster_blocks``): the blocks that
compute one 64-row panel's column tiles form a cluster, in which the
LayerNorm reads the panel's x' from the blocks' shared memory; rows wider
than 8 column tiles (2,048 columns) take the two-launch route, the product,
then the row pass of ``rowquant``. K10 is one kernel of one block per SM
(``res_route``).
"""

from __future__ import annotations

import ctypes

import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import rowquant as rq

# Kernel launches per epilogue since the last reset (chip_smoke.py proves the
# main path went through the kernel with them).
LAUNCHES = {"scale_bias": 0, "gelu_quant": 0, "res_ln_quant": 0, "res": 0}
BF16_EPILOGUE_LAUNCHES = 0  # of LAUNCHES["gelu_quant"], the bf16 epilogue's

GELUS = {"erf": 0, "sigmoid": 1, "hard": 2}
_BF16_GELU = 3  # kGeluBf16 in csrc/int8_gemm.cuh: + the form, the bf16 epilogue
_EPILOGUES = {"scale_bias": 0, "res": 1, "res_ln_quant": 2, "gelu_quant": 3}
_GELU_FNS = {"erf": rq.gelu_erf, "sigmoid": rq.gelu_sigmoid_div,
             "hard": rq.gelu_hard}
_MAX_ROWS = 2**31 - 65  # the kernel's row coordinates are 32-bit
# K9's clusters, as csrc/int8_matmul.cu res_route sets them
TILE_N = 256      # columns of an output tile (kTileN)
CLUSTER_MAX = 8   # blocks in the largest portable cluster (kClusterMax)


def res_cluster_blocks(o: int) -> int:
    """Blocks in the cluster that computes an o-wide K9, one column tile
    each; 0 means the two-launch route (more than CLUSTER_MAX column
    tiles). K10 needs no cluster: one block per SM walks its tiles."""
    tiles_n = -(-o // TILE_N)
    return tiles_n if tiles_n <= CLUSTER_MAX else 0


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of (M, K) int8 rows with (O, K) int8 weights.

    Never through f32: 127^2 * 3072 ~ 5.0e7 exceeds 2^24. (On CUDA
    ``torch._int_mm`` takes more than 16 rows.)"""
    return torch._int_mm(xq, wq.t())


def _rescaled(xq, xs, wq, ws, bias) -> torch.Tensor:
    """(..., K) int8 -> (..., O) f32: ((acc * xs) * ws) + bias, JAX order."""
    K = xq.shape[-1]
    acc = int8_mm(xq.reshape(-1, K), wq).reshape(*xq.shape[:-1], wq.shape[0])
    return acc.float() * xs.float() * ws.float() + bias.float()


def int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias) -> torch.Tensor:
    return _rescaled(xq, xs, wq, ws, bias).to(torch.bfloat16)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def gelu_bf16(y: torch.Tensor, gelu: str) -> torch.Tensor:
    """The GELU of the bf16 epilogue, as the JAX kernel computes
    ``_gelu(y.astype(bf16))`` on the CPU: y rounded to bf16, each operation
    on bf16 values with its constant rounded to bf16 and its result rounded
    to bf16, but the last, whose f32 value is returned (XLA computes a bf16
    operation in f32 and drops a rounding to bf16 that is converted straight
    back to f32, as the codes' ``g.astype(f32)`` does). f32 in, f32 out."""
    x = _bf16(y.float())
    if gelu == "sigmoid":  # x / (1 + exp(-1.702 x))
        return x / _bf16(1.0 + _bf16(torch.exp(_bf16(-1.703125 * x))))
    if gelu == "hard":  # x * clip(0.4255 x + 0.5, 0, 1)
        return x * torch.clamp(_bf16(_bf16(0.42578125 * x) + 0.5), 0.0, 1.0)
    z = _bf16(x * 0.70703125)
    az = z.abs()
    t = _bf16(1.0 / _bf16(1.0 + _bf16(0.328125 * az)))
    p = _bf16(-1.453125 + _bf16(t * 1.0625))
    for a in (1.421875, -0.28515625, 0.25390625):
        p = _bf16(a + _bf16(t * p))
    poly = _bf16(t * p)
    erf = _bf16(torch.sign(z) * _bf16(1.0 - _bf16(poly * _bf16(torch.exp(_bf16(-az * az))))))
    return _bf16(0.5 * x) * _bf16(1.0 + erf)


def int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu: str = "erf",
                                 bf16_epilogue: bool = False):
    y = _rescaled(xq, xs, wq, ws, bias)
    if not bf16_epilogue:
        return rq.quantize_rows(_GELU_FNS[gelu](y))
    g = gelu_bf16(y, gelu)
    # the amax in bf16 (the rounded max |g|), the codes from the f32 g
    amax = _bf16(g.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-8)
    inv = torch.full_like(amax, 127.0) / amax  # fl(127 / amax), as the kernel
    q = torch.round(g * inv).clamp(-127, 127).to(torch.int8)
    return q, amax * (1.0 / 127.0)


def int8_matmul_res_plain(xq, xs, wq, ws, bias, res) -> torch.Tensor:
    return (res.float() + _rescaled(xq, xs, wq, ws, bias)).to(res.dtype)


def int8_matmul_res_ln_quant_plain(xq, xs, wq, ws, bias, res, ln_scale,
                                   ln_bias, eps: float = 1e-6):
    # LayerNorm of the stored (bf16-rounded) residual, as the JAX kernel
    x = int8_matmul_res_plain(xq, xs, wq, ws, bias, res)
    yq, ys = rq.rowquant_plain(x, "ln", ln_scale, ln_bias, eps)
    return x, yq, ys


def _launch(epilogue: str, xq, xs, wq, ws, bias, res=None, gelu="erf",
            ln_scale=None, ln_bias=None, eps=1e-6, bf16_epilogue=False):
    """Check the operands, allocate the outputs, launch; returns the outputs
    of the epilogue."""
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype}, {wq.dtype}")
    if gelu not in GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; expected one of {list(GELUS)}")
    K = xq.shape[-1]
    O = wq.shape[0]
    M = xq.numel() // K if K else 0
    if wq.dim() != 2 or wq.shape[1] != K or wq.device != dev:
        raise ValueError(f"wq {tuple(wq.shape)} on {wq.device} is not (O, {K}) "
                         f"on {dev}")
    if K % 16 or K < 16 or O % 8 or O < 8:
        raise ValueError(f"K={K} must be a multiple of 16, O={O} of 8")
    if M > _MAX_ROWS:
        raise ValueError(f"{M} rows exceed the kernel's grid")
    if xs.shape != (*xq.shape[:-1], 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be f32 {(*xq.shape[:-1], 1)}, got "
                         f"{xs.dtype} {tuple(xs.shape)}")
    out_shape = (*xq.shape[:-1], O)
    if res is not None and (res.shape != out_shape or res.dtype != torch.bfloat16):
        raise ValueError(f"res must be bf16 {out_shape}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    for name, t in (("xq", xq), ("xs", xs), ("wq", wq), ("res", res)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    # the kernel reads four columns' scales and biases in one 16-byte load
    ws, bias = (v.clone() if v.data_ptr() % 16 else v for v in
                (rq.f32_vector(ws, O, dev, "ws"),
                 rq.f32_vector(bias, O, dev, "bias")))
    g = b = yq = ys = None
    if epilogue == "res_ln_quant":
        g = rq.f32_vector(ln_scale, O, dev, "ln_scale")
        b = rq.f32_vector(ln_bias, O, dev, "ln_bias")
    if epilogue == "gelu_quant":
        # the kernel's scratch: the rows' max |gelu(y)| and, per 64 rows, a
        # count of the warps that have added theirs
        out = torch.empty((M + -(-M // 64),), dtype=torch.float32, device=dev)
    else:
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
    if epilogue in ("res_ln_quant", "gelu_quant"):
        yq = torch.empty(out_shape, dtype=torch.int8, device=dev)
        ys = torch.empty((*xq.shape[:-1], 1), dtype=torch.float32, device=dev)
    if M:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.cvt_int8_matmul(
                xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                bias.data_ptr(), ptr(res), out.data_ptr(), M, K, O,
                _EPILOGUES[epilogue],
                GELUS[gelu] + (_BF16_GELU if bf16_epilogue else 0),
                ptr(g), ptr(b), eps,
                ptr(yq), ptr(ys), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"int8 matmul ({epilogue})")
        LAUNCHES[epilogue] += 1
        global BF16_EPILOGUE_LAUNCHES
        BF16_EPILOGUE_LAUNCHES += bf16_epilogue
    return out, yq, ys


def int8_matmul_scale_bias(xq, xs, wq, ws, bias) -> torch.Tensor:
    """qkv: (..., K) int8 rows -> bf16 (..., O) = bf16(y)."""
    if xq.device.type == "cpu":
        return int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias)
    return _launch("scale_bias", xq, xs, wq, ws, bias)[0]


def int8_matmul_gelu_quant(xq, xs, wq, ws, bias, gelu: str = "erf",
                           bf16_epilogue: bool = False):
    """fc1 + GELU ("erf", "sigmoid" or "hard") + requant: (..., K) int8 rows
    -> (int8 (..., O), f32 (..., 1)); bf16_epilogue: the JAX bf16 epilogue
    (module docstring)."""
    if xq.device.type == "cpu":
        return int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu,
                                            bf16_epilogue)
    _, yq, ys = _launch("gelu_quant", xq, xs, wq, ws, bias, gelu=gelu,
                        bf16_epilogue=bf16_epilogue)
    return yq, ys


def int8_matmul_res_ln_quant(xq, xs, wq, ws, bias, res, ln_scale, ln_bias,
                             eps: float = 1e-6):
    """proj/fc2 + residual + next LayerNorm + requant: returns (x' bf16
    (..., O), yq int8 (..., O), ys f32 (..., 1)), yq/ys quantizing LN(x')."""
    if xq.device.type == "cpu":
        return int8_matmul_res_ln_quant_plain(xq, xs, wq, ws, bias, res,
                                              ln_scale, ln_bias, eps)
    return _launch("res_ln_quant", xq, xs, wq, ws, bias, res=res,
                   ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)


def int8_matmul_res(xq, xs, wq, ws, bias, res) -> torch.Tensor:
    """Last fc2 + residual: x' = bf16(res + y), (..., O)."""
    if xq.device.type == "cpu":
        return int8_matmul_res_plain(xq, xs, wq, ws, bias, res)
    return _launch("res", xq, xs, wq, ws, bias, res=res)[0]


ROUTES = ("two_launch", "tiles", "cluster")  # csrc/int8_matmul.cu ResRoute


def res_route(o: int, epilogue: str = "res_ln_quant", device="cuda") -> dict:
    """On the card: the route of an o-wide residual product, from the
    kernel library. ``route``: "cluster" (K9: one kernel on clusters of
    ``cluster_blocks`` blocks, ``count`` of them on the card at once by
    ``cudaOccupancyMaxActiveClusters``), "tiles" (K10: one kernel, ``count``
    blocks, one per SM, no cluster) or "two_launch" (the product, then for
    K9 the row pass); ``smem_bytes``: a block's dynamic shared memory."""
    if epilogue not in ("res", "res_ln_quant"):
        raise ValueError(f"{epilogue!r} is not a residual epilogue")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    info = (ctypes.c_int * 4)()
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.cvt_int8_res_route(o, _EPILOGUES[epilogue], ctypes.addressof(info))
    _build.check(rc, f"int8 matmul route ({epilogue}, o={o})")
    return {"route": ROUTES[info[0]], "cluster_blocks": info[1],
            "count": info[2], "smem_bytes": info[3]}


# the forms gelu_selftest takes: the epilogue's, and the row quant's (K7)
# sigmoid GELU x * (1 / d)
SELFTEST_GELUS = {**GELUS, "sigmoid_mul": 3}


def gelu_selftest(n: int, gelu: str = "sigmoid", device="cuda") -> int:
    """On the card: the four-at-a-time GELU with the branch-free division
    (the GEMM epilogue's; ``sigmoid_mul``, the row quant's sigmoid form)
    against the scalar GELU of the other kernels on 4 * n values; returns how
    many differ in any bit (0 is the contract)."""
    if gelu not in SELFTEST_GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; expected one of "
                         f"{list(SELFTEST_GELUS)}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.cvt_gelu_selftest(n, SELFTEST_GELUS[gelu], bad.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gelu self-test")
    return int(bad.item())
