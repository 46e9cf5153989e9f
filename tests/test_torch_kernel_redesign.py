"""What can go wrong in the redesigned kernels before the card is reached.

The CUDA kernels run only on the card; what they are built from can be
checked here in plain PyTorch and numpy:

- the schedule of ``csrc/attention_bwd.cu`` (one block per head; sweep 1
  walks the keys 32 at a time with an online max-shifted sum and leaves
  (shift, 1/l, r) per row; sweep 2 walks them again, forms pn and dS per
  (16-row block, 32-key step), adds dS K into dQ and sums dS^T Q and pn^T g
  over the row blocks; 16-row and 16-key granularity at the ragged edge),
  emulated in f32 against ``reference_attention_bwd`` (1e-5: summation order
  only) and against the JAX package's Pallas kernel in interpret mode (1e-5 in
  f32, the bound ``tests/test_torch_attention_bwd.py`` states);
- the scheme of K8 in ``csrc/int8_matmul.cu`` (64 x 256 tiles computed once
  and kept as f32; per-tile row maxima of |gelu(y)| folded with a max across
  the tiles of a 64-row panel, then codes from the kept f32 values), emulated
  against ``int8_matmul_gelu_quant_plain`` bit for bit, and the epilogue's
  rounding trick (clip, then add 1.5 * 2^23) against clip(rint(.));
- the ctypes signatures of ``ops/_build.py`` against the ``extern "C"``
  definitions in ``csrc/*.cu``: a mismatch corrupts pointers on the card.
"""

import glob
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops.attention import _kernel_attention_bwd
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

CHUNK = 32   # keys per step (kChunk)
WARPS = 9    # warp w owns row blocks w and w + 9


def k3_schedule(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The arithmetic of csrc/attention_bwd.cu in f32, block by block."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    Dh = D // num_heads
    assert N <= attn.BWD_MAX_TOKENS
    scale = 1.0 / math.sqrt(Dh)
    scale_log2 = scale * 1.4426950408889634
    nblk = -(-N // 16)
    NP = nblk * 16
    out = torch.zeros_like(qkv)
    for b in range(B):
        for h in range(num_heads):
            pad = lambda t: torch.cat([t, t.new_zeros(NP - N, Dh)])  # noqa: E731
            q, k, v = (pad(qkv[b, :, i * D + h * Dh:i * D + (h + 1) * Dh])
                       for i in range(3))
            go = pad(g[b, :, h * Dh:(h + 1) * Dh])
            # sweep 1: online statistics per 16-row block, 32 keys a step
            shift, inv, rr = (torch.zeros(NP) for _ in range(3))
            for blk in range(nblk):
                rows = slice(blk * 16, blk * 16 + 16)
                m = torch.full((16,), -math.inf)
                l = torch.zeros(16)
                racc = torch.zeros(16)
                for k0 in range(0, N, CHUNK):
                    s = _chunk(q[rows], k, k0, N, NP)
                    dp = _chunk(go[rows], v, k0, N, NP)
                    s[:, torch.arange(k0, k0 + CHUNK) >= N] = -math.inf
                    mx = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2((m - mx) * scale_log2)
                    p = torch.exp2(s * scale_log2 - (mx * scale_log2)[:, None])
                    l = l * alpha + p.sum(dim=1)
                    racc = racc * alpha + (dp * p).sum(dim=1)
                    m = mx
                real = torch.arange(blk * 16, blk * 16 + 16) < N
                shift[rows] = torch.where(real, m * scale_log2, 0.0)
                inv[rows] = torch.where(real, 1.0 / l, 0.0)
                rr[rows] = torch.where(real, racc / l, 0.0)
            # sweep 2
            dq = torch.zeros(NP, Dh)
            dk = torch.zeros(NP, Dh)
            dv = torch.zeros(NP, Dh)
            for k0 in range(0, N, CHUNK):
                pn_t = torch.zeros(NP, CHUNK)
                ds_t = torch.zeros(NP, CHUNK)
                for w in range(WARPS):
                    for blk in (w, w + WARPS):
                        if blk >= nblk:
                            continue
                        rows = slice(blk * 16, blk * 16 + 16)
                        s = _chunk(q[rows], k, k0, N, NP)
                        dp = _chunk(go[rows], v, k0, N, NP)
                        pn = torch.exp2(s * scale_log2 - shift[rows, None]) * inv[rows, None]
                        pn[:, torch.arange(k0, k0 + CHUNK) >= N] = 0.0
                        ds = pn * (dp - rr[rows, None]) * scale
                        pn_t[rows], ds_t[rows] = pn, ds
                        for half in range(2):  # dQ += dS K, 16 keys at a time
                            if k0 + half * 16 < N:
                                ks = slice(k0 + half * 16, k0 + half * 16 + 16)
                                dq[rows] += ds[:, half * 16:half * 16 + 16] @ k[ks]
                for half in range(2):  # phase B: over all row blocks, in order
                    if k0 + half * 16 >= N:
                        continue
                    ks = slice(k0 + half * 16, k0 + half * 16 + 16)
                    cols = slice(half * 16, half * 16 + 16)
                    for blk in range(nblk):
                        rows = slice(blk * 16, blk * 16 + 16)
                        dk[ks] += ds_t[rows, cols].T @ q[rows]
                        dv[ks] += pn_t[rows, cols].T @ go[rows]
            for i, t in enumerate((dq, dk, dv)):
                out[b, :, i * D + h * Dh:i * D + (h + 1) * Dh] = t[:N]
    return out


def _chunk(a, full, k0, N, NP):
    """a (16, Dh) against rows k0 .. k0 + 31 of ``full``, 16 keys at a time; a
    half whose keys all lie past N is skipped and stays 0, as in the kernel."""
    s = torch.zeros(a.shape[0], CHUNK)
    for half in range(2):
        lo = k0 + half * 16
        if lo < N:
            s[:, half * 16:half * 16 + 16] = a @ full[lo:lo + 16].T
    return s


@pytest.mark.parametrize("N", [17, 64, 65, 257])
def test_k3_schedule_matches_reference_and_jax_kernel(N):
    for H, Dh in ((2, 16), (1, 64)):
        rng = np.random.default_rng(N + Dh)
        qkv = rng.normal(size=(1, N, 3 * H * Dh)).astype(np.float32)
        g = rng.normal(size=(1, N, H * Dh)).astype(np.float32)
        ours = k3_schedule(torch.from_numpy(qkv), torch.from_numpy(g), H)
        ref = attn.reference_attention_bwd(torch.from_numpy(qkv),
                                           torch.from_numpy(g), H)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5)
        kernel = np.asarray(_kernel_attention_bwd(
            jnp.asarray(qkv), jnp.asarray(g), H, interpret=True))
        np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-5)


def k8_scheme(xq, xs, wq, ws, bias, gelu: str):
    """csrc/int8_matmul.cu's K8: the blocks of a group compute the 64 x 256
    tiles of one 64-row panel and keep gelu(y) as f32, each folds its tile's
    row maxima of |gelu(y)| into a zeroed (M,) vector with a max, and when all
    have, each writes its codes from the kept values."""
    M, O = xq.shape[0], wq.shape[0]
    tile_m, tile_n = 64, 256
    fn = mm._GELU_FNS[gelu]
    amax = torch.zeros(M)
    yq = torch.empty((M, O), dtype=torch.int8)
    for m0 in range(0, M, tile_m):  # a panel: its tiles run at the same time
        rows = slice(m0, m0 + tile_m)
        kept = {}
        for n0 in range(0, O, tile_n):
            acc = mm.int8_mm(xq[rows], wq[n0:n0 + tile_n])
            kept[n0] = fn(acc.float() * xs[rows] * ws[n0:n0 + tile_n]
                          + bias[n0:n0 + tile_n])
            amax[rows] = torch.maximum(amax[rows], kept[n0].abs().amax(dim=1))
        inv = 127.0 / amax[rows].clamp_min(1e-8)
        for n0, tile in kept.items():
            codes = torch.round(tile * inv[:, None]).clamp(-127, 127)
            yq[rows, n0:n0 + tile_n] = codes.to(torch.int8)
    return yq, (amax.clamp_min(1e-8) * np.float32(1.0 / 127.0))[:, None]


@pytest.mark.parametrize("gelu", ["erf", "sigmoid", "hard"])
def test_k8_scheme_equals_plain_bit_for_bit(gelu):
    rng = np.random.default_rng(7)
    M, K, O = 150, 80, 328  # O is not a multiple of the 256-column tile
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (O, K), dtype=np.int8))
    xs = torch.from_numpy(rng.uniform(0.002, 0.022, (M, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(2e-4, 6e-4, O).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, O).astype(np.float32))
    yq, ys = k8_scheme(xq, xs, wq, ws, bias, gelu)
    rq_, rs = mm.int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu)
    assert torch.equal(yq, rq_)
    assert torch.equal(ys, rs)


def test_magic_rounding_equals_rint_then_clip():
    """quant1_byte: clip to [-127, 127], add 1.5 * 2^23 in f32, keep the low
    byte of the bits: the code of clip(rint(x), -127, 127), ties to even."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-140, 140, 200_000), np.arange(-130, 131) + 0.5,
        np.arange(-130, 131), [-0.0, 0.0, 1e-30, -1e30, 1e30]]).astype(np.float32)
    want = np.clip(np.rint(x), -127, 127).astype(np.int8)  # rint: ties to even
    inside = np.abs(x) <= 127  # there a row with abs-max 127 quantizes to itself
    row = torch.from_numpy(np.append(x[inside], np.float32(127.0)))[None]
    np.testing.assert_array_equal(rq.quantize_rows(row)[0][0, :-1].numpy(),
                                  want[inside])
    clipped = np.clip(x, np.float32(-127), np.float32(127))
    bits = (clipped + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    codes = (bits & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(codes, want)


def test_ctypes_signatures_match_the_extern_c_definitions():
    """Each name in ``_build._SIGNATURES`` is defined ``extern "C"`` in
    ``csrc/*.cu`` with as many parameters, and the other way round."""
    defined = {}
    for path in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")):
        text = re.sub(r"//[^\n]*", "", open(path).read())
        for name, params in re.findall(
                r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)\s*\{', text):
            defined[name] = len([p for p in params.split(",") if p.strip()])
    assert defined, "no extern \"C\" definition found"
    declared = {name: len(args) for name, args in _build._SIGNATURES.items()}
    assert declared == defined
    assert set(_build._RESTYPES) <= set(declared)
