"""The int8 legs' long route as redesigned for Hopper (``csrc/
attention_quant_long.cu``: the head coded once into a device scratch, then
passes of ``32 * _I8_LONG_WARPS`` rows whose walks stream its 64-key tiles
through a ring) on the card: bit for bit against the short route where both
take a head, against the plain version past the short route's limit. They
skip without a CUDA device. On a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_i8_long_redesign_cuda.py -q

Tolerances: within ``chip_smoke.py``'s ATTN_LEVELS (1.35) quantization steps
of each row of the plain version (phase 27's bound); the routes bit for bit,
since they take every code, scale and sum in the same order.
"""

import pytest
import torch

from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

ATTN_LEVELS = 1.35
LEGS = [{"qk_int8": True}, {"pv_int8": True}, {"qk_int8": True, "pv_int8": True}]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    return torch.device("cuda")


def _qkv(shape, cuda, seed, gain=3.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, device=cuda, generator=g)
    x[..., :shape[-1] // 3] *= gain
    return x.bfloat16()


def _steps(out, ref) -> float:
    (q, s), (rq_, rs) = out, ref
    assert torch.isfinite(s).all()
    return ((q.float() * s - rq_.float() * rs).abs()
            / torch.maximum(s, rs)).amax(dim=-1).max().item()


def _legs(kw) -> int:
    return int(kw.get("qk_int8", False)) | 2 * int(kw.get("pv_int8", False))


def _forced(qkv, images, n_real, heads, kw, route):
    """K4 (qkv 3-D) or K5 (2-D, ``images`` of NP rows) on ``route``."""
    rows = qkv.shape[0] * qkv.shape[1] if qkv.dim() == 3 else qkv.shape[0]
    D = qkv.shape[-1] // 3
    oq = torch.empty((rows, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((rows, 1), dtype=torch.float32, device=qkv.device)
    attn._launch_quant(qkv, oq, os_, images, rows // images, n_real, heads,
                       D // heads, None, "max", kw.get("qk_int8", False),
                       kw.get("pv_int8", False), False, "forced route", route)
    return oq, os_


@pytest.mark.parametrize("n", [257, 960, 1504])
def test_long_route_is_the_short_route_bit_for_bit(cuda, n):
    """At 257, 960 and 1,504 keys, 12 heads of 64, every form the short
    route takes there: the long route's codes and scales equal the short
    route's, in K4 and in K5 (32 padded rows an image)."""
    qkv = _qkv((2, n, 3 * 12 * 64), cuda, seed=n)
    np_ = -(-n // 32) * 32 + 32
    padded = _qkv((2, np_, 3 * 12 * 64), cuda, seed=n + 1)
    padded[:, :n] = qkv
    flat = padded.reshape(2 * np_, -1)
    forms = [kw for kw in LEGS if attn.i8_short_fits(n, 64, _legs(kw))]
    assert forms
    for kw in forms:
        for x in (qkv, flat):
            short = _forced(x, 2, n, 12, kw, "short")
            long = _forced(x, 2, n, 12, kw, "long")
            torch.cuda.synchronize()
            assert torch.equal(short[0], long[0]) and torch.equal(short[1], long[1]), (n, kw)


@pytest.mark.parametrize("n", [1601, 2305])
def test_partial_last_pass_and_tile_match_plain(cuda, n):
    """1,601 and 2,305 keys (a last pass of fewer row blocks than the rest,
    a last key tile of one key), 4 heads of 64, each form on the long route
    against the plain version."""
    qkv = _qkv((2, n, 3 * 4 * 64), cuda, seed=n)
    blocks = -(-n // 16)
    passes = -(-blocks // (2 * attn._I8_LONG_WARPS))
    assert blocks % -(-blocks // passes) and n % attn._KEY_TILE == 1
    for kw in LEGS:
        assert attn.i8_plan(n, 64, _legs(kw))[0] == "long"
        out = attn.fused_qkv_attention_quant(qkv, 4, **kw)
        ref = attn.reference_attention_quant(qkv, 4, **kw)
        assert _steps(out, ref) <= ATTN_LEVELS, (n, kw)


def test_k5_padded_rows_past_n_real(cuda):
    """K5 with 1,601 real rows of 1,760 an image (the padded rows a partial
    pass of their own), padded V rows five times larger: against plain, and
    every padded row's scale finite and written."""
    n, np_, H = 1601, 1760, 3
    flat = _qkv((2 * np_, 3 * H * 64), cuda, seed=5).reshape(2, np_, -1)
    flat[:, n:, 2 * H * 64:] *= 5
    flat = flat.reshape(2 * np_, -1)
    for kw in LEGS:
        out = attn.fused_qkv_attention_quant_flat(flat, 2, n, H, **kw)
        ref = attn.reference_attention_quant_flat(flat, 2, n, H, **kw)
        assert _steps(out, ref) <= ATTN_LEVELS, kw
        assert torch.isfinite(out[1]).all() and (out[1] > 0).all()


def test_one_launch_a_call_and_the_scratch_bytes(cuda):
    """One launch a call, counted on the long route; the C entry's scratch
    and shared-memory bytes are the Python plan's."""
    lib = _build.library()
    for n in (257, 1601, 2305):
        for dh in (16, 32, 64):
            for legs in (1, 2, 3):
                assert lib.cvt_attention_quant_i8_scratch(n, dh, legs) == \
                    attn.i8_long_scratch_bytes(n, dh, legs)
                assert lib.cvt_attention_quant_i8_smem(n, dh, legs, 1) == \
                    attn.i8_plan(100000, dh, legs)[1]
    qkv = _qkv((1, 1601, 3 * 2 * 64), cuda, seed=9)
    for kw in LEGS:
        before = attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES
        attn.fused_qkv_attention_quant(qkv, 2, **kw)
        torch.cuda.synchronize()
        assert (attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES) == (
            before[0] + 1, before[1] + 1)


def test_stale_scratch_changes_nothing(cuda):
    """The kernel writes every scratch byte it reads: a call on a scratch
    filled with 0x7f (codes of 127, scales of ~3.4e38) gives the bits of a
    call on a zeroed one, in every form."""
    n, H, dh = 1601, 2, 64
    qkv = _qkv((2, n, 3 * H * dh), cuda, seed=11)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for kw in LEGS:
        legs = _legs(kw)
        outs = []
        for fill in (0, 0x7F):
            scratch = torch.full((2 * H * attn.i8_long_scratch_bytes(n, dh, legs),), fill,
                                 dtype=torch.uint8, device=cuda)
            oq = torch.empty((2, n, H * dh), dtype=torch.int8, device=cuda)
            os_ = torch.empty((2, n, 1), device=cuda)
            _build.check(lib.cvt_attention_quant_i8(
                qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(), scratch.data_ptr(), 2, n, n, H,
                dh, dh ** -0.5, legs, 1, stream), "long route")
            outs.append((oq, os_))
        torch.cuda.synchronize()
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]), kw
