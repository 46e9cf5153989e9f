"""The int8 legs' long route (``attention_quant_i8_long_kernel``: a head
streamed through shared memory in 64-key tiles, coded as they land) on the
card, against the plain PyTorch version and against the short route. They
skip without a CUDA device. On a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_i8_long_cuda.py -q

Tolerances: within ``chip_smoke.py``'s ATTN_LEVELS (1.35) quantization steps
of each row of the plain version (phase 27's bound); the two routes bit for
bit, since they take every code, scale and sum in the same order.
"""

import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

ATTN_LEVELS = 1.35
LEGS = [{"qk_int8": True}, {"pv_int8": True}, {"qk_int8": True, "pv_int8": True}]
LEG_IDS = ["int8", "pv-only", "int8pv"]


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


def _check_both_layouts(qkv, H, kw, cuda, seed, pad_gain=1.0):
    """K4 on qkv and K5 on it padded past n_real (the padded V rows scaled
    by ``pad_gain``) against plain; one launch each on i8_plan's route."""
    B, n, C3 = qkv.shape
    route = attn.i8_plan(n, C3 // 3 // H, _legs(kw))[0]
    before = attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES
    out = attn.fused_qkv_attention_quant(qkv, H, **kw)
    torch.cuda.synchronize()
    assert (attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES) == (
        before[0] + 1, before[1] + (route == "long"))
    assert _steps(out, attn.reference_attention_quant(qkv, H, **kw)) <= ATTN_LEVELS, (n, H)
    np_ = -(-n // 32) * 32 + 32
    padded = _qkv((B, np_, C3), cuda, seed=seed + 1)
    padded[:, n:, 2 * C3 // 3:] *= pad_gain
    padded[:, :n] = qkv
    flat = padded.reshape(B * np_, -1)
    fq, fs = attn.fused_qkv_attention_quant_flat(flat, B, n, H, **kw)
    ref = attn.reference_attention_quant_flat(flat, B, n, H, **kw)
    real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
    assert _steps((real(fq), real(fs)), tuple(real(t) for t in ref)) <= ATTN_LEVELS, (n, H)
    if not kw.get("pv_int8"):  # without V's codes the padded rows change nothing
        assert torch.equal(real(fq), out[0]) and torch.equal(real(fs), out[1])
    return route


@pytest.mark.parametrize("kw", LEGS, ids=LEG_IDS)
def test_long_route_matches_plain_at_head_dim_64(cuda, kw):
    """K4 and K5 at head dim 64 just past each form's limit (961, 1,057,
    1,505 keys) and at ViT-B/16's 640 and 768 px (1,601 and 2,305 tokens),
    2 images, 2-12 heads."""
    routes = [_check_both_layouts(_qkv((2, n, 3 * H * 64), cuda, seed=n), H, kw, cuda, n)
              for n, H in ((961, 2), (1057, 3), (1505, 4), (1601, 12), (2305, 2))]
    assert routes[-2:] == ["long", "long"]
    limit = min({1: 960, 2: 1056, 3: 1504}[_legs(kw)], attn._I8_SHORT_LAST[(64, _legs(kw))])
    assert routes[:3] == ["long" if n > limit else "short" for n in (961, 1057, 1505)]


@pytest.mark.parametrize("dh, n", [(16, 2721), (32, 1729)])
def test_long_route_past_the_limit_at_head_dims_16_and_32(cuda, dh, n):
    """Just past qk_int8's limit at head dims 16 and 32, every form against
    plain; where i8_plan keeps a form on the short route, the long route
    forced at the same length gives its bits."""
    qkv = _qkv((2, n, 3 * 3 * dh), cuda, seed=dh)
    for kw in LEGS:
        if _check_both_layouts(qkv, 3, kw, cuda, dh) == "short":
            short = attn.fused_qkv_attention_quant(qkv, 3, **kw)
            long = _forced(qkv, 2, n, 3, kw, "long")
            assert torch.equal(long[0].view_as(short[0]), short[0])
            assert torch.equal(long[1].view_as(short[1]), short[1])


def test_k5_padded_rows_set_v_scales_on_the_long_route(cuda):
    """K5 past the limit with padded V rows nine times larger than the real
    ones: V's column scales over all NP rows (as the JAX V slab holds them)
    on the long route, as in the plain version."""
    qkv = _qkv((2, 1601, 3 * 4 * 64), cuda, seed=3)
    for kw in LEGS[1:]:
        assert _check_both_layouts(qkv, 4, kw, cuda, 3, pad_gain=9.0) == "long"


@pytest.mark.parametrize("n", [257, 1504])
def test_routes_are_bit_equal(cuda, n):
    """Where both routes take a head (every form at 257 keys; both legs at
    1,504, the short route's last length), the long route's codes and
    scales are the short route's bit for bit, in K4 and in K5."""
    qkv = _qkv((2, n, 3 * 12 * 64), cuda, seed=n)
    np_ = -(-n // 32) * 32 + 32
    padded = _qkv((2, np_, 3 * 12 * 64), cuda, seed=n + 1)
    padded[:, :n] = qkv
    flat = padded.reshape(2 * np_, -1)
    for kw in LEGS:
        if not attn.i8_short_fits(n, 64, _legs(kw)):
            continue
        for x, rows in ((qkv, n), (flat, np_)):
            short = _forced(x, 2, n, 12, kw, "short")
            long = _forced(x, 2, n, 12, kw, "long")
            torch.cuda.synchronize()
            assert torch.equal(short[0], long[0]) and torch.equal(short[1], long[1]), (
                n, rows, kw)


def test_one_launch_a_call_on_its_route(cuda):
    """Each call is one launch, counted on the route it took; the C entry's
    bytes are i8_plan's on both routes, and a short route forced past the
    limit is refused by the entry, not launched."""
    lib = attn._build.library()
    for n in (257, 961, 1504, 1505, 1601):
        for legs in (1, 2, 3):
            route, nbytes = attn.i8_plan(n, 64, legs)
            assert lib.cvt_attention_quant_i8_smem(
                n, 64, legs, attn.I8_ROUTES.index(route)) == nbytes
            if not attn.i8_short_fits(n, 64, legs):
                assert lib.cvt_attention_quant_i8_smem(n, 64, legs, 0) > attn.I8_MAX_SMEM
    qkv = _qkv((1, 1601, 3 * 2 * 64), cuda, seed=9)
    for kw, route in ((LEGS[2], "long"), (LEGS[2], None)):
        before = attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES
        _forced(qkv, 1, 1601, 2, kw, route)
        torch.cuda.synchronize()
        assert (attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
    before = attn.QUANT_I8_LAUNCHES
    with pytest.raises(RuntimeError, match="short route"):
        _forced(qkv, 1, 1601, 2, LEGS[2], "short")
    assert attn.QUANT_I8_LAUNCHES == before
