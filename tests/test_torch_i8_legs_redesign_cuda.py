"""The redesigned int8 legs kernel (``attention_quant_i8_kernel``: a head's
codes made once in shared memory; past a block's shared memory the long
route, held in ``tests/test_torch_i8_long_cuda.py``) and K7's row quant (one
kernel a form, a persistent grid whose warps prefetch their next row) on the
card, against their plain PyTorch versions. They skip without a CUDA device. On a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_i8_legs_redesign_cuda.py -q

Tolerances: the legs within ``chip_smoke.py``'s ATTN_LEVELS (1.35)
quantization steps of each row of the plain version (phase 27's bound);
K7's codes within one level in under 1e-3 of the elements and its scales
rtol 1e-5 (phase 6's), and bit-equal in the form without a pre-op, where
kernel and plain version take the same quotient fl(127 / amax).
"""

import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import rowquant as rq

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


@pytest.mark.parametrize("kw", LEGS, ids=LEG_IDS)
def test_legs_match_plain_at_ragged_shapes(cuda, kw):
    """K4 and K5 at head dims 16, 32 and 64 and token counts that end inside
    a 16-row block, a 32-key group and a 64-key tile, one to four row chunks,
    one launch a call."""
    for B, n, H, dh in ((3, 17, 2, 16), (2, 65, 12, 32), (2, 100, 3, 64),
                        (1, 257, 12, 64), (1, 290, 4, 32), (2, 130, 5, 16)):
        qkv = _qkv((B, n, 3 * H * dh), cuda, seed=n + dh)
        before = attn.QUANT_I8_LAUNCHES
        out = attn.fused_qkv_attention_quant(qkv, H, **kw)
        torch.cuda.synchronize()
        assert attn.QUANT_I8_LAUNCHES == before + 1
        assert _steps(out, attn.reference_attention_quant(qkv, H, **kw)) <= ATTN_LEVELS
        np_ = -(-n // 32) * 32 + 32  # K5: padded rows that V's column scales see
        padded = _qkv((B, np_, 3 * H * dh), cuda, seed=n + dh + 1)
        padded[:, :n] = qkv
        flat = padded.reshape(B * np_, -1)
        fq, fs = attn.fused_qkv_attention_quant_flat(flat, B, n, H, **kw)
        ref = attn.reference_attention_quant_flat(flat, B, n, H, **kw)
        real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
        assert _steps((real(fq), real(fs)), tuple(real(t) for t in ref)) <= ATTN_LEVELS
        if not kw.get("pv_int8"):  # without V's codes the padded rows change nothing
            assert torch.equal(real(fq), out[0]) and torch.equal(real(fs), out[1])


def test_legs_refuse_a_head_past_shared_memory(cuda):
    """No longer refused: at head dim 64 with both legs a head's codes fit
    the short route up to 1,504 keys; one more 32-key group takes the long
    route (the head coded once, streamed in key tiles), one launch, within
    the bound of plain, as 1,504 keys, which since the measured crossover
    (288 keys at head dim 64) take the long route too."""
    qkv = _qkv((1, 1505, 3 * 64), cuda, seed=1)
    before = attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES
    out = attn.fused_qkv_attention_quant(qkv, 1, qk_int8=True, pv_int8=True)
    ref = attn.reference_attention_quant(qkv, 1, qk_int8=True, pv_int8=True)
    torch.cuda.synchronize()
    assert (attn.QUANT_I8_LAUNCHES, attn.QUANT_I8_LONG_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert _steps(out, ref) <= ATTN_LEVELS
    out = attn.fused_qkv_attention_quant(qkv[:, :1504], 1, qk_int8=True, pv_int8=True)
    ref = attn.reference_attention_quant(qkv[:, :1504], 1, qk_int8=True, pv_int8=True)
    torch.cuda.synchronize()
    assert attn.QUANT_I8_LONG_LAUNCHES == before[1] + 2
    assert _steps(out, ref) <= ATTN_LEVELS


@pytest.mark.parametrize("mode", list(rq.MODES))
def test_row_quant_every_form_matches_plain(cuda, mode):
    """K7 at ragged widths (not a multiple of 16 bytes of codes: 8-byte
    stores; one to sixteen chunks a lane), a few rows and many (more than a
    persistent grid holds at once), bf16 and f32."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for rows, d, dtype in ((3, 8, torch.bfloat16), (257, 776, torch.bfloat16),
                           (5000, 3072, torch.bfloat16), (40000, 768, torch.bfloat16),
                           (300, 4096, torch.float32), (129, 1000, torch.float32)):
        x = (torch.randn((rows, d), device=cuda, generator=g) * 2).to(dtype)
        gam = torch.rand(d, device=cuda, generator=g) + 0.5
        bet = torch.randn(d, device=cuda, generator=g) * 0.1
        before = rq.LAUNCHES
        q, s = rq.fused_rowquant(x, mode, gam, bet)
        ref_q, ref_s = rq.rowquant_plain(x, mode, gam, bet)
        torch.cuda.synchronize()
        assert rq.LAUNCHES == before + 1
        if mode == "none":
            assert torch.equal(q, ref_q) and torch.equal(s, ref_s), (rows, d)
            continue
        diff = (q.int() - ref_q.int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() < 1e-3, (rows, d)
        assert ((s - ref_s).abs() / ref_s).max().item() <= 1e-5, (rows, d)


def test_row_quant_sigmoid_gelu_is_the_scalar_form(cuda):
    """K7's sigmoid GELU, four values a call with the branch-free reciprocal,
    against gelu_sigmoid_mul on 4 * 2^24 values across 40 binades."""
    assert mm.gelu_selftest(1 << 24, "sigmoid_mul", device=cuda) == 0
