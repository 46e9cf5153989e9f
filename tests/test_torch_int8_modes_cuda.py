"""The int8 path's serving modes on the card: K4 and K5
(``fused_qkv_attention_quant``, ``_flat``) with the bound, a fixed shift,
the row max, the bf16 exp and the int8 legs (each alone and both), K14 with the bound and K8's
bf16 epilogue, at ragged shapes and every head dim the quantizing kernels
take (16, 32, 64), against their plain PyTorch versions. They skip without
a CUDA device. On a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_modes_cuda.py -q

Tolerances: dequantized outputs within ``chip_smoke.py``'s ATTN_LEVELS (1.35)
quantization steps of each row (one level where a code flips, and the two
scales' difference); with the bf16 exp, whose argument rounds to steps of
1/8-1/4, on all but 1e-3 of the rows (``EXP_BF16_ROWS``; one row at the
small sizes here), and those within ``EXP_BF16_LEVELS`` (32); K8's codes within
one level in under 1e-3 of the elements, scales rtol 1e-5; K14 bit-identical
to the chain of split kernels.
"""

import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import fused_block as fb
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

pytestmark = pytest.mark.cuda

ATTN_LEVELS = 1.35
EXP_BF16_ROWS = 1e-3
EXP_BF16_LEVELS = 32.0
MODES = [{}, {"shift_mode": "fixed"}, {"shift_mode": "max"},
         {"exp_bf16": True}, {"qk_int8": True}, {"pv_int8": True},
         {"qk_int8": True, "pv_int8": True}]
IDS = ["bound", "fixed", "max", "exp-bf16", "int8", "pv-only", "int8pv"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, cuda, seed, gain=3.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, device=cuda, generator=g)
    x[..., :shape[-1] // 3] *= gain
    return x.bfloat16()


def _rows_within(out, ref, exp_bf16):
    (q, s), (rq_, rs) = out, ref
    assert torch.isfinite(s).all()
    steps = ((q.float() * s - rq_.float() * rs).abs()
             / torch.maximum(s, rs)).amax(dim=-1)
    if exp_bf16:  # a share of the rows, and one row at these sizes
        over = int((steps > ATTN_LEVELS).sum())
        assert over <= max(1, EXP_BF16_ROWS * steps.numel()), over
        assert steps.max().item() <= EXP_BF16_LEVELS, steps.max().item()
    else:
        assert steps.max().item() <= ATTN_LEVELS, steps.max().item()


@pytest.mark.parametrize("kw", MODES, ids=IDS)
def test_quant_attention_modes_match_plain(cuda, kw):
    for B, n, H, dh in ((3, 17, 2, 16), (2, 65, 12, 32), (2, 100, 3, 64),
                        (1, 257, 12, 64)):
        qkv = _qkv((B, n, 3 * H * dh), cuda, seed=n)
        before = attn.QUANT_LAUNCHES, attn.QUANT_I8_LAUNCHES
        out = attn.fused_qkv_attention_quant(qkv, H, **kw)
        torch.cuda.synchronize()
        legs = kw.get("qk_int8", False) or kw.get("pv_int8", False)
        assert (attn.QUANT_LAUNCHES, attn.QUANT_I8_LAUNCHES) == (
            before[0] + 1, before[1] + legs)
        _rows_within(out, attn.reference_attention_quant(qkv, H, **kw),
                     kw.get("exp_bf16", False))
        # K5 on the same images padded to a multiple of 32 rows: its real
        # rows are K4's, bit for bit, whatever the padded rows hold
        np_ = -(-n // 32) * 32
        padded = _qkv((B, np_, 3 * H * dh), cuda, seed=n + 1)
        padded[:, :n] = qkv
        flat = padded.reshape(B * np_, -1)
        fq, fs = attn.fused_qkv_attention_quant_flat(flat, B, n, H, **kw)
        real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
        if not kw.get("pv_int8"):  # V's column scales see the padded rows
            assert torch.equal(real(fq), out[0]) and torch.equal(real(fs), out[1])
        _rows_within((real(fq), real(fs)), tuple(real(t) for t in (
            attn.reference_attention_quant_flat(flat, B, n, H, **kw))),
            kw.get("exp_bf16", False))


def _block(D, O1, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=cuda, generator=g, dtype=torch.int8)
    dense = lambda k, o: {  # noqa: E731
        "wq": ri(o, k),
        "scale": torch.rand(o, device=cuda, generator=g) * 4e-4 + 2e-4,
        "bias": torch.randn(o, device=cuda, generator=g) * 0.1}
    norm = lambda: {  # noqa: E731
        "scale": torch.rand(D, device=cuda, generator=g) + 0.5,
        "bias": torch.randn(D, device=cuda, generator=g) * 0.1}
    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}


def test_fused_block_bound_is_the_split_chain(cuda):
    for H, dh, n in ((2, 16, 17), (4, 32, 65), (2, 64, 130)):
        D = H * dh
        q, nxt = _block(D, 4 * D, cuda, 1), _block(D, 4 * D, cuda, 2)["norm1"]
        x = (_qkv((3, n, D), cuda, seed=3, gain=1.0).float() * 0.5).bfloat16()
        xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"],
                                   q["norm1"]["bias"])
        out = fb.fused_vit_block(xq, xs, x, q, nxt, H)
        chain = quant.block_int8(x, xq, xs, q, nxt, H)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, chain)), (H, dh, n)


def test_bf16_epilogue_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    for (M, K, O), gelu in zip(((300, 80, 72), (4999, 768, 3072)) * 3,
                               ("sigmoid", "sigmoid", "erf", "erf", "hard",
                                "hard")):
        xq = torch.randint(-127, 128, (M, K), device=cuda, generator=g,
                           dtype=torch.int8)
        xs = torch.rand((M, 1), device=cuda, generator=g) * 0.02 + 0.002
        wq = torch.randint(-127, 128, (O, K), device=cuda, generator=g,
                           dtype=torch.int8)
        ws = torch.rand(O, device=cuda, generator=g) * 4e-4 + 2e-4
        b = torch.randn(O, device=cuda, generator=g) * 0.1
        before = mm.BF16_EPILOGUE_LAUNCHES
        q, s = mm.int8_matmul_gelu_quant(xq, xs, wq, ws, b, gelu,
                                         bf16_epilogue=True)
        rq_, rs = mm.int8_matmul_gelu_quant_plain(xq, xs, wq, ws, b, gelu,
                                                  bf16_epilogue=True)
        torch.cuda.synchronize()
        assert mm.BF16_EPILOGUE_LAUNCHES == before + 1
        diff = (q.int() - rq_.int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() < 1e-3
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
