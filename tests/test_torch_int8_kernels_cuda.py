"""The port's int8 serving kernels (row quant, int8 GEMM epilogues,
quantizing attention) against their plain PyTorch versions, on the card.
They skip without a CUDA device. On a GPU machine without JAX, run them
without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_kernels_cuda.py -q

Tolerances: int8 codes within one level in under 1e-3 of the elements (the
kernels sum in another order than PyTorch, and their expf is not
bit-identical to PyTorch's exp); scales rtol 1e-5; bf16 outputs within one
bf16 ulp; dequantized attention within 2e-2, the JAX package's bound for its
attention kernel.
"""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import rowquant as rq

pytestmark = pytest.mark.cuda

MODES = ["none", "ln", "gelu", "gelu_sigmoid", "gelu_hard"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _codes_close(ours: torch.Tensor, ref: torch.Tensor) -> None:
    diff = (ours.int() - ref.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() < 1e-3


def _rand(shape, cuda, seed=0, dtype=torch.bfloat16, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(shape, device=cuda, generator=g) * scale).to(dtype)


@pytest.mark.parametrize("dtype,shapes", [
    (torch.bfloat16, [(3, 257, 768), (5, 40)]),
    (torch.float32, [(300, 3072), (7, 4096)]),
])
def test_rowquant_kernel_matches_plain(cuda, dtype, shapes):
    for shape in shapes:
        x = _rand(shape, cuda, dtype=dtype, scale=2.0) + 0.25
        g = _rand(shape[-1:], cuda, seed=1, dtype=torch.float32) * 0.1 + 1
        b = _rand(shape[-1:], cuda, seed=2, dtype=torch.float32) * 0.1
        for mode in MODES:
            before = rq.LAUNCHES
            q, s = rq.fused_rowquant(x, mode, g, b)
            torch.cuda.synchronize()
            assert rq.LAUNCHES == before + 1
            ref_q, ref_s = rq.rowquant_plain(x, mode, g, b)
            _codes_close(q, ref_q)
            torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)


def _gemm_operands(cuda, M, K, O, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def ints(*shape):
        return torch.randint(-127, 128, shape, device=cuda, generator=g,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, device=cuda, generator=g) * 0.015 + 0.005

    return (ints(M, K), scales(M, 1), ints(O, K), scales(O),
            torch.randn(O, device=cuda, generator=g) * 0.1,
            torch.randn((M, O), device=cuda, generator=g).bfloat16())


# (300, 80, 72) and on: rows, columns and depth that end inside the main
# loop's 64 x 256 tile, its 128-byte stage of K and the epilogue's 16-row group
@pytest.mark.parametrize("M,K,O", [(300, 768, 2304), (257, 3072, 768),
                                   (129, 64, 136), (17, 48, 8),
                                   (300, 80, 72), (64, 128, 256),
                                   (1000, 768, 264), (129, 16, 8),
                                   (4999, 3072, 776)])
def test_int8_matmul_kernels_match_plain(cuda, M, K, O):
    xq, xs, wq, ws, bias, res = _gemm_operands(cuda, M, K, O)
    g = torch.rand(O, device=cuda) + 0.5
    b = torch.randn(O, device=cuda) * 0.1
    before = dict(mm.LAUNCHES)
    out = mm.int8_matmul_scale_bias(xq, xs, wq, ws, bias)
    ref = mm.int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2**-8, atol=0)
    out = mm.int8_matmul_res(xq, xs, wq, ws, bias, res)
    ref = mm.int8_matmul_res_plain(xq, xs, wq, ws, bias, res)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2**-8, atol=1e-6)
    x, q, s = mm.int8_matmul_res_ln_quant(xq, xs, wq, ws, bias, res, g, b)
    rx, ref_q, ref_s = mm.int8_matmul_res_ln_quant_plain(xq, xs, wq, ws, bias,
                                                         res, g, b)
    torch.testing.assert_close(x.float(), rx.float(), rtol=2**-8, atol=1e-6)
    _codes_close(q, ref_q)
    torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)
    for gelu in ("erf", "sigmoid", "hard"):
        q, s = mm.int8_matmul_gelu_quant(xq, xs, wq, ws, bias, gelu)
        ref_q, ref_s = mm.int8_matmul_gelu_quant_plain(xq, xs, wq, ws, bias, gelu)
        _codes_close(q, ref_q)
        torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    assert {k: mm.LAUNCHES[k] - before[k] for k in before} == {
        "scale_bias": 1, "res": 1, "res_ln_quant": 1, "gelu_quant": 3}


def test_int8_matmul_launches_are_bit_identical(cuda):
    """Two launches of each epilogue give the same bits (K8's row maxima are
    folded with an atomic max, which is exact in any order), and the bf16
    outputs equal the plain version's bit for bit."""
    xq, xs, wq, ws, bias, res = _gemm_operands(cuda, 1300, 768, 3072)
    g = torch.rand(3072, device=cuda) + 0.5
    b = torch.randn(3072, device=cuda) * 0.1
    runs = [lambda: (mm.int8_matmul_scale_bias(xq, xs, wq, ws, bias),),
            lambda: (mm.int8_matmul_res(xq, xs, wq, ws, bias, res),),
            lambda: mm.int8_matmul_res_ln_quant(xq, xs, wq, ws, bias, res, g, b),
            lambda: mm.int8_matmul_gelu_quant(xq, xs, wq, ws, bias, "sigmoid")]
    for run in runs:
        first, second = run(), run()
        assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert torch.equal(runs[0]()[0],
                       mm.int8_matmul_scale_bias_plain(xq, xs, wq, ws, bias))
    assert torch.equal(runs[1]()[0],
                       mm.int8_matmul_res_plain(xq, xs, wq, ws, bias, res))


@pytest.mark.parametrize("gelu", ["erf", "sigmoid", "hard"])
def test_epilogue_gelu_equals_the_scalar_gelu(cuda, gelu):
    """The GEMM epilogue's GELU (four values a call, a branch-free division)
    against the scalar GELU of the row-quant and whole-block kernels, bit for
    bit, on 2^26 values over signs, 40 binades and all mantissas."""
    assert mm.gelu_selftest(1 << 24, gelu) == 0


@pytest.mark.parametrize("calibrated", [False, True])
def test_attention_quant_kernel_matches_plain(cuda, calibrated):
    for B, N, H, Dh in [(2, 257, 12, 64), (3, 17, 1, 32), (1, 64, 4, 16),
                        (2, 300, 2, 64), (2, 65, 12, 64), (1, 40, 16, 16)]:
        qkv = torch.from_numpy(
            np.random.default_rng(0).normal(size=(B, N, 3 * H * Dh))
            .astype(np.float32)).to(cuda, torch.bfloat16)
        shift = None
        if calibrated:  # as calibrate_attn_shifts sets it
            q, k = qkv.float().reshape(B, N, 3, H, Dh)[:, :, :2].unbind(2)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / Dh ** 0.5
            shift = scores.max().item() - 40
        before = attn.QUANT_LAUNCHES
        oq, os_ = attn.fused_qkv_attention_quant(qkv, H, shift)
        torch.cuda.synchronize()
        assert attn.QUANT_LAUNCHES == before + 1
        ref_q, ref_s = attn.reference_attention_quant(qkv, H, shift)
        assert torch.isfinite(os_).all()
        torch.testing.assert_close(oq.float() * os_, ref_q.float() * ref_s,
                                   rtol=0, atol=2e-2)


def test_attention_quant_kernel_underflow_gives_zeros(cuda):
    qkv = _rand((1, 17, 3 * 2 * 64), cuda)
    oq, os_ = attn.fused_qkv_attention_quant(qkv, 2, 1000.0)
    torch.cuda.synchronize()
    assert (oq == 0).all()
    torch.testing.assert_close(os_, torch.full_like(os_, 1e-8 / 127))


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        rq.fused_rowquant(torch.zeros((4, 64), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        rq.fused_rowquant(torch.zeros((4, 60), device=cuda))  # d % 8
    with pytest.raises(ValueError):
        rq.fused_rowquant(torch.zeros((4, 64), device=cuda), "ln")  # no LN params
    xq, xs, wq, ws, bias, _ = _gemm_operands(cuda, 32, 64, 16)
    with pytest.raises(ValueError):
        mm.int8_matmul_scale_bias(xq[:, :40], xs, wq[:, :40], ws, bias)  # K % 16
    with pytest.raises(TypeError):
        mm.int8_matmul_scale_bias(xq.float(), xs, wq, ws, bias)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_quant(
            torch.zeros((1, 5, 3 * 2 * 48), device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="heads"):  # one cluster holds at most 16
        attn.fused_qkv_attention_quant(
            torch.zeros((1, 5, 3 * 17 * 16), device=cuda, dtype=torch.bfloat16), 17)
