"""The port's int8 GEMM epilogues (chess_vision_tpu_torch/ops/int8_matmul.py)
against the JAX package's ``int8_matmul_*`` kernels (K8-K10) and their flat
twins (K11-K13), and the qkv product against ``quant_dense_q``, on the same
inputs made with numpy. The port runs its plain PyTorch versions, which is
what a CPU tensor takes; the JAX side runs its Pallas kernels in interpret
mode, as its own tests do. The CUDA kernel is held against the plain
versions on the card (test_torch_int8_kernels_cuda.py).

Tolerances, those of the JAX package's own tests:
  - int8 codes within one level, in under 1e-3 of the elements (a value on a
    rounding boundary, reached by sums in another order;
    tests/test_attention.py test_rowquant_ln_matches_xla); scales rtol 1e-5;
  - bf16 residual outputs within one bf16 ulp (rtol 2^-8): the f32 sum
    before the rounding may differ in its last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import int8_matmul as jax_mm
from chess_vision_tpu.ops import quant as jax_quant
from chess_vision_tpu_torch.ops import int8_matmul as mm

torch.set_num_threads(2)


def assert_codes_close(ours, ref):
    ours = np.asarray(ours, np.int32)
    ref = np.asarray(ref, np.int32)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def assert_scales_close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ln(rng, d):
    return ((1 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32))


def _gemm_operands(rng, M, K, O):
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    xs = rng.uniform(0.005, 0.02, (M, 1)).astype(np.float32)
    wq = rng.integers(-127, 128, (K, O)).astype(np.int8)
    ws = rng.uniform(0.005, 0.02, O).astype(np.float32)
    bias = rng.normal(0, 0.1, O).astype(np.float32)
    res = rng.normal(0, 1, (M, O)).astype(np.float32)
    return xq, xs, wq, ws, bias, res


def _ours(xq, xs, wq, ws, bias, shape):
    """The port's operands: (…, K) rows in ``shape``, weights (O, K)."""
    K = xq.shape[-1]
    return (_t(xq.reshape(*shape, K)), _t(xs.reshape(*shape, 1)),
            _t(wq.T), _t(ws), _t(bias))


def _jax(xq, xs, wq, ws, bias, shape):
    K = xq.shape[-1]
    return (jnp.asarray(xq.reshape(*shape, K)), jnp.asarray(xs.reshape(*shape, 1)),
            jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(bias))


# the JAX per-image kernel on (B, N, K) and its flat twin on (M, K) rows
LAYOUTS = {(2, 32): "", (64,): "_flat"}


@pytest.mark.parametrize("gelu", ["erf", "sigmoid", "hard"])
def test_gelu_quant_matches_jax(gelu):
    rng = np.random.default_rng(3)
    ops = _gemm_operands(rng, 64, 128, 256)[:5]
    for shape, twin in LAYOUTS.items():
        fn = getattr(jax_mm, "int8_matmul_gelu_quant" + twin)
        ref_q, ref_s = fn(*_jax(*ops, shape), interpret=True, approx_gelu=gelu)
        q, s = mm.int8_matmul_gelu_quant(*_ours(*ops, shape), gelu=gelu)
        assert q.shape == (*shape, 256) and s.shape == (*shape, 1)
        assert_codes_close(q.numpy(), ref_q)
        assert_scales_close(s.numpy(), ref_s)


def test_res_ln_quant_matches_jax():
    rng = np.random.default_rng(4)
    xq, xs, wq, ws, bias, res = _gemm_operands(rng, 64, 256, 128)
    g, b = _ln(rng, 128)
    for shape, twin in LAYOUTS.items():
        fn = getattr(jax_mm, "int8_matmul_res_ln_quant" + twin)
        res_b = jnp.asarray(res.reshape(*shape, 128)).astype(jnp.bfloat16)
        ref_x, ref_q, ref_s = fn(*_jax(xq, xs, wq, ws, bias, shape), res_b, g,
                                 b, interpret=True)
        x, q, s = mm.int8_matmul_res_ln_quant(
            *_ours(xq, xs, wq, ws, bias, shape),
            _t(res.reshape(*shape, 128)).bfloat16(), _t(g), _t(b))
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(ref_x, np.float32),
                                   rtol=2**-8, atol=0)
        assert_codes_close(q.numpy(), ref_q)
        assert_scales_close(s.numpy(), ref_s)


def test_res_matches_jax():
    rng = np.random.default_rng(5)
    xq, xs, wq, ws, bias, res = _gemm_operands(rng, 64, 256, 128)
    for shape, twin in LAYOUTS.items():
        fn = getattr(jax_mm, "int8_matmul_res" + twin)
        res_b = jnp.asarray(res.reshape(*shape, 128)).astype(jnp.bfloat16)
        ref = fn(*_jax(xq, xs, wq, ws, bias, shape), res_b, interpret=True)
        x = mm.int8_matmul_res(*_ours(xq, xs, wq, ws, bias, shape),
                               _t(res.reshape(*shape, 128)).bfloat16())
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2**-8, atol=0)


def test_scale_bias_matches_quant_dense_q():
    rng = np.random.default_rng(6)
    ops = _gemm_operands(rng, 64, 128, 384)[:5]
    ref = jax_quant.quant_dense_q(*_jax(*ops, (2, 32)))
    out = mm.int8_matmul_scale_bias(*_ours(*ops, (2, 32)))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 32, 384)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2**-8, atol=0)


def test_int8_product_is_exact():
    # 127^2 * 3072 > 2^24: an f32 product would round; the plain one must not
    xq = torch.full((17, 3072), 127, dtype=torch.int8)
    xq[:, 0] = -127
    wq = torch.full((8, 3072), 127, dtype=torch.int8)
    acc = mm.int8_mm(xq, wq)
    assert acc.dtype == torch.int32
    assert (acc == 127 * 127 * 3070).all()
