"""The port's row quantization (chess_vision_tpu_torch/ops/rowquant.py)
against the JAX package's ``fused_rowquant`` (K7 on (B, N, D), K6 on flat
(M, D)), on the same inputs made with numpy. The port runs its plain
PyTorch version, which is what a CPU tensor takes; the JAX side runs its
Pallas kernel in interpret mode, as its own tests do. The CUDA kernel is
held against the plain version on the card
(test_torch_int8_kernels_cuda.py).

Tolerances, those of the JAX package's own tests:
  - int8 codes within one level, in under 1e-3 of the elements (a value on a
    rounding boundary, reached by sums in another order;
    tests/test_attention.py test_rowquant_ln_matches_xla); scales rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import quant as jax_quant
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

MODES = ["none", "ln", "gelu", "gelu_sigmoid", "gelu_hard"]


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


@pytest.mark.parametrize("mode", MODES)
def test_rowquant_matches_jax(mode):
    """Both JAX forms: (B, N, D) and flat (M, D)."""
    rng = np.random.default_rng(1)
    for shape in ((2, 257, 128), (64, 128)):
        x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
        g, b = _ln(rng, shape[-1])
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ref_q, ref_s = jax_quant.fused_rowquant(xb, mode, g, b, interpret=True)
        q, s = rq.fused_rowquant(_t(x).bfloat16(), mode, _t(g), _t(b))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert s.shape == (*shape[:-1], 1)
        assert_codes_close(q.numpy(), ref_q)
        assert_scales_close(s.numpy(), ref_s)


def test_rowquant_f32_input_and_cpu_path():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 64)).astype(np.float32)
    ref_q, ref_s = jax_quant.fused_rowquant(jnp.asarray(x), "none",
                                            interpret=True)
    before = rq.LAUNCHES
    q, s = rq.fused_rowquant(_t(x))
    assert rq.LAUNCHES == before
    assert_codes_close(q.numpy(), ref_q)
    assert_scales_close(s.numpy(), ref_s)
    # a zero row: amax floored at 1e-8, codes 0
    q, s = rq.fused_rowquant(torch.zeros(2, 16))
    assert (q == 0).all() and torch.allclose(s, torch.full((2, 1), 1e-8 / 127))


def test_rowquant_rounds_half_to_even():
    # 127 / amax = 1 with amax 127: x * 1 rounds as jnp.round does
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, _ = rq.fused_rowquant(x)
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]
