"""The port's attention-variant sweep
(chess_vision_tpu_torch/experiments/attn_variants.py, K15) against the JAX
script experiments/attn_variants.py, on the same inputs made with numpy.

The port runs ``variant_plain``, which is what a CPU tensor takes. The JAX
script's ``_make_variant`` passes no ``interpret`` to ``pl.pallas_call``, so
the test loads the script with importlib and wraps ``pallas_call`` to add
``interpret=True``; nothing in the script changes. The CUDA kernel is held
against the plain version on the card (test_torch_layout_kernels_cuda.py).

Tolerances, on the dequantized output (values up to ~2, one int8 step of a
row ~0.01): 0.02 for the variants whose probabilities are f32 exponentials
(one code may land a level apart where the row sums differ in the last
bit), and 0.05 for ``bf16s`` and ``noexp``: ``bf16s`` rounds the scores,
their difference and the exponential to bf16, where XLA on the CPU and
PyTorch keep f32 at different points; ``noexp`` divides by a row sum of
signed values that nearly cancels. Scales rtol 2e-2 likewise.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chess_vision_tpu_torch.experiments import attn_variants as av

torch.set_num_threads(2)

B, N, H, DH = 2, 33, 2, 64
D = H * DH
ATOL = {"bf16s": 0.05, "noexp": 0.05}


@pytest.fixture(scope="module")
def jax_script():
    path = pathlib.Path(__file__).resolve().parents[1] / "experiments" / \
        "attn_variants.py"
    spec = importlib.util.spec_from_file_location("jax_attn_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpreted(monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **kw: real(*a, **{**kw, "interpret": True}))


def _qkv(seed):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * D)).astype(
        np.float32)


def _deq(q, s):
    return np.asarray(q, np.float32) * np.asarray(s, np.float32)


@pytest.mark.parametrize("name", list(av.VARIANTS))
def test_variant_plain_matches_jax(name, jax_script, interpreted):
    qkv = _qkv(seed=len(name))
    ref_q, ref_s = jax_script._make_variant(name, H, N, D)(
        jnp.asarray(qkv).astype(jnp.bfloat16))
    oq, os_ = av.variant_plain(name, H, N, D)(torch.from_numpy(qkv).bfloat16())
    assert oq.dtype == torch.int8 and oq.shape == (B, N, D)
    assert os_.dtype == torch.float32 and os_.shape == (B, N, 1)
    assert np.isfinite(np.asarray(ref_s)).all()
    np.testing.assert_allclose(_deq(oq.numpy(), os_.numpy()),
                               _deq(ref_q, ref_s), atol=ATOL.get(name, 0.02))
    np.testing.assert_allclose(os_.numpy(), np.asarray(ref_s), rtol=2e-2)


def test_bb_groups_images_and_changes_nothing(jax_script, interpreted):
    qkv = _qkv(seed=4)
    for name in ("base", "normbound"):
        one = av.make_variant(name, H, N, D, bb=1)(
            torch.from_numpy(qkv).bfloat16())
        two = av.make_variant(name, H, N, D, bb=2)(
            torch.from_numpy(qkv).bfloat16())
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
        ref = jax_script._make_variant(name, H, N, D, bb=2)(
            jnp.asarray(qkv).astype(jnp.bfloat16))
        np.testing.assert_allclose(_deq(two[0].numpy(), two[1].numpy()),
                                   _deq(*ref), atol=0.02)
    with pytest.raises(ValueError, match="multiple of bb"):
        av.make_variant("base", H, N, D, bb=3)(torch.from_numpy(qkv).bfloat16())


def test_sweep_entry_point_and_refused_names(jax_script, interpreted, capsys):
    """The sweep at one image runs the plain versions, because the tensors
    lie on the CPU (no launch is counted), and prints the JAX script's line
    per variant. The JAX kernel ``normbound_bd`` fails when traced, so the
    port refuses the name instead of inventing a result."""
    before = dict(av.LAUNCHES)
    times = av.sweep(1, device="cpu")
    assert av.LAUNCHES == before
    out = capsys.readouterr().out.splitlines()
    assert list(times) == list(av.VARIANTS) and len(out) == len(av.VARIANTS)
    assert out[0].startswith("base") and "ms/batch" in out[0]
    assert all("img/s attn-only" in line for line in out)

    with pytest.raises(NameError):
        jax_script._make_variant("normbound_bd", H, N, D)(
            jnp.asarray(_qkv(seed=5)).astype(jnp.bfloat16))
    with pytest.raises(ValueError, match="not ported"):
        av.make_variant("normbound_bd", H, N, D)
    with pytest.raises(ValueError, match="unknown variant"):
        av.variant_plain("nosuch", H, N, D)
