"""The port's preprocess (chess_vision_tpu_torch/ops/preprocess.py) against
the JAX package's: the plain PyTorch version, which is what a CPU tensor runs,
against JAX ``preprocess_u8(..., use_pallas=False)``. The CUDA kernel is held
against the same plain version on the card (test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import preprocess as jax_pp
from chess_vision_tpu_torch.ops import preprocess as pp

torch.set_num_threads(2)

MEAN_STD = {
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| in units of b's bf16 spacing (8 significant bits)."""
    mag = np.maximum(np.abs(b), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(a - b) / ulp).max())


@pytest.mark.parametrize("norm", sorted(MEAN_STD))
def test_plain_matches_jax_f32(norm):
    mean, std = MEAN_STD[norm]
    x = np.random.default_rng(1).integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    ours = pp.preprocess_u8(torch.from_numpy(x), mean, std, torch.float32)
    ref = jax_pp.preprocess_u8(jnp.asarray(x), mean, std, jnp.float32,
                               use_pallas=False)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("norm", sorted(MEAN_STD))
def test_plain_matches_jax_bf16_within_one_ulp(norm):
    mean, std = MEAN_STD[norm]
    x = np.random.default_rng(2).integers(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    ours = pp.preprocess_u8(torch.from_numpy(x), mean, std, torch.bfloat16)
    ref = jax_pp.preprocess_u8(jnp.asarray(x), mean, std, jnp.bfloat16,
                               use_pallas=False)
    assert ours.dtype == torch.bfloat16 and ours.shape == x.shape
    assert bf16_ulps(ours.float().numpy(), np.asarray(ref, np.float32)) <= 1.0


def test_norm_vectors_match_jax_kernel_constants():
    mean, std = MEAN_STD["imagenet"]
    scale, bias = pp.norm_vectors(mean, std)
    jscale, jbias = jax_pp._norm_vectors(mean, std, width=1, channels=3)
    assert scale.dtype == bias.dtype == np.float32
    np.testing.assert_array_equal(scale, jscale[0])
    np.testing.assert_array_equal(bias, jbias[0])


def test_cpu_tensor_takes_plain_path():
    mean, std = MEAN_STD["vit"]
    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (1, 8, 8, 3)).astype(np.uint8))
    before = pp.LAUNCHES
    out = pp.preprocess_u8(x, mean, std)
    assert pp.LAUNCHES == before
    torch.testing.assert_close(out, pp.preprocess_u8_plain(x, mean, std),
                               rtol=0, atol=0)
