"""The port's device-side augmentation and YCbCr transport
(chess_vision_tpu_torch/augment.py, ops/preprocess.py) against the JAX
package's. The two frameworks' generators give different numbers from one
seed, so the per-image parameters are drawn on the JAX side (its own key
splits) and handed to the port's "apply" half as numpy; the port's own draws
are checked for ranges and frequencies.

Tolerance 1e-5 on [0, 1] images (1e-4 after the normalize, which divides by
std 0.5 and below): the same f32 formulas in the same order, a blur summed in
another association, and XLA's fused multiply-adds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu import augment as jaug
from chess_vision_tpu.ops import preprocess as jpre
from chess_vision_tpu.serve import rgb_to_ycbcr420 as jax_rgb_to_ycbcr420
from chess_vision_tpu.train.loop import unpack_batch as jax_unpack_batch
from chess_vision_tpu_torch import augment as taug
from chess_vision_tpu_torch.ops import preprocess as tpre
from chess_vision_tpu_torch.train.loop import unpack_batch

torch.set_num_threads(2)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def jax_params(key, batch):
    """The draws of the JAX pipeline for ``key`` (``_augment_batch_impl_p``
    and ``preprocess_train_batch`` split it this way), as the port's dict."""
    keys = jax.random.split(key, batch)
    kj = jax.vmap(lambda k: jax.random.split(k, 7)[0])(keys)
    fb, fc, fs, fh, which = jax.vmap(jaug._color_jitter_params)(kj)
    pg, pb, sigma, pc, cperm, pi = jax.vmap(jaug._rest_params)(keys)
    names = ("brightness", "contrast", "saturation", "hue", "order", "gray_u",
             "blur_u", "sigma", "perm_u", "channel_perm", "invert_u")
    values = (fb, fc, fs, fh, which, pg, pb, sigma, pc, cperm, pi)
    return keys, {n: torch.from_numpy(np.array(v)) for n, v in zip(names, values)}


@pytest.mark.parametrize("channel_perm_p,invert_p", [(0.0, 0.0), (0.5, 0.5)])
def test_apply_matches_jax_pipeline(channel_perm_p, invert_p):
    B = 256
    x = np.random.default_rng(0).random((B, 3, 12, 12)).astype(np.float32)
    x[:8] = x[:8, :1]  # gray images: zero saturation through the hue path
    keys, params = jax_params(jax.random.key(7), B)
    # every op order, and both branches of every per-image choice
    assert set(params["order"].tolist()) == set(range(24))
    for name, p in (("gray_u", 0.1), ("blur_u", 0.2), ("perm_u", 0.5), ("invert_u", 0.5)):
        taken = (params[name] < p).float().mean().item()
        assert 0 < taken < 1, name
    ref = np.asarray(jaug._augment_batch_impl_p(jnp.asarray(x), keys,
                                                channel_perm_p, invert_p))
    ours = taug.apply_augment(torch.from_numpy(x), params, channel_perm_p, invert_p)
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def _loader_batch(transport, B=6, S=32, seed=1):
    rng = np.random.default_rng(seed)
    if transport == "rgb":
        return {"image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)}
    return {"y": rng.integers(0, 256, (B, S, S), dtype=np.uint8),
            "cb": rng.integers(0, 256, (B, S // 2, S // 2), dtype=np.uint8),
            "cr": rng.integers(0, 256, (B, S // 2, S // 2), dtype=np.uint8)}


@pytest.mark.parametrize("transport", ["rgb", "ycbcr420"])
def test_preprocess_train_batch_matches_jax(transport):
    batch = _loader_batch(transport)
    key = jax.random.key(3)
    _, params = jax_params(key, 6)
    ref = np.asarray(jaug.preprocess_train_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, key, MEAN, STD))
    ours = taug.preprocess_train_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, params, MEAN, STD)
    assert ours.shape == (6, 32, 32, 3) and ours.dtype == torch.float32
    assert ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_preprocess_eval_batch_matches_jax():
    for transport in ("rgb", "ycbcr420"):
        batch = _loader_batch(transport, seed=2)
        ref = np.asarray(jaug.preprocess_eval_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, MEAN, STD))
        ours = taug.preprocess_eval_batch(
            {k: torch.from_numpy(v) for k, v in batch.items()}, MEAN, STD)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_ycbcr420_reconstruction_matches_jax():
    """Bilinear chroma upsample (half-pixel centers, edges clamped) and the
    BT.601 matrix: atol 1e-3 on [0, 255] values."""
    planes = _loader_batch("ycbcr420", B=3, S=64, seed=4)
    j = [jnp.asarray(planes[k]) for k in ("y", "cb", "cr")]
    t = [torch.from_numpy(planes[k]) for k in ("y", "cb", "cr")]
    rgb = tpre.ycbcr420_to_rgb(*t)
    assert rgb.shape == (3, 64, 64, 3) and 0 <= rgb.min() and rgb.max() <= 255
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jpre.ycbcr420_to_rgb(*j)),
                               atol=1e-3)
    np.testing.assert_allclose(tpre.ycbcr420_to_rgb_planar(*t).numpy(),
                               np.asarray(jpre.ycbcr420_to_rgb_planar(*j)), atol=1e-3)
    assert torch.equal(tpre.ycbcr420_to_rgb_planar(*t), rgb.permute(0, 3, 1, 2))
    norm = tpre.ycbcr420_to_normalized(*t, MEAN, STD, torch.float32)
    ref = np.asarray(jpre.ycbcr420_to_normalized(*j, MEAN, STD, jnp.float32))
    np.testing.assert_allclose(norm.numpy(), ref, atol=1e-4)
    assert tpre.ycbcr420_to_normalized(*t, MEAN, STD).dtype == torch.bfloat16


def test_rgb_to_ycbcr420_bytes_equal_jax_helper():
    img = np.random.default_rng(5).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ours, theirs = tpre.rgb_to_ycbcr420(img), jax_rgb_to_ycbcr420(img)
    assert [p.shape for p in ours] == [(64, 64), (32, 32), (32, 32)]
    for a, b in zip(ours, theirs):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_unpack_batch_matches_jax():
    rng = np.random.default_rng(6)
    B, S = 4, 32
    packed = {"pixels": rng.integers(0, 256, (B, S * S * 3 // 2), dtype=np.uint8),
              "labels": rng.integers(0, 2, (B, 71)).astype(np.float32)}
    ours = unpack_batch({k: torch.from_numpy(v) for k, v in packed.items()}, S)
    theirs = jax_unpack_batch({k: jnp.asarray(v) for k, v in packed.items()}, S)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]))
    assert ours["squares"].dtype == torch.int32
    plain = {"image": torch.zeros(1)}
    assert unpack_batch(plain, S) is plain


def test_own_draws_ranges_and_frequencies():
    gen = torch.Generator().manual_seed(0)
    n = 6000
    p = taug.draw_params(n, gen)
    for name, (lo, hi) in (("brightness", taug.BRIGHTNESS), ("contrast", taug.CONTRAST),
                           ("saturation", taug.SATURATION), ("hue", taug.HUE),
                           ("sigma", taug.SIGMA)):
        v = p[name]
        assert v.shape == (n,) and lo <= v.min() and v.max() < hi, name
        # uniform: mean within 4 standard errors of the middle
        assert abs(v.mean().item() - (lo + hi) / 2) < 4 * (hi - lo) / (12 * n) ** 0.5
    counts = torch.bincount(p["order"], minlength=24)
    assert counts.shape == (24,) and counts.min() > 150  # 250 expected each
    for name, prob in (("gray_u", taug.GRAYSCALE_P), ("blur_u", taug.BLUR_P)):
        freq = (p[name] < prob).float().mean().item()
        assert abs(freq - prob) < 4 * (prob * (1 - prob) / n) ** 0.5, name
    perms = {tuple(row) for row in p["channel_perm"].tolist()}
    assert len(perms) == 6
    # the same seed gives the same draws, another seed others
    again = taug.draw_params(n, torch.Generator().manual_seed(0))
    other = taug.draw_params(n, torch.Generator().manual_seed(1))
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["hue"], other["hue"])
