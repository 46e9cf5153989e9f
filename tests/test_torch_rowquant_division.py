"""The plain row quantization's quotient 127 / amax, held to the JAX kernel
on rows built to sit on a rounding boundary.

PyTorch evaluates ``127.0 / amax`` (a number over a tensor) as
fl(1 / amax) * 127, one unit off fl(127 / amax) for a quarter of all amax.
The JAX kernel (``chess_vision_tpu/ops/quant.py`` ``_rowquant_kernel``) and
the port's CUDA kernels take the true quotient; so does ``quantize_rows``,
and with it every plain version built on it (``rowquant_plain``, the ends of
K4/K5's and K8's plain versions, K15's). The rows here hold values x with
rint(fl(x * fl(127 / a))) != rint(fl(x * fl(fl(1 / a) * 127))): a code one
level apart under the two quotients. Their values are >= 60 and the pre-ops
leave such values as they are (the GELUs saturate to x; ``ln`` with a zero
scale gives its bias), so every mode reaches the quantization with the same
f32 values on both sides, and the codes and scales must be equal bit for bit.
One JAX call per mode, shared by the tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops import quant as jax_quant
from chess_vision_tpu_torch.ops import rowquant as rq

torch.set_num_threads(2)

MODES = ["none", "ln", "gelu", "gelu_sigmoid", "gelu_hard"]
ROWS, WIDTH = 16, 64


def _inv_true(a: np.float32) -> np.float32:
    return np.float32(127.0) / a


def _inv_old(a: np.float32) -> np.float32:
    return (np.float32(1.0) / a) * np.float32(127.0)


def _boundary_row(rng) -> np.ndarray:
    """One f32 row of WIDTH values in [60, a] with max a, holding at least
    four values whose code differs under the two quotients."""
    while True:
        a = np.float32(rng.uniform(200.0, 1000.0))
        new, old = _inv_true(a), _inv_old(a)
        if new == old:
            continue
        found = []
        for k in rng.permutation(np.arange(40, 126))[:24]:
            x = np.float32((k + 0.5) / float(new))
            for _ in range(200):  # walk x an ulp at a time across k + 0.5
                if np.rint(x * new) != np.rint(x * old):
                    found.append(x)
                    break
                x = np.nextafter(x, np.float32(np.inf if x * new < k + 0.5 else 0))
            if len(found) == 4:
                break
        if len(found) == 4:
            break
    row = rng.uniform(60.0, float(a), WIDTH).astype(np.float32)
    row[0] = a
    row[1:5] = found
    return rng.permutation(row)


@pytest.fixture(scope="module")
def rows() -> np.ndarray:
    rng = np.random.default_rng(20)
    return np.stack([_boundary_row(rng) for _ in range(ROWS)])


@pytest.fixture(scope="module")
def jax_codes(rows):
    """The JAX kernel (interpret mode) in each mode on the boundary rows; in
    ``ln`` the rows are the bias (zero scale) of noise inputs, one row at a
    time."""
    out = {}
    for mode in MODES:
        if mode == "ln":
            noise = np.random.default_rng(1).normal(size=(8, WIDTH)).astype(np.float32)
            q, s = [], []
            for row in rows:
                rq_, rs_ = jax_quant.fused_rowquant(
                    jnp.asarray(noise), "ln", np.zeros(WIDTH, np.float32), row,
                    interpret=True)
                q.append(np.asarray(rq_)[0])
                s.append(np.asarray(rs_)[0])
            out[mode] = (np.stack(q), np.stack(s))
        else:
            rq_, rs_ = jax_quant.fused_rowquant(jnp.asarray(rows), mode,
                                                interpret=True)
            out[mode] = (np.asarray(rq_), np.asarray(rs_))
    return out


def test_rows_sit_on_a_boundary(rows):
    """Each row's amax gives 127 fl(1/amax) != fl(127/amax), and the two
    quotients code at least four of its values a level apart."""
    for row in rows:
        a = row.max()
        assert _inv_true(a) != _inv_old(a)
        apart = np.rint(row * _inv_true(a)) != np.rint(row * _inv_old(a))
        assert apart.sum() >= 4


def test_old_expression_parts_from_jax(rows, jax_codes):
    """``x * (127.0 / amax)`` in PyTorch, the expression the plain version
    had: its codes part from the JAX kernel's on every boundary row."""
    x = torch.from_numpy(rows)
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    old = torch.round(x * (127.0 / amax)).clamp(-127, 127).to(torch.int8)
    ref_q = jax_codes["none"][0]
    assert (old.numpy() != ref_q).any(axis=1).all()


def test_quantize_rows_matches_jax_bit_for_bit(rows, jax_codes):
    q, s = rq.quantize_rows(torch.from_numpy(rows))
    ref_q, ref_s = jax_codes["none"]
    np.testing.assert_array_equal(q.numpy(), ref_q)
    np.testing.assert_array_equal(s.numpy(), ref_s)


@pytest.mark.parametrize("mode", MODES)
def test_rowquant_plain_matches_jax_bit_for_bit(rows, jax_codes, mode):
    x = torch.from_numpy(rows)
    if mode == "ln":
        noise = torch.from_numpy(
            np.random.default_rng(1).normal(size=(8, WIDTH)).astype(np.float32))
        got = [rq.rowquant_plain(noise, "ln", torch.zeros(WIDTH), torch.from_numpy(row))
               for row in rows]
        q = torch.stack([g[0][0] for g in got])
        s = torch.stack([g[1][0] for g in got])
    else:
        q, s = rq.rowquant_plain(x, mode)
    ref_q, ref_s = jax_codes[mode]
    np.testing.assert_array_equal(q.numpy(), ref_q)
    np.testing.assert_array_equal(s.numpy(), ref_s)
    if mode == "ln":  # every noise row gives the bias row's codes
        assert all(torch.equal(g[0], g[0][:1].expand_as(g[0])) for g in got)


def test_cpu_entry_point_takes_the_repaired_plain_version(rows, jax_codes):
    """``fused_rowquant`` on a CPU tensor, the port's entry point, in the
    3-D form the JAX kernel also takes."""
    x = torch.from_numpy(rows).reshape(2, ROWS // 2, WIDTH)
    q, s = rq.fused_rowquant(x)
    ref_q, ref_s = jax_codes["none"]
    np.testing.assert_array_equal(q.reshape(ROWS, WIDTH).numpy(), ref_q)
    np.testing.assert_array_equal(s.reshape(ROWS, 1).numpy(), ref_s)
