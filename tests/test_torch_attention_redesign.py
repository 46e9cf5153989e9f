"""What can go wrong in the redesigned attention kernels before the card is
reached, and the two repairs that came with them.

- The schedule of the forward loop ``csrc/attention_loop.cuh`` (K2's
  arithmetic): 16-row blocks, keys in 64-key steps whose S is taken 16 keys
  at a time (twice: once for the step's max, once for p and P V), the online
  max rescaled once a step, sub-steps wholly past the last key skipped,
  emulated in f32 against ``reference_attention`` (1e-5: summation order
  only) and the JAX package's Pallas kernel in interpret mode (1e-5), and
  against the same schedule without the skip, which must give the same bits.
- The cross-head exchange of ``csrc/attention_quant.cu`` (K4 / K5): each
  head's block takes its rows' partial max |o| over its own columns, the max
  over those partial maxima gives amax, and each block codes its columns with
  it; emulated against ``quantize_rows`` on the whole row, bit for bit.
- K3's route by token count (``ops/attention.bwd_route``).
- ``data.device_cache=auto`` in the port's trainer, decided as the reference
  trainer decides it, and trained through on the rgb transport.
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess_vision_tpu.ops.attention import _kernel_attention
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops.rowquant import quantize_rows
from chess_vision_tpu_torch.train.__main__ import device_cache_engages

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 64  # keys a step (kFlashKTile): the online max is rescaled once a step
SUB = 16   # keys a sub-step, and rows a row block


def k2_schedule(qkv: torch.Tensor, num_heads: int, skip: bool = True) -> torch.Tensor:
    """The arithmetic of the K2 loop in f32, one 16-row block at a time.
    ``skip``: sub-steps wholly past the last key are not computed (the
    kernel); else they are, masked to -inf (the schedule without the skip)."""
    B, N, C3 = qkv.shape
    D = C3 // 3
    Dh = D // num_heads
    scale_log2 = 1.0 / math.sqrt(Dh) * 1.4426950408889634
    NP = -(-N // SUB) * SUB
    out = torch.zeros((B, N, D))
    for b in range(B):
        for h in range(num_heads):
            pad = lambda t: torch.cat([t, t.new_zeros(NP - N, Dh)])  # noqa: E731
            q, k, v = (pad(qkv[b, :, i * D + h * Dh:i * D + (h + 1) * Dh])
                       for i in range(3))
            for r0 in range(0, NP, SUB):
                qr = q[r0:r0 + SUB]
                m = torch.full((SUB, 1), -math.inf)
                l = torch.zeros((SUB, 1))
                o = torch.zeros((SUB, Dh))
                for k0 in range(0, N, STEP):
                    subs = [k0 + i * SUB for i in range(STEP // SUB)
                            if not skip or k0 + i * SUB < N]

                    def scores(lo):
                        s = qr @ k[lo:lo + SUB].T if lo < NP else torch.zeros(SUB, SUB)
                        keys = torch.arange(lo, lo + SUB)
                        return s.masked_fill(keys[None] >= N, -math.inf)

                    # pass 1: the step's max; pass 2: p and P V, sub-step by sub-step
                    mx = torch.maximum(m, torch.cat([scores(lo) for lo in subs],
                                                    1).amax(1, keepdim=True))
                    alpha = torch.exp2((m - mx) * scale_log2)
                    m, shift = mx, mx * scale_log2
                    o = o * alpha
                    rs = torch.zeros((SUB, 1))
                    for lo in subs:
                        p = torch.exp2(scores(lo) * scale_log2 - shift)
                        rs = rs + p.sum(1, keepdim=True)
                        if lo < NP:
                            o = o + p @ v[lo:lo + SUB]
                    l = l * alpha + rs
                rows = slice(r0, min(r0 + SUB, N))
                out[b, rows, h * Dh:(h + 1) * Dh] = (o / l)[:rows.stop - r0]
    return out


@pytest.mark.parametrize("N,H,Dh", [(17, 2, 16), (65, 2, 32), (257, 1, 16)])
def test_k2_schedule_matches_reference_and_jax_kernel(N, H, Dh):
    rng = np.random.default_rng(N)
    qkv = rng.normal(size=(1, N, 3 * H * Dh)).astype(np.float32)
    ours = k2_schedule(torch.from_numpy(qkv), H)
    ref = attn.reference_attention(torch.from_numpy(qkv), H)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5)
    kernel = np.asarray(_kernel_attention(jnp.asarray(qkv), H, interpret=True))
    np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-5)
    # the skipped sub-steps' p are exact zeros: skipping them changes no bit
    assert torch.equal(ours, k2_schedule(torch.from_numpy(qkv), H, skip=False))


def k4_exchange(o: np.ndarray, num_heads: int):
    """K4's quantization of f32 rows o (M, D): block h keeps its head's
    columns and its rows' partial max |o| over them; each block takes amax
    as the max over all blocks' partial maxima (floored at 1e-8), codes its
    own columns with fl(127 / amax), and rank 0 writes fl(amax * fl(1/127))."""
    M, D = o.shape
    Dh = D // num_heads
    heads = [o[:, h * Dh:(h + 1) * Dh] for h in range(num_heads)]
    part = [np.abs(cols).max(axis=1) for cols in heads]  # in each block's memory
    amax = np.maximum(np.maximum.reduce(part), np.float32(1e-8))
    inv = (np.float32(127.0) / amax).astype(np.float32)
    codes = [np.clip(np.rint(cols * inv[:, None]), -127, 127).astype(np.int8)
             for cols in heads]
    scale = (amax * np.float32(1.0 / 127.0)).astype(np.float32)
    return np.concatenate(codes, axis=1), scale[:, None]


@pytest.mark.parametrize("num_heads,Dh", [(12, 64), (3, 16)])
def test_k4_cross_head_exchange_equals_quantize_rows(num_heads, Dh):
    rng = np.random.default_rng(num_heads)
    o = (rng.normal(size=(300, num_heads * Dh)) * rng.uniform(
        0.01, 3.0, size=(300, 1))).astype(np.float32)
    o[0] = 0.0                       # an underflowed row: codes 0, scale 1e-8/127
    o[1, :] = 0.25                   # a row whose amax sits in every head
    o[2, -1] = 50.0                  # ... and in the last head alone
    halves = (np.arange(-126, 127, dtype=np.float32) + 0.5)[:o.shape[1] - 1]
    o[3, :halves.size] = halves      # exact ties: round half to even
    o[3, -1] = 127.0                 # amax 127: each code is its value
    q, s = k4_exchange(o, num_heads)
    rq, rs = quantize_rows(torch.from_numpy(o))
    np.testing.assert_array_equal(q, rq.numpy())
    np.testing.assert_array_equal(s, rs.numpy())


def test_k3_routes_by_token_count():
    assert attn.BWD_MAX_TOKENS == 288
    assert [attn.bwd_route(n) for n in (1, 17, 257, 288, 289, 577, 1025)] == [
        "short", "short", "short", "short", "long", "long", "long"]


@pytest.mark.parametrize("data,count,engages", [
    ({"device_cache": "auto", "transport": "rgb"}, 24, False),
    ({"device_cache": "auto", "transport": "ycbcr420"}, 24, True),
    ({"device_cache": "auto", "transport": "packed",
      "device_cache_budget_gb": 0.001}, 24, False)])
def test_device_cache_auto_decides_as_the_reference(data, count, engages):
    """``auto`` streams on rgb, and engages the cache on the 4:2:0
    transports only when the corpus fits the budget, as ``train.py``;
    ``true`` always engages it, ``false`` never, and an absent key is
    ``auto``, as the reference reads it (``train.py:262``)."""
    cfg = {"model": {"input_size": 256}, "data": data}
    assert device_cache_engages(cfg, count) is engages
    for flag, want in (("true", True), ("false", False), (True, True)):
        assert device_cache_engages(
            {**cfg, "data": {**data, "device_cache": flag}}, count) is want
    absent = {k: v for k, v in data.items() if k != "device_cache"}
    assert device_cache_engages({**cfg, "data": absent}, count) is engages


def test_device_cache_auto_trains_on_rgb(tmp_path):
    """``--set data.device_cache=auto`` (the reference's default) trains on
    the rgb transport by streaming, where it raised before; the cache itself
    is tests/test_torch_data_device.py's."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}
    corpus = tmp_path / "corpus"
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu.datagen.generate", "--out",
         str(corpus), "--count", "16", "--size", "64", "--seed", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.train", "--config",
         "configs/vit.yaml", "--device", "cpu", "--set", "training.epochs=1",
         "training.batch_size=8", "data.num_workers=0",
         f"data.train_dir={corpus}", "data.ood_val_dir=",
         "model.pretrained=false", "model.input_size=64", "model.embed_dim=32",
         "model.depth=1", "model.num_heads=2", "data.transport=rgb",
         "data.device_cache=auto", f"checkpointing.save_dir={tmp_path / 'ckpt'}",
         f"logging.tensorboard_dir={tmp_path / 'runs'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "Training complete" in r.stdout
    assert os.path.exists(tmp_path / "ckpt" / "latest.ckpt")
