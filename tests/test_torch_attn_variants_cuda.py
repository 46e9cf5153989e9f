"""The attention-variant kernel (K15, ``csrc/attention_variants.cu``) on the
card, against its plain PyTorch version. They skip without a CUDA device. On a
GPU machine without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attn_variants_cuda.py -q

Shapes: ragged token counts (17: one row chunk, one key tile; 65: a 16-key
sub-step past a tile; 257: the sweep's; 300: four key tiles, chunks of
unequal length), 2, 5 and 12 heads (clusters of that many blocks) of 32 and
64, one and two images a block. Tolerances on the dequantized output, those
of ``chip_smoke.py`` phase 16: 2e-2, the JAX package's bound for its own
attention kernel; 4e-2 for ``bf16s``, which rounds scores, differences and
exponentials to bf16, so a last-bit difference in a sum becomes a bf16 step
of p. Two images a block must give the bits of one.
"""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.experiments import attn_variants as av
from chess_vision_tpu_torch.ops import rowquant as rq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, N, H, Dh, cuda, seed):
    a = np.random.default_rng(seed).normal(size=(B, N, 3 * H * Dh))
    a[..., :H * Dh] *= 2.0  # logits of O(10)
    return torch.from_numpy(a.astype(np.float32)).to(cuda).bfloat16()


@pytest.mark.parametrize("B,N,H,Dh", [(2, 17, 2, 32), (4, 65, 5, 64),
                                      (2, 257, 12, 64), (2, 300, 2, 32)])
def test_variants_match_plain_one_launch(cuda, B, N, H, Dh):
    D = H * Dh
    qkv = _qkv(B, N, H, Dh, cuda, seed=N + H)
    for name in av.VARIANTS:
        before, rows_before = av.LAUNCHES[name], rq.LAUNCHES
        oq, os_ = av.make_variant(name, H, N, D)(qkv)
        torch.cuda.synchronize()
        assert av.LAUNCHES[name] == before + 1 and rq.LAUNCHES == rows_before
        assert oq.shape == (B, N, D) and os_.shape == (B, N, 1)
        assert torch.isfinite(os_).all(), name
        ref_q, ref_s = av.variant_plain(name, H, N, D)(qkv)
        atol = 4e-2 if name == "bf16s" else 2e-2
        torch.testing.assert_close(oq.float() * os_, ref_q.float() * ref_s,
                                   rtol=0, atol=atol, msg=name)
        two = av.make_variant(name, H, N, D, bb=2)(qkv)
        assert torch.equal(two[0], oq) and torch.equal(two[1], os_), name
        again = av.make_variant(name, H, N, D)(qkv)
        assert torch.equal(again[0], oq) and torch.equal(again[1], os_), name


def test_sixteen_heads_launch_and_seventeen_raise(cuda):
    N, Dh = 33, 32
    for H in (16, 17):
        qkv = _qkv(2, N, H, Dh, cuda, seed=H)
        run = av.make_variant("noshift", H, N, H * Dh)
        if H > av.MAX_HEADS:
            with pytest.raises(ValueError, match="heads exceed"):
                run(qkv)
            continue
        oq, os_ = run(qkv)
        ref_q, ref_s = av.variant_plain("noshift", H, N, H * Dh)(qkv)
        torch.testing.assert_close(oq.float() * os_, ref_q.float() * ref_s,
                                   rtol=0, atol=2e-2)
