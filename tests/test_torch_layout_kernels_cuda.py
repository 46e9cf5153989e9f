"""The kernels of the flat and fused int8 layouts and of the attention-variant
sweep (K5, K14, K15) against their plain PyTorch versions, on the card. They
skip without a CUDA device. On a GPU machine without JAX, run them without
the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layout_kernels_cuda.py -q

Tolerances: dequantized attention within 2e-2, the JAX package's bound for
its attention kernel (the kernels sum in another order than PyTorch and their
expf is not bit-identical to PyTorch's exp); K5's real rows equal K4's bit
for bit (same tiles, same order); the whole-block kernel equals the chain of
split kernels bit for bit (the same device code), and is held to its plain
version by shares: under 2% of its bf16 outputs more than one bf16 ulp off,
under 2% of its int8 codes different and none more than 4 levels apart,
scales rtol 2e-2 (a code one level apart early in the block moves its whole
row through the products and LayerNorms that follow; each split op alone
stays within one level in under 1e-3, test_torch_int8_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.experiments import attn_variants as av
from chess_vision_tpu_torch.ops import attention as attn
from chess_vision_tpu_torch.ops import fused_block as fb
from chess_vision_tpu_torch.ops import quant
from chess_vision_tpu_torch.ops import rowquant as rq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, cuda, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a * scale).to(cuda)


def test_flat_attention_kernel_matches_plain_and_k4(cuda):
    for images, NP, n_real, H, Dh in [(2, 288, 257, 12, 64), (3, 32, 27, 2, 64),
                                      (2, 64, 64, 4, 16), (1, 96, 70, 1, 32)]:
        D = H * Dh
        qkv = _randn((images, NP, 3 * D), cuda, seed=NP).bfloat16()
        loud = qkv.clone()
        loud[:, n_real:, D:] = 1e4  # padded keys and values
        flat = qkv.reshape(images * NP, 3 * D)
        for shift in (None, -35.0):
            before = attn.FLAT_LAUNCHES
            oq, os_ = attn.fused_qkv_attention_quant_flat(flat, images, n_real,
                                                          H, shift)
            torch.cuda.synchronize()
            assert attn.FLAT_LAUNCHES == before + 1
            assert torch.isfinite(os_).all()  # padded query rows included
            ref_q, ref_s = attn.reference_attention_quant_flat(
                flat, images, n_real, H, shift)
            real = lambda t: t.reshape(images, NP, -1)[:, :n_real]  # noqa: E731
            torch.testing.assert_close(real(oq.float() * os_),
                                       real(ref_q.float() * ref_s),
                                       rtol=0, atol=2e-2)
            kq, ks = attn.fused_qkv_attention_quant(
                qkv[:, :n_real].contiguous(), H, shift)
            assert torch.equal(real(oq), kq) and torch.equal(real(os_), ks)
            lq, ls = attn.fused_qkv_attention_quant_flat(
                loud.reshape(images * NP, 3 * D), images, n_real, H, shift)
            assert torch.equal(real(lq), real(oq))
            assert torch.equal(real(ls), real(os_))
    with pytest.raises(ValueError):
        attn.fused_qkv_attention_quant_flat(flat, images, NP + 1, H)


def _block(cuda, D, O1, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def dense(k, o):
        return {"wq": torch.randint(-127, 128, (o, k), device=cuda,
                                    generator=g, dtype=torch.int8),
                "scale": torch.rand(o, device=cuda, generator=g) * 4e-4 + 2e-4,
                "bias": torch.randn(o, device=cuda, generator=g) * 0.1}

    def norm():
        return {"scale": torch.rand(D, device=cuda, generator=g) + 0.5,
                "bias": torch.randn(D, device=cuda, generator=g) * 0.1}

    return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}


def test_fused_block_kernel_matches_split_chain_and_plain(cuda):
    for B, N, H, Dh, O1 in [(2, 257, 12, 64, 3072), (2, 129, 2, 64, 512),
                            (3, 17, 4, 32, 256), (1, 40, 2, 16, 64)]:
        D = H * Dh
        q, nxt = _block(cuda, D, O1, seed=N), _block(cuda, D, O1, seed=N + 1)
        x = _randn((B, N, D), cuda, seed=N + 2).bfloat16()
        xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"],
                                   q["norm1"]["bias"])
        for shift, gelu in ((None, "sigmoid"), (1.0, "erf"), (1.0, "hard")):
            before = fb.LAUNCHES
            out = fb.fused_vit_block(xq, xs, x, q, nxt["norm1"], H, shift,
                                     gelu=gelu)
            torch.cuda.synchronize()
            assert fb.LAUNCHES == before + 1
            again = fb.fused_vit_block(xq, xs, x, q, nxt["norm1"], H, shift,
                                       gelu=gelu)
            split = quant.block_int8(x, xq, xs, q, nxt["norm1"], H, shift, gelu)
            for a, b, c in zip(out, again, split):
                assert torch.equal(a, b) and torch.equal(a, c)
            if shift is None:  # the row max: p rounds at other values
                continue       # than in the plain version (as K4)
            px, pq, ps = fb.fused_vit_block_plain(xq, xs, x, q, nxt["norm1"],
                                                  H, shift, gelu=gelu)
            xf, rf = out[0].float(), px.float()
            ulp = torch.exp2(torch.floor(torch.log2(rf.abs().clamp_min(1e-30)))
                             - 7)
            assert ((xf - rf).abs() > ulp).float().mean().item() < 2e-2
            levels = (out[1].int() - pq.int()).abs()
            assert levels.max().item() <= 4
            assert (levels > 0).float().mean().item() < 2e-2
            torch.testing.assert_close(out[2], ps, rtol=2e-2, atol=0)
    with pytest.raises(ValueError):
        fb.fused_vit_block(xq, xs, x, q, None, H)
    with pytest.raises(ValueError):  # res of another shape
        fb.fused_vit_block(xq, xs, x[:, :-1].contiguous(), q, nxt["norm1"], H)


@pytest.mark.parametrize("name", list(av.VARIANTS))
def test_attention_variant_kernel_matches_plain(cuda, name):
    """randn values at the sweep's shape and a ragged small one. ``bf16s``
    rounds scores, differences and exponentials to bf16, so a last-bit
    difference in a sum is a bf16 step of p: 4e-2; the others 2e-2."""
    atol = 4e-2 if name == "bf16s" else 2e-2
    for B, N, H, Dh in [(4, 257, 12, 64), (2, 33, 2, 64), (2, 70, 3, 32)]:
        D = H * Dh
        qkv = _randn((B, N, 3 * D), cuda, seed=N).bfloat16()
        before = av.LAUNCHES[name]
        oq, os_ = av.make_variant(name, H, N, D)(qkv)
        torch.cuda.synchronize()
        assert av.LAUNCHES[name] == before + 1
        ref_q, ref_s = av.variant_plain(name, H, N, D)(qkv)
        assert torch.isfinite(os_).all()
        torch.testing.assert_close(oq.float() * os_, ref_q.float() * ref_s,
                                   rtol=0, atol=atol)
        two = av.make_variant(name, H, N, D, bb=2)(qkv)
        assert torch.equal(two[0], oq) and torch.equal(two[1], os_)
    with pytest.raises(ValueError):
        av.make_variant(name, 2, 33, 2 * 48)(  # head dim 48
            torch.zeros((2, 33, 3 * 96), device=cuda, dtype=torch.bfloat16))
