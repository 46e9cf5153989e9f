"""The attention-variant kernel (K15, ``csrc/attention_variants.cu``) on the
shared attention loop, checked before the card is reached.

- The schedule: each variant's row statistic is final before its walk over
  the keys, which runs in 64-key tiles of 16-key sub-steps (sub-steps wholly
  past the last key skipped), with no online rescale. Emulated in plain
  torch on the plain version's scores: walk 1's max over the sub-steps is
  the row max bit for bit, walk 2's p against it is ``plain_softmax``'s p
  bit for bit (normbound's bound, summed in the kernel's order, within f32
  rounding of the plain one), the skip changes no bit, and the row sum
  taken in the kernel's order (each thread's pairs in key order, then the
  four threads of a row) gives the plain version's codes within one level.
  The emulation takes the scores and P V from torch: the mma.sync's own
  order of summation has no CPU form.
- The cross-head exchange of the row maxima (K4's, in the kernel's epilogue) with
  no rowsum floor: bit for bit ``quantize_rows``.
- ``make_variant`` allocates its outputs and nothing else (no f32 scratch)
  and passes the C entry point exactly its arguments; the kernel's variant
  enum and head limit are the Python side's.
"""

import math
import pathlib
import re
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.experiments import attn_variants as av
from chess_vision_tpu_torch.ops import _build
from chess_vision_tpu_torch.ops.rowquant import quantize_rows

torch.set_num_threads(2)

SOURCE = pathlib.Path(av.__file__).resolve().parents[1] / "csrc" / \
    "attention_variants.cu"
TILE, SUB = 64, 16  # keys a ring tile (kFlashKTile), keys a sub-step
ROW_MAX = ("base", "foldscale", "noexp", "fexp", "bf16s")


def _sum_pairs_in_order(x: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of fl(x[2c]^2 + x[2c+1]^2), c in order, each
    addition rounded: the kernel's per-key |k|^2 (pair_sq)."""
    x = x.float()
    acc = torch.zeros(x.shape[:-1])
    for c in range(0, x.shape[-1], 2):
        acc = acc + (x[..., c] * x[..., c] + x[..., c + 1] * x[..., c + 1])
    return acc


def _qn2_kernel_order(q: torch.Tensor) -> torch.Tensor:
    """|q'_i|^2 as the kernel sums it: thread t of a row holds the pairs at
    columns 16 kk + 2t and 16 kk + 8 + 2t, adds them kk by kk, then the four
    threads' partial sums meet by two xor shuffles."""
    q = q.float()
    parts = []
    for t in range(4):
        acc = torch.zeros(q.shape[:-1])
        for kk in range(q.shape[-1] // 16):
            a, b = 16 * kk + 2 * t, 16 * kk + 8 + 2 * t
            lo = q[..., a] * q[..., a] + q[..., a + 1] * q[..., a + 1]
            hi = q[..., b] * q[..., b] + q[..., b + 1] * q[..., b + 1]
            acc = acc + (lo + hi)
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def k15_schedule(name: str, qkv: torch.Tensor, num_heads: int,
                 skip: bool = True):
    """The kernel's schedule on the plain scores. Returns (m, p, rowsum):
    the shift of each row (B, H, N, 1), p before its bf16 rounding (B, H, N,
    N; 0 where a key is masked or not visited) and the row sums of the
    rounded p in the kernel's order (B, H, N). ``skip``: sub-steps wholly
    past the last key are not visited (the kernel); else they are, masked."""
    B, N, C3 = qkv.shape
    Dh = C3 // 3 // num_heads
    q, k, _ = qkv.reshape(B, N, 3, num_heads, Dh).unbind(2)
    s, _, _ = av.plain_softmax(name, q, k)
    prob = {"noexp": lambda x: x, "fexp": av._fastexp2,
            "fexp_ns": av._fastexp2,
            "bf16s": lambda x: torch.exp(x.bfloat16().float())}.get(
                name, torch.exp)

    def sub_steps():
        for k0 in range(0, N, TILE):
            for hs in range(4):
                lo = k0 + hs * SUB
                if lo < N or not skip:
                    yield lo

    if name in ROW_MAX:  # walk 1: K alone, the row max over the sub-steps
        m = torch.full((B, num_heads, N, 1), -math.inf)
        for lo in sub_steps():
            m = torch.maximum(m, s[..., lo:lo + SUB].amax(-1, keepdim=True)
                              if lo < N else m)
    elif name == "normbound":  # a pass over K alone, then the bound
        qf = (q.float() * av._fold(name, Dh)).bfloat16()
        kmax = _sum_pairs_in_order(k).amax(dim=1)                 # (B, H)
        qn2 = _qn2_kernel_order(qf).permute(0, 2, 1)              # (B, H, N)
        m = (torch.sqrt(qn2 * kmax[..., None]) - 40.0).unsqueeze(-1)
    else:
        m = torch.full((B, num_heads, N, 1),
                       av._SHIFT_EXP2 if name == "fexp_ns" else av._SHIFT)
    # p of every score against the final shift, taken on the whole tensor
    # (torch's vector and scalar exp may differ in the last bit, so slices
    # would not be a fair copy); walk 2 visits it sub-step by sub-step
    p_all = prob(s - m)
    p = torch.zeros_like(s)
    lanes = torch.zeros((B, num_heads, N, 4))  # each row's four threads
    for lo in sub_steps():  # walk 2, in key order
        if lo >= N:  # a masked sub-step: p = 0, the sums gain fl(0 + 0)
            lanes = lanes + 0.0
            continue
        sub = p_all[..., lo:lo + SUB]
        p[..., lo:lo + SUB] = sub
        pr = torch.zeros(s.shape[:-1] + (SUB,))
        pr[..., :sub.shape[-1]] = sub.bfloat16().float()
        for h in range(2):  # n-blocks of 8 keys; thread t: keys 2t, 2t + 1
            pair = pr[..., 8 * h:8 * h + 8].reshape(*pr.shape[:-1], 4, 2)
            lanes = lanes + (pair[..., 0] + pair[..., 1])
    x1 = lanes + lanes[..., [1, 0, 3, 2]]   # shfl_xor 1
    rowsum = x1 + x1[..., [2, 3, 0, 1]]     # shfl_xor 2
    return m, p, rowsum[..., 0]


@pytest.mark.parametrize("N,Dh", [(17, 16), (257, 32)])
def test_schedule_matches_variant_plain(N, Dh):
    H = 2
    g = torch.Generator().manual_seed(N)
    qkv = torch.randn((2, N, 3 * H * Dh), generator=g)
    qkv[..., :H * Dh] *= 4.0  # logits of O(10), as a trained checkpoint
    qkv = qkv.bfloat16()
    q, k, v = qkv.reshape(2, N, 3, H, Dh).unbind(2)
    for name in av.VARIANTS:
        _, shift, p_plain = av.plain_softmax(name, q, k)
        m, p, rowsum = k15_schedule(name, qkv, H)
        m_all, p_all, rowsum_all = k15_schedule(name, qkv, H, skip=False)
        assert torch.equal(m, m_all) and torch.equal(p, p_all)
        assert torch.equal(rowsum, rowsum_all), name  # the skip moves no bit
        if name == "normbound":
            torch.testing.assert_close(m, shift, rtol=1e-6, atol=1e-5)
            p_plain = torch.exp(av.plain_softmax(name, q, k)[0] - m)  # its m
        else:
            assert torch.equal(m, torch.broadcast_to(
                torch.as_tensor(shift, dtype=torch.float32), m.shape)), name
        assert torch.equal(p, p_plain), name
        pr = p.bfloat16().float()
        torch.testing.assert_close(rowsum, pr.sum(-1), rtol=1e-6, atol=0)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v.float()) / \
            rowsum.permute(0, 2, 1).unsqueeze(-1)  # no floor
        oq, os_ = quantize_rows(o.reshape(2, N, H * Dh))
        rq, rs = av.variant_plain(name, H, N, H * Dh)(qkv)
        levels = (oq.int() - rq.int()).abs()
        assert levels.max() <= 1 and levels.float().mean() < 1e-3, name
        torch.testing.assert_close(os_, rs, rtol=1e-5, atol=0)


def k15_exchange(o: np.ndarray, num_heads: int):
    """The kernel's quantization of f32 rows o (M, D) = P V / rowsum (no
    floor): block h keeps its head's columns and its rows' partial max |o|
    over them; each block takes amax as the max of all blocks' partial
    maxima (floored at 1e-8), codes its columns with fl(127 / amax), and
    rank 0 writes fl(amax * fl(1/127))."""
    Dh = o.shape[1] // num_heads
    heads = [o[:, h * Dh:(h + 1) * Dh] for h in range(num_heads)]
    part = [np.abs(cols).max(axis=1) for cols in heads]
    amax = np.maximum(np.maximum.reduce(part), np.float32(1e-8))
    inv = (np.float32(127.0) / amax).astype(np.float32)
    codes = [np.clip(np.rint(cols * inv[:, None]), -127, 127).astype(np.int8)
             for cols in heads]
    return (np.concatenate(codes, axis=1),
            (amax * np.float32(1.0 / 127.0)).astype(np.float32)[:, None])


@pytest.mark.parametrize("num_heads,Dh", [(2, 16), (5, 32)])
def test_cross_head_exchange_equals_quantize_rows(num_heads, Dh):
    rng = np.random.default_rng(num_heads)
    pv = rng.normal(size=(300, num_heads * Dh)).astype(np.float32)
    # row sums with no floor: tiny and signed ones too (noexp's p = s - m)
    rowsum = rng.uniform(1e-3, 300.0, size=(300, 1)).astype(np.float32)
    rowsum[::7] *= -1.0
    rowsum[5] = 1e-35
    o = (pv / rowsum).astype(np.float32)
    o[1, :] = 0.25                    # a row whose amax sits in every head
    o[2, -1] = 50.0                   # ... and in the last head alone
    halves = (np.arange(-126, 127, dtype=np.float32) + 0.5)[:o.shape[1] - 1]
    o[3, :halves.size] = halves       # exact ties: round half to even
    o[3, -1] = 127.0
    q, s = k15_exchange(o, num_heads)
    rq, rs = quantize_rows(torch.from_numpy(o))
    np.testing.assert_array_equal(q, rq.numpy())
    np.testing.assert_array_equal(s, rs.numpy())


class _FakeCudaQkv:
    """What ``make_variant`` reads of a CUDA tensor, on a CPU-only torch."""

    def __init__(self, B, N, C3):
        self.shape = torch.Size((B, N, C3))
        self.device = SimpleNamespace(type="cuda")
        self.dtype = torch.bfloat16

    def dim(self):
        return 3

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


def test_make_variant_allocates_no_scratch(monkeypatch):
    B, N, H, Dh = 4, 33, 12, 64
    D = H * Dh
    made, calls = [], []
    real_empty = torch.empty

    def empty(shape, dtype=None, device=None):
        made.append((tuple(shape), dtype))
        return real_empty(shape, dtype=dtype)

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(
        cvt_attention_variant=entry))
    before = dict(av.LAUNCHES)
    av.make_variant("fexp", H, N, D, bb=2)(_FakeCudaQkv(B, N, 3 * D))
    assert made == [((B, N, D), torch.int8), ((B, N, 1), torch.float32)]
    (args,) = calls
    assert len(args) == len(_build._SIGNATURES["cvt_attention_variant"])
    assert args[3:9] == (av.VARIANTS["fexp"], B, N, H, Dh, 2)
    assert args[9] == 1 / 8 and args[10] == av._fold("fexp", Dh)
    assert args[-1] == 7
    assert av.LAUNCHES["fexp"] == before["fexp"] + 1
    with pytest.raises(ValueError, match="heads exceed"):
        av.make_variant("base", av.MAX_HEADS + 1, N, 32 * (av.MAX_HEADS + 1))(
            _FakeCudaQkv(B, N, 3 * 32 * (av.MAX_HEADS + 1)))
    assert len(calls) == 1


def test_kernel_variants_and_limits_are_the_python_sides():
    text = SOURCE.read_text()
    enum = re.search(r"enum Variant : int \{(.*?)\};", text, re.S).group(1)
    values = dict(re.findall(r"k(\w+) = (\d+)", enum))
    names = {"Base": "base", "FoldScale": "foldscale", "NoShift": "noshift",
             "NoExp": "noexp", "Fexp": "fexp", "FexpNs": "fexp_ns",
             "Bf16s": "bf16s", "NormBound": "normbound"}
    assert {names[k]: int(v) for k, v in values.items() if k in names} == \
        av.VARIANTS
    assert int(values["Variants"]) == len(av.VARIANTS)
    assert f"kMaxHeads = {av.MAX_HEADS};" in text
    row_max = re.search(r"kRowMax =\s*([^;]*);", text).group(1)
    assert sorted(names[k] for k in re.findall(r"V == k(\w+)", row_max)) == \
        sorted(ROW_MAX)
    assert "scratch" not in text.split('extern "C"')[1]
