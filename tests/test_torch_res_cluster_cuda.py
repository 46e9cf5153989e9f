"""K9 (residual + LayerNorm + requant, on thread-block clusters) and K10
(residual, one kernel of one block per SM) of the int8 GEMM against their
plain PyTorch versions on the card. They skip without a CUDA device. On a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_res_cluster_cuda.py -q

Criteria, those of ``chip_smoke.py`` phases 6 and 7: x' (bf16) equal to the
plain version's bit for bit (the kernel rounds each product and sum as the
plain version does); codes within one level in under 1e-3 of the elements
and scales rtol 1e-5 (the LayerNorm's sums run in another order than
PyTorch's); a second launch equal to the first bit for bit.
"""

import pytest
import torch

from chess_vision_tpu_torch.ops import int8_matmul as mm
from chess_vision_tpu_torch.ops import rowquant as rq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, M, K, O, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ints = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=cuda, generator=g, dtype=torch.int8)
    ops = (ints(M, K), torch.rand((M, 1), device=cuda, generator=g) * 0.02 + 0.002,
           ints(O, K), torch.rand(O, device=cuda, generator=g) * 0.0004 + 0.0002,
           torch.randn(O, device=cuda, generator=g) * 0.1)
    res = torch.randn((M, O), device=cuda, generator=g).bfloat16()
    ln = (torch.rand(O, device=cuda, generator=g) + 0.5,
          torch.randn(O, device=cuda, generator=g) * 0.1)
    return ops, res, ln


def _codes_ok(q, s, ref_q, ref_s) -> bool:
    diff = (q.int() - ref_q.int()).abs()
    return (diff.max().item() <= 1 and (diff > 0).float().mean().item() < 1e-3
            and ((s - ref_s).abs() / ref_s.abs()).max().item() <= 1e-5)


def _check_route(M, K, O, cuda):
    ops, res, (g, b) = _operands(cuda, M, K, O)
    before = dict(mm.LAUNCHES)
    first = mm.int8_matmul_res_ln_quant(*ops, res, g, b)
    again = mm.int8_matmul_res_ln_quant(*ops, res, g, b)
    x_ref, q_ref, s_ref = mm.int8_matmul_res_ln_quant_plain(*ops, res, g, b)
    x10 = mm.int8_matmul_res(*ops, res)
    x10_again = mm.int8_matmul_res(*ops, res)
    torch.cuda.synchronize()
    assert {k: mm.LAUNCHES[k] - before[k] for k in ("res_ln_quant", "res")} == {
        "res_ln_quant": 2, "res": 2}
    assert torch.equal(first[0], x_ref)
    assert _codes_ok(first[1], first[2], q_ref, s_ref)
    assert all(torch.equal(a, c) for a, c in zip(first, again))
    assert torch.equal(x10, mm.int8_matmul_res_plain(*ops, res))
    assert torch.equal(x10, x10_again)


# phase 7's ragged shapes (rows, columns and depth that end inside the 64 x
# 256 tile and the 128-byte stage) and the ViT-B/16 serving shapes (proj,
# fc2 and the last fc2 at batch 256)
@pytest.mark.parametrize("M,K,O", [(300, 80, 72), (129, 16, 8), (1000, 768, 264),
                                   (64, 128, 256), (4999, 3072, 776),
                                   (65792, 768, 768), (65792, 3072, 768)])
def test_cluster_route_matches_plain(cuda, M, K, O):
    route = mm.res_route(O)
    assert route["route"] == "cluster" and route["count"] > 0
    assert route["cluster_blocks"] == mm.res_cluster_blocks(O)
    assert mm.res_route(O, "res")["route"] == "tiles"
    _check_route(M, K, O, cuda)


def test_two_launch_route_above_the_cluster_cap(cuda):
    """Nine column tiles would make K9's cluster larger than 8 blocks: the
    product, then the row pass. K10 takes its one kernel at any width."""
    assert mm.res_route(2304)["route"] == "two_launch"
    assert mm.res_route(2304, "res")["route"] == "tiles"
    _check_route(300, 128, 2304, cuda)


def test_planted_fault_fails(cuda):
    """A LayerNorm over one cluster rank's 256 columns only (its statistics
    from column tile 0) fails the criteria the kernel meets."""
    ops, res, (g, b) = _operands(cuda, 300, 128, 768, seed=1)
    x, q, s = mm.int8_matmul_res_ln_quant(*ops, res, g, b)
    _, q_ref, s_ref = mm.int8_matmul_res_ln_quant_plain(*ops, res, g, b)
    xf = x.float()
    head = xf[:, :256]
    mu = head.mean(-1, keepdim=True)
    var = (head - mu).square().mean(-1, keepdim=True)
    bad_q, bad_s = rq.quantize_rows((xf - mu) * torch.rsqrt(var + 1e-6) * g + b)
    torch.cuda.synchronize()
    assert _codes_ok(q, s, q_ref, s_ref)
    assert not _codes_ok(bad_q, bad_s, q_ref, s_ref)
