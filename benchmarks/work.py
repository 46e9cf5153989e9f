"""The yardstick's frozen counts: peaks of one NVIDIA H100 SXM and the
operations and bytes of the operations whose rooflines the benchmark
reports.

Counts are of the operation, not of a kernel: each input byte read once,
each output byte written once, the products' multiply-adds twice (one
multiply, one add), whatever a kernel re-reads or recomputes. A later change
that fuses, renames or replaces a kernel leaves them as they are.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit.
PEAKS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak of ``precision`` and bytes over the memory bandwidth."""
    return max(ops / PEAKS[precision], nbytes / HBM_BYTES_PER_S)


def vit_shape(model: dict) -> tuple[int, int, int, int]:
    """(tokens, width, heads, blocks) of a ViT configuration."""
    tokens = (model["input_size"] // model["patch_size"]) ** 2 + 1
    return tokens, model["embed_dim"], model["num_heads"], model["depth"]


def attention_forward(images: int, model: dict,
                      out_bytes: float = 2.0) -> tuple:
    """(operations, bytes) of every block's attention over ``images``:
    q k^T and p v (4 N^2 d a head), reading qkv in bf16 and writing the
    output at ``out_bytes`` an element (2: bf16; 1 + 4 / D: int8 codes with
    a float32 scale a token)."""
    n, d, _, blocks = vit_shape(model)
    rows = images * blocks * n
    ops = images * blocks * 4 * n * n * d
    return ops, rows * (3 * d * 2 + d * out_bytes)


def attention_backward(images: int, model: dict) -> tuple:
    """(operations, bytes) of every block's attention backward: dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q (8 N^2 d a head), reading qkv and the
    output's gradient in bf16 and writing dqkv in bf16."""
    n, d, _, blocks = vit_shape(model)
    rows = images * blocks * n
    return images * blocks * 8 * n * n * d, rows * (3 * d + d + 3 * d) * 2


def int8_products(images: int, model: dict) -> tuple:
    """(operations, bytes) of every block's four int8 products (qkv, proj,
    fc1, fc2) over ``images``, as the W8A8 block computes them: int8 rows
    with a float32 scale a row and int8 weights with a float32 scale and
    bias a column in; out, qkv in bf16, proj and fc2 the bf16 residual
    (read and written) with the next LayerNorm's int8 rows and scales, fc1
    the GELU's int8 rows and scales."""
    n, d, _, blocks = vit_shape(model)
    hidden = int(d * model["mlp_ratio"])
    rows = images * n
    ops = nbytes = 0.0
    for k, cols, out in ((d, 3 * d, 2 * 3 * d),
                         (d, d, 2 * d + 2 * d + d + 4),
                         (d, hidden, hidden + 4),
                         (hidden, d, 2 * d + 2 * d + d + 4)):
        ops += 2.0 * rows * k * cols
        nbytes += rows * (k + 4) + cols * (k + 8) + rows * out
    return blocks * ops, blocks * nbytes
