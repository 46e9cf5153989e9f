"""Kernels: the int8 products' share of their roofline while serving.

The least time of every block's four int8 products (qkv, proj, fc1, fc2)
over the boards the traced part served (``work.int8_products``), over
the device time of
the kernels that compute them in the profiler's trace: the wgmma GEMM (the
qkv product and K8, fc1 with the GELU and requantization) and the residual
GEMM (K9 proj and fc2 with the next LayerNorm, K10 the last fc2)."""

from benchmarks import work

UNIT = "%"
KERNELS = r"int8_wgmma_kernel|int8_res_kernel"


def read(ctx):
    cell, trace = ctx["cell"], ctx["trace"]
    if trace is None or not ctx["traced_items"]:
        return None
    seconds = trace.seconds(KERNELS)
    if seconds <= 0:
        return None
    ops, nbytes = work.int8_products(ctx["traced_items"], cell.model)
    return 100.0 * work.least_seconds(ops, nbytes, "int8") / seconds
