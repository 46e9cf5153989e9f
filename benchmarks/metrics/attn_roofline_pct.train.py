"""Kernels: the attention's share of its roofline while training.

The least time of every block's attention forward and backward over the
traced images (``work.attention_forward`` and ``attention_backward``), over
the device time of the kernels attributed to them in the profiler's trace
(K2 forward, K3 backward on either route)."""

from benchmarks import work

UNIT = "%"
KERNELS = (r"attention_fwd_kernel|attention_any_fwd|attention_bwd"
           r"|attention_any_bwd")


def read(ctx):
    cell, trace = ctx["cell"], ctx["trace"]
    if trace is None or not ctx["traced_items"]:
        return None
    seconds = trace.seconds(KERNELS)
    if seconds <= 0:
        return None
    f_ops, f_bytes = work.attention_forward(ctx["traced_items"], cell.model)
    b_ops, b_bytes = work.attention_backward(ctx["traced_items"], cell.model)
    least = (work.least_seconds(f_ops, f_bytes, "bf16")
             + work.least_seconds(b_ops, b_bytes, "bf16"))
    return 100.0 * least / seconds
