"""Kernels: the attention's share of its roofline while serving.

The least time of every block's attention over the boards the traced part served
(``work.attention_forward``: q k^T and p v, qkv read once in bf16, the
output written once: bf16, or int8 codes with a float32 scale a token in a
quantized cell), over the device time of the kernels attributed to it in
the profiler's trace: the bf16 forward (K2) and the quantizing attention
(K4, its int8 legs and their long route)."""

from benchmarks import work

UNIT = "%"
KERNELS = r"attention_fwd_kernel|attention_any_fwd|attention_quant"


def read(ctx):
    cell, trace = ctx["cell"], ctx["trace"]
    if trace is None or not ctx["traced_items"]:
        return None
    seconds = trace.seconds(KERNELS)
    if seconds <= 0:
        return None
    quant = cell.traffic.get("quant") == "int8"
    out_bytes = 1 + 4 / cell.model["embed_dim"] if quant else 2.0
    ops, nbytes = work.attention_forward(ctx["traced_items"], cell.model,
                                         out_bytes)
    return 100.0 * work.least_seconds(ops, nbytes, "bf16") / seconds
