"""Model step: the share of the chip's peak that served boards reach.

Operations of the configuration's forward for every board completed in the
run's window (twice its multiply-adds, from the reference's ``work``), over
the window's time on the host clock (the untraced window: in a
``--trace 1`` run the profiler slows the host), over the peak of the
cell's product precision (int8 for a quantized cell, else bf16)."""

from benchmarks import work

UNIT = "%"


def read(ctx):
    cell = ctx["cell"]
    if not ctx["items"] or not ctx["window_s"]:
        return None
    macs = sum(cell.reference().work(cell.model).values())
    peak = work.PEAKS["int8" if cell.traffic.get("quant") == "int8" else "bf16"]
    return 100.0 * 2 * macs * ctx["items"] / ctx["window_s"] / peak
