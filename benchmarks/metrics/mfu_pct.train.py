"""Model step: the share of the chip's bf16 peak that training reaches.

A train step's operations are taken as three times the forward's (the
backward twice the forward) for every image of the run's window, over the
window's time on the host clock (the untraced window: in a ``--trace 1``
run the profiler slows the host), over the bf16 peak. Recomputation under
rematerialization is not counted: it is work the step chose to do."""

from benchmarks import work

UNIT = "%"


def read(ctx):
    cell = ctx["cell"]
    if not ctx["items"] or not ctx["window_s"]:
        return None
    macs = sum(cell.reference().work(cell.model).values())
    rate = 3 * 2 * macs * ctx["items"] / ctx["window_s"]
    return 100.0 * rate / work.PEAKS["bf16"]
