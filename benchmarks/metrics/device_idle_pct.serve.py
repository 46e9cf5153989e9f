"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card (``torch.profiler``'s CUDA activity)."""

UNIT = "%"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
