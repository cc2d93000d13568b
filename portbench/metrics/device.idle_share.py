"""device.idle_share: the share of the measured window in which the card had
no call of the window in flight, in %: one less the device time of its
calls (CUDA events around each, from its first op to its last, a graph's
inner gaps counted busy) over the window's length.  Read from the window,
not from the traced slice, where the profiler slows the host 2-3x; the time
the card spends waiting for the host between calls is what it shows."""


def read(ctx):
    if ctx.window_busy_s is None or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.window_busy_s / ctx.window_s)
