"""graphs.enqueue_ms: host ms per call from entering the port's call (inputs
copied to the card, the graph loaded and replayed) to its return, before
the readback; the mean over every call of the measured window (host clock,
untraced)."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
