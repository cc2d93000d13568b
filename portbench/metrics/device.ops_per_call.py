"""device.ops_per_call: device operations (kernels, copies and sets) per
call (request or batched call) or per control step, an exact count."""


def read(ctx):
    return len(ctx.ops) / ctx.units if ctx.ops else None
