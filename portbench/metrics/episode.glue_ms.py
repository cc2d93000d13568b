"""episode.glue_ms: device ms per control step in kernels that are not the
port's hand-written CUDA kernels (observation, solver tail, servo, arm
dynamics, carrot, plant outside the plant kernel, logs)."""


def read(ctx):
    t = ctx.glue_s()
    return None if t is None else 1e3 * t / ctx.units
