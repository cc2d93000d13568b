"""solver.glue_ms: device ms per call in kernels that are not the port's
hand-written CUDA kernels (the solver step's small PyTorch kernels)."""


def read(ctx):
    t = ctx.glue_s()
    return None if t is None else 1e3 * t / ctx.units
