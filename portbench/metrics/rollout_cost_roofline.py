"""rollout_cost.roofline_share: the least time of the stage "rollout and
cost" at the peaks (``work/rollout_cost.py``) over the device time of the
kernels that the stage's file names, in %."""


def read(ctx):
    return ctx.roofline_share("rollout_cost")
