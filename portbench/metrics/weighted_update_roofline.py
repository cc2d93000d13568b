"""weighted_update.roofline_share: the least time of the stage
"softmin-weighted update" (``work/weighted_update.py``) over the device
time of the kernels that the stage's file names, in %."""


def read(ctx):
    return ctx.roofline_share("weighted_update")
