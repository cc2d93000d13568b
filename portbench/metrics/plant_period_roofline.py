"""plant_period.roofline_share: the least time of one control period of the
frozen-coefficient plant at the cell's B (``work/plant_period.py``) over
the device time of the kernels that the stage's file names, in %."""


def read(ctx):
    return ctx.roofline_share("plant_period")
