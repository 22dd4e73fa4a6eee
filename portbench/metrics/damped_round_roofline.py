"""damped_round_roofline (%, kernel layer: `damped_kernel.damped_rounds` ->
csrc/damped_round.cu): the frozen bound of one call (bounds.py) over the
kernel's device time a call, in the traced fused blocks."""

from portbench import bounds


def read(ctx):
    return bounds.roofline_share(ctx, "damped")
