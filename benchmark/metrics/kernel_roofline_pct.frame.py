"""``kernel_roofline_pct.frame``: the hand kernels of the frame (splat
dilation, eye-dome) against their roofline, counted as
``kernel_roofline_pct.step`` counts the step's."""

KERNELS = ("dilate", "eye_dome")


def read(run):
    return run.trace.roofline_pct(KERNELS) if run.trace else None
