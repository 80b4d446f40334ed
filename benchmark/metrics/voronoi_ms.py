"""``voronoi_ms``: the mean over the window's ``Session.segment`` requests
of the device time of the program's ``segmentation.voronoi`` span (each
occupied cell's nearest tracked slot: the brute force, or the flood)."""

from harness import program


def read(run):
    return program.mean_ms(run, "Session.segment", "segmentation.voronoi")
