"""``segmentation_ms``: the mean over the window's ``Session.segment``
requests of the device time of the program's ``segmentation`` span
(``segmentation.segment_points``: the stream time between CUDA events at its
ends, no synchronize), read from the program's records."""

from harness import program


def read(run):
    return program.mean_ms(run, "Session.segment", "segmentation")
