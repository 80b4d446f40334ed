"""``knn_p95_ms``: the 95th percentile (nearest rank, as ``frame_p95_ms``)
over the window's ``Session.render_focus`` requests of the device time of
the program's ``neighbors.knn`` span: the curvature's k-NN among the
tree's member rows (``ops/neighbors.knn_bruteforce``)."""

from harness import program_focus


def read(run):
    return program_focus.p95_ms(run, ("neighbors.knn",))
