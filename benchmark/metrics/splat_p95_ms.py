"""``splat_p95_ms``: the 95th percentile (nearest rank, as
``frame_p95_ms``) over the window's ``Session.render`` requests of the
device time of the program's ``render.splat`` span (projection, key pack and
the scatter-min, ``splat.rasterize_keys``)."""

from harness import program


def read(run):
    return program.p95_ms(run, "Session.render", "render.splat")
