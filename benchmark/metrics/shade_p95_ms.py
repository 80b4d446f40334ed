"""``shade_p95_ms``: the 95th percentile (nearest rank) over the window's
``Session.render`` requests of the device time of the program's
``render.shade`` spans (the dilation, palette and background of
``resolve_keys``, and the eye-dome), summed a frame."""

from harness import program


def read(run):
    return program.p95_ms(run, "Session.render", "render.shade")
