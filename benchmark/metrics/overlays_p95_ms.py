"""``overlays_p95_ms``: the 95th percentile (nearest rank) over the
window's ``Session.render_focus`` requests of the device time of the
overlays' spans summed a request: the trunk axis, the crown hull, the RBV
cages and the lines drawn over the frame (``focus.axis``, ``focus.hull``,
``focus.rbv``, ``focus.lines``)."""

from harness import program_focus


def read(run):
    return program_focus.p95_ms(run, program_focus.OVERLAYS)
