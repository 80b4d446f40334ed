"""``characteristics_ms``: the mean over the window's ``Session.segment``
requests of the device time of the program's ``characteristics`` span
(``characteristics.compute_segments``: the table and the classes)."""

from harness import program


def read(run):
    return program.mean_ms(run, "Session.segment", "characteristics")
