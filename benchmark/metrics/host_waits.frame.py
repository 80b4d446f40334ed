"""``host_waits.frame``: the mean count, over the window's ``Session.render``
requests, of the places where the frame's host read a device value and so
waited for the card (the program's ``waited`` counter)."""

from harness import program


def read(run):
    return program.mean_waits(run, "Session.render")
