"""``host_waits.step``: the mean count, over the window's ``Session.segment``
requests, of the places where the step's host read a device value and so
waited for the card (the program's ``waited`` counter: the CC fixpoint
tests and the rest of its marked sites)."""

from harness import program


def read(run):
    return program.mean_waits(run, "Session.segment")
