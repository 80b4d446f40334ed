"""``host_waits.focus``: the mean count, over the window's
``Session.render_focus`` requests, of the places where the focused view's
host read a device value and so waited for the card (the program's
``waited`` counter)."""

from harness import program_focus


def read(run):
    return program_focus.mean_waits(run)
