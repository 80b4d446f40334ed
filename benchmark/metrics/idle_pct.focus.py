"""``idle_pct.focus``: the share of the traced window of the focused view's
requests in which no kernel, copy or memset ran on the card: 1 - (the union
of the device's intervals in the profiler's trace / the window)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
