"""``idle_pct.frame``: the share of the traced window in which no kernel,
copy or memset ran on the card: 1 - (the union of the device's intervals in
the profiler's trace / the window).  The traced run's spans synchronize at
both ends, which adds idle time that an untraced run does not have."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
