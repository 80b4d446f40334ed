"""``step_ms``: the wait for a whole-scan recomputation, as the measured
window (host clock, from its start to the end of the last request begun in
it) over the number of requests completed in it (closed loop, one user)."""


def read(run):
    if not run.completed:
        return None
    return 1e3 * run.window_s / run.completed
