"""The program's records of the focused view's requests, as the focus
cell's per-layer metrics read them.

``program.py`` takes the records of ``Session.segment`` and
``Session.render``; this takes those of ``Session.render_focus`` (the
request span of ``treee_tpu_torch.pipeline.Session.render_focus``), in the
same way: once a run, on the first read, emptying the program's store.  A
program without that span gives no records, and its metrics are left out.
"""

from __future__ import annotations

import math

REQUEST = "Session.render_focus"
# the overlays' stages of a request
OVERLAYS = ("focus.axis", "focus.hull", "focus.rbv", "focus.lines")


def requests(run) -> list[dict]:
    """The window's focus requests: the program's records of them, with
    the totals of the spans below each."""
    if not hasattr(run, "focus_records"):
        try:
            from treee_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        if profiling is None or not hasattr(profiling, "records"):
            run.focus_records = []
        else:
            run.focus_records = [r for r in profiling.records(REQUEST)
                                 if r["parent"] is None]
            profiling.reset()
    return run.focus_records


def p95_ms(run, spans: tuple[str, ...]) -> float | None:
    """The 95th percentile, nearest rank, over the requests holding any of
    ``spans`` of their device time in those spans summed, in ms."""
    t = sorted(1e3 * sum(r["descendants"][s]["device_s"] for s in spans
                         if s in r["descendants"])
               for r in requests(run)
               if any(s in r["descendants"] for s in spans))
    return t[max(0, math.ceil(0.95 * len(t)) - 1)] if t else None


def mean_waits(run) -> float | None:
    """The mean count of host waits on the device a request."""
    n = [sum(r["waited"].values()) for r in requests(run)]
    return sum(n) / len(n) if n else None
