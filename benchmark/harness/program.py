"""The port's own spans and host-wait counters, as the per-layer metrics
read them (``treee_tpu_torch.utils.profiling``).

The program records its spans only while tracing is on, which in a traced
run is while the window's profiler records: its records are the window's
requests, each a ``Session.segment`` or ``Session.render`` span with the
spans of its stages below it.  A span's device time is the stream time
between CUDA events at its ends (its host time on the CPU).  The records are
taken once a run, on the first read, and the program's store is emptied, so
a second run in the process reads its own.  A program that keeps no such
records gives None, and its metrics are left out.
"""

from __future__ import annotations

import math

REQUESTS = ("Session.segment", "Session.render")


def _take() -> dict:
    try:
        from treee_tpu_torch.utils import profiling
    except ImportError:
        return {}
    if not hasattr(profiling, "records"):
        return {}
    got = {name: [r for r in profiling.records(name) if r["parent"] is None]
           for name in REQUESTS}
    profiling.reset()
    return got


def requests(run, name: str) -> list[dict]:
    """The window's requests named ``name``: the program's records of
    them, with the totals of the spans below each."""
    if not hasattr(run, "program_records"):
        run.program_records = _take()
    return run.program_records.get(name, [])


def per_request_ms(run, request: str, span: str) -> list[float]:
    """Each request's device time in the spans named ``span`` below it, in
    ms (requests without such a span left out)."""
    return [1e3 * r["descendants"][span]["device_s"]
            for r in requests(run, request) if span in r["descendants"]]


def mean_ms(run, request: str, span: str) -> float | None:
    t = per_request_ms(run, request, span)
    return sum(t) / len(t) if t else None


def p95_ms(run, request: str, span: str) -> float | None:
    """The 95th percentile, nearest rank, as ``frame_p95_ms`` takes it."""
    t = sorted(per_request_ms(run, request, span))
    return t[max(0, math.ceil(0.95 * len(t)) - 1)] if t else None


def mean_waits(run, request: str) -> float | None:
    """The mean count of host waits on the device a request."""
    n = [sum(r["waited"].values()) for r in requests(run, request)]
    return sum(n) / len(n) if n else None
