"""Spans and host-wait counters of the port, on the profiler's timeline.

``span(name, device)`` marks a stage of the program (a ``with`` block).
While tracing is on, each span records its name, its parent (the innermost
open span), its request (the outermost open span), its host start and end,
and on a CUDA device two CUDA events on the device's current stream, at
entry and at exit: the span's device time is the stream time between them.
It is read lazily, after one synchronize, when the records are read
(:func:`records`); a span never synchronizes.  While a profiler records,
each span also opens a ``torch.profiler.record_function`` of its name, so
the program's stages sit on the profiler's timeline, on the kernels' clock
(with no profiler, nothing would observe one, and it costs ten times the
rest of the span's host time).

``waited(site)`` counts a place where the host reads a device value and so
blocks until the card gets there; the count goes to the innermost open
span, and a span's counts include its descendants'.

Tracing is on while :func:`enable` is in force or while a
``torch.profiler`` records.  Off, ``span`` returns one shared no-op object
and ``waited`` returns at once: nothing is allocated or recorded.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

# the records kept: at most this many spans, the oldest request dropped first
MAX_SPANS = 65536

_profiler_enabled = getattr(torch._C._autograd, "_profiler_enabled",
                            lambda: False)
_on = False
_ids = itertools.count(1)
_lock = threading.Lock()
# request id -> its finished spans, oldest request first
_store: collections.OrderedDict[int, list[_Span]] = collections.OrderedDict()
_stored = 0


class _Local(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []    # the open spans, outermost first


_local = _Local()


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "t0", "t1", "ev0",
                 "ev1", "device", "device_s", "waits", "stack", "rf")

    def __init__(self, name: str, device, profiled: bool):
        self.name = name
        self.id = next(_ids)
        self.device = (device if device is not None and device.type == "cuda"
                       else None)
        self.rf = torch.profiler.record_function(name) if profiled else None
        self.ev0 = self.ev1 = self.device_s = self.waits = None

    def __enter__(self):
        stack = self.stack = _local.stack
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent else None
        self.request = parent.request if parent else self.id
        stack.append(self)
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> bool:
        if self.device is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(torch.cuda.current_stream(self.device))
        self.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.stack = None
        _keep(self)
        return False


def _keep(s: _Span) -> None:
    global _stored
    with _lock:
        _store.setdefault(s.request, []).append(s)
        _stored += 1
        while _stored > MAX_SPANS:
            oldest = next(iter(_store))
            if len(_store) > 1:
                _stored -= len(_store.pop(oldest))
            else:
                _store[oldest].pop(0)
                _stored -= 1


def tracing() -> bool:
    """Whether spans record now: :func:`enable` is in force, or a
    ``torch.profiler`` records."""
    return _on or _profiler_enabled()


def span(name: str, device: torch.device | None = None):
    """A span named ``name`` (use as ``with span(...):``), timed on
    ``device``'s current stream where that is a CUDA device; the shared
    no-op while tracing is off."""
    profiled = _profiler_enabled()
    if not (_on or profiled):
        return _OFF
    return _Span(name, device, profiled)


def waited(site: str, n: int = 1) -> None:
    """Count ``n`` host waits on the device at ``site``, in the innermost
    open span (none is open while tracing is off)."""
    stack = _local.stack
    if stack:
        top = stack[-1]
        if top.waits is None:
            top.waits = {}
        top.waits[site] = top.waits.get(site, 0) + n


class _Enabled:
    def __init__(self, prev: bool):
        self.prev = prev

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        global _on
        _on = self.prev
        return False


def enable(on: bool = True) -> _Enabled:
    """Turn tracing on (or off) now; as a ``with`` block, restore the
    previous state at its end."""
    global _on
    prev, _on = _on, bool(on)
    return _Enabled(prev)


class on_stack:
    """``with on_stack(s):`` runs the block on span stack ``s`` (a list from
    :func:`fork`): a program that runs interleaved with others, such as a
    shard program, nests its spans in its own stack."""

    def __init__(self, s: list):
        self.s = s

    def __enter__(self):
        self.prev, _local.stack = _local.stack, self.s
        return self.s

    def __exit__(self, *exc) -> bool:
        _local.stack = self.prev
        return False


def fork() -> list:
    """A new span stack that starts inside the spans open now."""
    return list(_local.stack)


def reset() -> None:
    """Forget every record."""
    global _stored
    with _lock:
        _store.clear()
        _stored = 0


def _device_times(spans: list[_Span]) -> None:
    """Each span's device time from its events, after one synchronize of
    each device they were recorded on; without events, its host time."""
    pending = [s for s in spans if s.device_s is None]
    for dev in {s.device for s in pending if s.ev0 is not None}:
        torch.cuda.synchronize(dev)
    for s in pending:
        if s.ev0 is not None:
            s.device_s = s.ev0.elapsed_time(s.ev1) / 1e3
            s.ev0 = s.ev1 = None
        else:
            s.device_s = (s.t1 - s.t0) / 1e9


def records(name: str | None = None) -> list[dict]:
    """Each recorded span named ``name`` (every span if None), oldest
    first: ``name``, ``id``, ``parent`` and ``request`` ids, ``host_s`` and
    ``device_s``, ``self_host_s`` and ``self_device_s`` (less its
    children's), ``descendants`` (name -> ``count``, ``host_s``,
    ``device_s``: totals over the spans below it) and ``waited`` (site ->
    count, its own and its descendants')."""
    with _lock:
        requests = [list(v) for v in _store.values()]
    _device_times([s for spans in requests for s in spans])
    out = []
    for spans in requests:
        children = collections.defaultdict(list)
        for s in spans:
            children[s.parent].append(s)
        memo: dict[int, tuple] = {}

        def below(s: _Span):
            """(descendant totals by name, waits by site) of ``s``."""
            if s.id in memo:
                return memo[s.id]
            desc: dict[str, dict] = {}
            waits = dict(s.waits or {})
            for c in children.get(s.id, ()):
                d = desc.setdefault(c.name, {"count": 0, "host_s": 0.0,
                                             "device_s": 0.0})
                d["count"] += 1
                d["host_s"] += (c.t1 - c.t0) / 1e9
                d["device_s"] += c.device_s
                cdesc, cwaits = below(c)
                for k, v in cdesc.items():
                    d = desc.setdefault(k, {"count": 0, "host_s": 0.0,
                                            "device_s": 0.0})
                    for f in d:
                        d[f] += v[f]
                for k, v in cwaits.items():
                    waits[k] = waits.get(k, 0) + v
            memo[s.id] = desc, waits
            return memo[s.id]

        for s in sorted(spans, key=lambda s: s.id):
            if name is not None and s.name != name:
                continue
            desc, waits = below(s)
            kids = children.get(s.id, ())
            host = (s.t1 - s.t0) / 1e9
            out.append({
                "name": s.name, "id": s.id, "parent": s.parent,
                "request": s.request, "host_s": host,
                "device_s": s.device_s,
                "self_host_s": host - sum((c.t1 - c.t0) / 1e9 for c in kids),
                "self_device_s": s.device_s - sum(c.device_s for c in kids),
                "descendants": desc, "waited": waits})
    return out


def table() -> list[str]:
    """The records by span name, in the order first recorded: the count,
    the host and device ms (totals), and the host waits inside them."""
    rows: dict[str, list] = {}
    for r in records():
        row = rows.setdefault(r["name"], [0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] += r["host_s"]
        row[2] += r["device_s"]
        row[3] += sum(r["waited"].values())
    lines = [f"  {'span':<28} {'count':>6} {'host ms':>10} {'device ms':>10}"
             f" {'waits':>6}"]
    for k, (n, h, d, w) in rows.items():
        lines.append(f"  {k:<28} {n:>6} {1e3 * h:>10.3f} {1e3 * d:>10.3f}"
                     f" {w:>6}")
    return lines
