"""The traced run's instruments: spans around the calls into the port's
layers, a record of each kernel call's work, and the profiler's trace of the
window reduced to busy time, idle gaps, kernel device time and rooflines.

Spans come from the benchmark's files: a span named in ``spans/<name>.json``
wraps the module attribute it names (the call the ``Session`` makes into a
layer); the request kinds put their own spans around ``Session`` calls.  In
the traced run a span synchronizes the device at both ends, so its time is
the layer's whole time; with tracing off a span costs nothing and nothing is
wrapped.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from . import files

# the card's peak rates (NVIDIA H100 SXM data sheet, at its 700 W limit):
# device memory, and f32 operations outside the tensor cores; integer
# compares and selects count at the f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PREFIX = "bench."           # the benchmark's spans in the profiler's trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


class Tracer:
    """Spans and kernel records of one run; inert unless ``on``."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.cuda = device.type == "cuda"
        self.spans: dict[str, list[float]] = defaultdict(list)
        self.recording = False          # inside the measured window
        self.key = None                 # the current request's work key
        self._ordinal: dict[str, int] = defaultdict(int)
        self._work: dict[tuple, tuple[int, int]] = {}
        self.calls: dict[str, list] = defaultdict(list)  # name -> [(b, ops)]
        self.launches: dict[str, int] = defaultdict(int)
        self.counts: dict[str, object] = {}
        self._undo: list = []
        self._prof = None
        self.summary: TraceSummary | None = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """Time ``name`` (host clock, synchronized at both ends) when on."""
        if not self.on:
            yield
            return
        self.sync()
        with torch.profiler.record_function(PREFIX + name):
            t = time.perf_counter()
            yield
            self.sync()
            dt = time.perf_counter() - t
        if self.recording:
            self.spans[name].append(dt)

    def label(self, name: str):
        """Mark ``name`` in the trace (no synchronize, no timing) when on;
        the idle gaps are labelled by such marks and by spans."""
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def request(self, key) -> None:
        """A request starts; ``key`` names what its kernels' data-dependent
        work depends on (the same key, the same work)."""
        self.key = key
        self._ordinal.clear()

    # ---- wrapping the port -------------------------------------------------

    def _wrap(self, module, attr: str, make) -> None:
        orig = getattr(module, attr)
        setattr(module, attr, make(orig))
        self._undo.append((module, attr, orig))

    def wrap_span(self, name: str) -> None:
        """Put span ``name`` around the call that ``spans/<name>.json``
        names (``{"module": ..., "attr": ...}``)."""
        where = files.load_json("spans", name)
        module = importlib.import_module(where["module"])

        def make(orig):
            @functools.wraps(orig)
            def spanned(*args, **kw):
                with self.span(name):
                    return orig(*args, **kw)
            return spanned
        self._wrap(module, where["attr"], make)

    def wrap_kernel(self, kernels_module, name: str) -> None:
        """Record each call of the port's kernel wrapper ``name``: its
        launches and its work as ``kernels/<name>.py`` counts it."""
        count = files.load_module("kernels", name)
        self.counts[name] = count

        def make(orig):
            @functools.wraps(orig)
            def recorded(*args, **kw):
                before = orig.launches
                out = orig(*args, **kw)
                if self.on:
                    self._record(name, count, args, orig.launches - before)
                return out
            return recorded
        self._wrap(kernels_module, name, make)

    def _record(self, name: str, count, args, launches: int) -> None:
        ordinal = self._ordinal[name]
        self._ordinal[name] += 1
        if getattr(count, "DATA", False):
            # data-dependent work: worked out once per (request key, call),
            # in the warm-up, which runs every key, and looked up after
            key = (self.key, name, ordinal)
            if key not in self._work:
                self._work[key] = count.work(args)
            work = self._work[key]
        else:
            work = count.work(args)
        if self.recording:
            self.calls[name].append(work)
            self.launches[name] += launches

    def unwrap(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    # ---- the profiler over the window ------------------------------------

    @contextlib.contextmanager
    def window(self):
        """The measured window: records kernels and spans, and when on runs
        ``torch.profiler`` over it."""
        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self.recording = True
        try:
            with torch.profiler.record_function(PREFIX + "window"):
                yield
                self.sync()
        finally:
            self.recording = False
            prof.stop()
        self._prof = prof

    def reduce(self) -> None:
        """Read the window's trace into :attr:`summary` (after the window;
        the trace goes through a file in ``TMPDIR`` that is removed)."""
        if self._prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        self._prof = None
        self.summary = TraceSummary(events, self)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceSummary:
    """The window's device activity, from the profiler's trace (times in
    the trace's microseconds, reported in seconds)."""

    def __init__(self, events: list, tracer: Tracer):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == PREFIX + "window"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS
               and w0 <= float(e["ts"]) < w1]
        busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                            w1)) for e in dev])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.device_events = len(dev)
        # kernel time and record count per counted kernel
        self.kernels: dict[str, dict] = {}
        for name, count in tracer.counts.items():
            pats = tuple(count.DEVICE_NAMES)
            mine = [e for e in dev if e.get("cat") == "kernel"
                    and any(p in e.get("name", "") for p in pats)]
            calls = tracer.calls.get(name, [])
            self.kernels[name] = {
                "device_s": sum(float(e["dur"]) for e in mine) / 1e6,
                "records": len(mine),
                "launches": tracer.launches.get(name, 0),
                "bound_s": sum(bound_s(b, o) for b, o in calls),
                "calls": len(calls)}
        by_name: dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e.get("name", "?")[:120]] += float(e["dur"]) / 1e6
        self.device_ops = sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP]
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
        if busy:
            gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        host = [e for e in xs if e.get("cat") in ("user_annotation", "cpu_op")
                and e.get("name") != PREFIX + "window"]
        self.idle_gaps = [[self._label(host, g0), (g1 - g0) / 1e6]
                          for g0, g1 in gaps if g1 > g0]

    @staticmethod
    def _label(host: list, t: float) -> str:
        """The innermost benchmark span and host op the host was in at
        ``t``."""
        span, op = None, None
        for e in host:
            a = float(e["ts"])
            if a <= t < a + float(e["dur"]):
                name = e.get("name", "?")
                if name.startswith(PREFIX):
                    if span is None or a > span[0]:
                        span = (a, name[len(PREFIX):])
                elif op is None or a > op[0]:
                    op = (a, name)
        parts = [span[1] if span else "no span", op[1] if op else "no op"]
        return " / ".join(parts)[:120]

    def roofline_pct(self, names) -> float | None:
        """Sum of the calls' bounds over their device time, in %, for the
        kernels ``names``; None where none ran or the trace lost records of
        one (fewer kernel records than launches)."""
        got = [self.kernels[n] for n in names if n in self.kernels]
        if not got or not sum(k["calls"] for k in got):
            return None
        for n in names:
            k = self.kernels.get(n)
            if k and k["records"] < k["launches"]:
                print(f"trace: {n}: {k['records']} kernel records for "
                      f"{k['launches']} launches; roofline left out",
                      file=sys.stderr)
                return None
        dev = sum(k["device_s"] for k in got)
        if dev <= 0:
            return None
        return 100.0 * sum(k["bound_s"] for k in got) / dev

    def idle_pct(self) -> float | None:
        if self.window_s <= 0 or self.device_events == 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)
