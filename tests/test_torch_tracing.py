"""The port's spans and host-wait counters (``treee_tpu_torch/utils/
profiling.py``) on the CPU: off, a span is one shared no-op and nothing is
recorded; on (``enable()`` or a recording ``torch.profiler``), records hold
names, parents, requests, host and device times and the waits of the
marked sites; the step, the frame and the focused view record their
stages; the CLI's ``-v`` prints the totals.  Two tests need the card: every
host sync of a step, a frame and a focused view there is a marked site,
and children's device times fit in their parent's.  On the card, where
JAX is absent, run them as

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import dataclasses
import json
import os
import subprocess
import sys
import traceback
import warnings

import pytest
import torch

from treee_tpu_torch import config as tconfig
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.parallel import sharding as tsh
from treee_tpu_torch.render import Camera
from treee_tpu_torch.utils import profiling

import torch_threads

torch_threads.share_cores()

STAGES = {"segmentation.grid", "segmentation.cc", "segmentation.clusters",
          "segmentation.match", "segmentation.voronoi",
          "segmentation.assign"}


@pytest.fixture(autouse=True)
def clean():
    """Each test starts and ends with tracing off and no records."""
    profiling.reset()
    with profiling.enable(False):
        yield
    profiling.reset()


def _small_config():
    cfg = tconfig.Config()
    return cfg.replace(
        segmentation=dataclasses.replace(
            cfg.segmentation, grid_size=32, max_bands=16,
            max_trees_per_band=32, max_segments=64, cc_occupied_cap=4096),
        render=dataclasses.replace(cfg.render, width=160, height=90))


@pytest.fixture(scope="module")
def stand():
    return tlas.synthetic_forest(n_trees=9, points_per_tree=400,
                                 ground_points=1500)


def _by_id():
    return {r["id"]: r for r in profiling.records()}


def test_off_is_one_shared_no_op():
    assert not profiling.tracing()
    a, b = profiling.span("a"), profiling.span("b", torch.device("cpu"))
    assert a is b
    with a:
        with b:
            profiling.waited("site")
            torch.ones(8).sum()
    assert profiling.records() == []


def test_records_hold_names_parents_requests_and_self_time():
    with profiling.enable():
        with profiling.span("req"):
            with profiling.span("a"):
                profiling.waited("x")
                with profiling.span("a.b"):
                    profiling.waited("y", 2)
            with profiling.span("c"):
                torch.ones(64).cumsum(0)
        with profiling.span("req"):
            pass
    recs = _by_id()
    assert [r["name"] for r in recs.values()] == ["req", "a", "a.b", "c",
                                                  "req"]
    req1, a, ab, c, req2 = recs.values()
    assert req1["parent"] is None and req2["parent"] is None
    assert a["parent"] == req1["id"] and c["parent"] == req1["id"]
    assert ab["parent"] == a["id"]
    assert {r["request"] for r in (req1, a, ab, c)} == {req1["id"]}
    assert req2["request"] == req2["id"] != req1["id"]
    # self time: the span less its children
    assert a["self_host_s"] == pytest.approx(a["host_s"] - ab["host_s"])
    assert req1["self_host_s"] == pytest.approx(
        req1["host_s"] - a["host_s"] - c["host_s"])
    assert 0 <= ab["host_s"] <= a["host_s"] <= req1["host_s"]
    # on the CPU the device time is the host time
    assert all(r["device_s"] == r["host_s"] for r in recs.values())
    assert set(req1["descendants"]) == {"a", "a.b", "c"}
    assert req1["descendants"]["a.b"]["count"] == 1
    assert req1["waited"] == {"x": 1, "y": 2}
    assert a["waited"] == {"x": 1, "y": 2} and ab["waited"] == {"y": 2}
    assert c["waited"] == {} and req2["waited"] == {}
    assert [r["id"] for r in profiling.records("req")] == [req1["id"],
                                                          req2["id"]]
    lines = profiling.table()
    assert [ln.split()[0] for ln in lines[1:]] == ["req", "a", "a.b", "c"]
    assert lines[1].split()[1] == "2"
    profiling.reset()
    assert profiling.records() == []


def test_enable_restores_the_previous_state():
    with profiling.enable():
        assert profiling.tracing()
        with profiling.enable(False):
            assert not profiling.tracing()
        assert profiling.tracing()
    assert not profiling.tracing()


def test_a_span_records_on_an_exception():
    with profiling.enable():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    profiling.waited("w")
                    raise ValueError("boom")
        with profiling.span("after"):
            pass
    recs = list(_by_id().values())
    assert [r["name"] for r in recs] == ["outer", "inner", "after"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert recs[0]["waited"] == {"w": 1}
    assert recs[2]["parent"] is None     # the stack was unwound


def test_the_oldest_request_is_dropped_first(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.enable():
        for i in range(4):
            with profiling.span(f"req{i}"):
                with profiling.span("stage"):
                    pass
    names = [r["name"] for r in profiling.records()]
    assert names == ["req2", "stage", "req3", "stage"]


def test_spans_are_on_the_profilers_timeline(tmp_path):
    """Under a CPU ``torch.profiler`` and no ``enable()``, each span is a
    ``user_annotation`` that encloses the aten ops run inside it, and the
    spans record."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    x = torch.arange(4096, dtype=torch.float32)
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("outer"):
            y = x * 2.0
            with profiling.span("inner"):
                z = torch.cumsum(y, 0)
    assert float(z[-1]) > 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def one(name, cat):
        got = [e for e in events if e["name"] == name and e["cat"] == cat]
        assert len(got) == 1, (name, cat, len(got))
        return got[0]

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    outer = one("outer", "user_annotation")
    inner = one("inner", "user_annotation")
    assert inside(inner, outer)
    assert inside(one("aten::mul", "cpu_op"), outer)
    assert inside(one("aten::cumsum", "cpu_op"), inner)
    assert not profiling.tracing()
    assert [r["name"] for r in profiling.records()] == ["outer", "inner"]


def _count_bodies(monkeypatch):
    """The CC bodies of what runs next: calls of the sweep kernel."""
    calls = []
    orig = kernels.cc_sweep

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(kernels, "cc_sweep", counted)
    return calls


def test_a_step_records_its_stages_and_waits(stand, monkeypatch):
    s = tpl.Session.from_points(stand, _small_config(), device="cpu")
    s.segment(0.75)
    bodies = _count_bodies(monkeypatch)
    with profiling.enable():
        s.segment(0.75)
    assert bodies
    (req,) = profiling.records("Session.segment")
    assert req["parent"] is None
    below = req["descendants"]
    assert set(below) == STAGES | {"segmentation", "characteristics"}
    assert all(d["count"] == 1 for d in below.values())
    (seg,) = profiling.records("segmentation")
    assert seg["parent"] == req["id"]
    assert set(seg["descendants"]) == STAGES
    # every stage directly inside the segmentation
    recs = profiling.records()
    assert {r["name"] for r in recs if r["parent"] == seg["id"]} == STAGES
    assert req["waited"] == {
        "segmentation.distance": 1, "segmentation.bincount": 2,
        "segmentation.cc.nonzero": 1,
        "segmentation.cc.fixpoint": len(bodies),
        "Session.segment.overflow": 1}
    (cc,) = profiling.records("segmentation.cc")
    assert cc["waited"] == {"segmentation.cc.nonzero": 1,
                            "segmentation.cc.fixpoint": len(bodies)}


def test_a_frame_records_its_stages_and_waits(stand):
    s = tpl.Session.from_points(stand, _small_config(), device="cpu")
    s.segment(0.75)
    cam = Camera.orbital(distance=30.0, device="cpu")
    ref = s.render(cam)
    with profiling.enable():
        img = s.render(cam)
    assert (img == ref).all()
    (req,) = profiling.records("Session.render")
    assert {k: v["count"] for k, v in req["descendants"].items()} == {
        "render.splat": 1, "render.shade": 2, "render.readback": 1}
    assert req["waited"] == {"render.background": 1, "render.readback": 1}
    recs = profiling.records()
    assert all(r["parent"] == req["id"] for r in recs if r is not recs[0])


FOCUS = dict(display="curve", show_hull=True, hull_include="crown",
             show_rbv=True, rbv_method="max", show_axis=True,
             axis_algo="average")
FOCUS_STAGES = {"focus.rows", "focus.property", "focus.axis", "focus.hull",
                "focus.rbv", "focus.lines", "render.splat", "render.shade",
                "render.readback"}


def _largest(s):
    counts = s.table.count.cpu().numpy()
    return int(counts[1:].argmax()) + 1


def test_a_focus_request_records_its_stages_and_waits(stand):
    """A first open of a tree (caches dropped): its stages nest under the
    ``Session.render_focus`` request, the k-NN inside the property, and its
    host reads are counted; the frame is the untraced one."""
    s = tpl.Session.from_points(stand, _small_config(), device="cpu")
    s.segment(0.75)
    sid = _largest(s)
    cam = Camera.orbital(distance=30.0, device="cpu")
    ref = s.render_focus(sid, cam, **FOCUS)
    s._clear_focus()
    with profiling.enable():
        img = s.render_focus(sid, cam, **FOCUS)
    assert (img == ref).all()
    (req,) = profiling.records("Session.render_focus")
    assert req["parent"] is None
    assert {k: v["count"] for k, v in req["descendants"].items()} == {
        **{k: 1 for k in FOCUS_STAGES}, "render.shade": 2,
        "neighbors.knn": 1}
    recs = _by_id()
    (knn,) = profiling.records("neighbors.knn")
    assert recs[knn["parent"]]["name"] == "focus.property"
    assert all(r["parent"] == req["id"] for r in recs.values()
               if r["name"] in FOCUS_STAGES)
    # the crown holds at most 512 points here: its rows go to the host
    assert req["waited"] == {
        "focus.counts": 1, "render.background": 1, "focus.axis.found": 1,
        "hull.count": 1, "hull.rows": 1, "hull.copy": 2, "rbv.lines": 2,
        "focus.lines": 1, "render.readback": 1}
    (hull,) = profiling.records("focus.hull")
    assert set(hull["waited"]) == {"hull.count", "hull.rows", "hull.copy"}
    # a second open of the same tree reads its caches: no k-NN, no counts
    profiling.reset()
    with profiling.enable():
        assert (s.render_focus(sid, cam, **FOCUS) == ref).all()
    (again,) = profiling.records("Session.render_focus")
    assert "neighbors.knn" not in again["descendants"]
    assert "focus.counts" not in again["waited"]


def test_a_focus_request_records_nothing_with_tracing_off(stand):
    s = tpl.Session.from_points(stand, _small_config(), device="cpu")
    s.segment(0.75)
    s.render_focus(_largest(s), Camera.orbital(distance=30.0, device="cpu"),
                   **FOCUS)
    assert profiling.records() == []


def test_mesh_shards_nest_their_spans_in_their_own_stacks(stand):
    """Over a mesh each shard program's spans nest in its own stack: a
    shard's spans never hang below another shard's."""
    mesh = tsh.make_mesh(["cpu"] * 2)
    s = tpl.Session.from_points(stand, _small_config(), device="cpu",
                                mesh=mesh)
    s.segment(0.75)
    with profiling.enable():
        s.segment(0.75)
    recs = _by_id()
    (req,) = [r for r in recs.values() if r["name"] == "Session.segment"]
    assert all(r["request"] == req["id"] for r in recs.values())
    segs = [r for r in recs.values() if r["name"] == "segmentation"]
    chars = [r for r in recs.values() if r["name"] == "characteristics"]
    assert len(segs) == 2 and len(chars) == 2
    assert all(r["parent"] == req["id"] for r in segs + chars)
    stages = [r for r in recs.values() if r["name"] in STAGES]
    assert {r["name"] for r in stages} == STAGES
    for r in stages:
        assert recs[r["parent"]]["name"] == "segmentation"


def test_cli_verbose_prints_the_span_table(tmp_path):
    env = dict(os.environ, TREEE_APP_CONFIG="small")
    p = subprocess.run(
        [sys.executable, "-m", "treee_tpu_torch", "--demo", "--cpu", "-v",
         "--frames", "1", "--width", "160", "--height", "90", "--out-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    head = lines.index("spans:")
    assert lines[head + 1].split() == ["span", "count", "host", "ms",
                                       "device", "ms", "waits"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[head + 2:]}
    for name in ("segment", "Session.segment", "segmentation",
                 "characteristics", "frame", "Session.render",
                 "render.splat", "render.shade", "render.readback"):
        assert name in rows, name
    assert rows["segment"][0] == "1" and rows["render.shade"][0] == "2"
    assert all(float(v[1]) >= 0 and float(v[2]) >= 0 for v in rows.values())


# ---- on the card ------------------------------------------------------------

def _syncs(fn):
    """(what ``fn`` returns, the CUDA syncs it made as
    ``torch.cuda.set_sync_debug_mode`` reports them: each one's message and
    the Python stack that made it)."""
    got = []

    def show(message, category, filename, lineno, file=None, line=None):
        # the mode's one-time notice that it is a prototype is no sync
        if "called a synchronizing CUDA operation" in str(message):
            got.append(f"{message}\n" + "".join(
                traceback.format_stack(limit=8)[:-1]))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, got


@pytest.mark.cuda
def test_every_host_sync_of_a_step_and_a_frame_is_a_marked_wait():
    """On the card: the syncs of one ``Session.segment`` and of one
    ``Session.render`` equal their ``waited`` counts, and each span's
    children take at most its own device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from treee_tpu_torch.ops.kernels import build
    build.build()
    build.library()
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=8000,
                                ground_points=20000)
    s = tpl.Session.from_points(pts, device="cuda")
    cam = Camera.orbital(distance=60.0, device="cuda")
    s.segment(0.75)
    s.render(cam)
    voronoi = kernels.nearest_slot.launches
    with profiling.enable():
        _, step_syncs = _syncs(lambda: s.segment(0.75))
        _, frame_syncs = _syncs(lambda: s.render(cam))
    (step,) = profiling.records("Session.segment")
    (frame,) = profiling.records("Session.render")
    # the step's Voronoi is one kernel launch and adds no wait
    assert kernels.nearest_slot.launches == voronoi + 1
    assert set(step["waited"]) == {
        "segmentation.distance", "segmentation.bincount",
        "segmentation.cc.nonzero", "segmentation.cc.fixpoint",
        "Session.segment.overflow"}
    assert sum(step["waited"].values()) == len(step_syncs), (
        step["waited"], "\n".join(step_syncs))
    assert sum(frame["waited"].values()) == len(frame_syncs), (
        frame["waited"], "\n".join(frame_syncs))
    recs = profiling.records()
    for r in recs:
        kids = [c["device_s"] for c in recs if c["parent"] == r["id"]]
        assert sum(kids) <= r["device_s"] + 0.05e-3, r["name"]
        assert r["device_s"] > 0


@pytest.mark.cuda
def test_every_host_sync_of_a_focus_request_is_a_marked_wait():
    """On the card: the syncs of a tree's first open (curvature with hull,
    RBV and axis overlays, a crown of thousands of points, so the hull
    takes its interior discard) equal its ``waited`` counts, and each
    span's children take at most its own device time: those on the
    request's stream together, the overlays' (on the second stream, beside
    the curvature) each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from treee_tpu_torch.ops.kernels import build
    build.build()
    build.library()
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=8000,
                                ground_points=20000)
    s = tpl.Session.from_points(pts, device="cuda")
    s.segment(0.75)
    s.characteristics()
    sid = _largest(s)
    cam = Camera.orbital(distance=30.0, device="cuda")
    s.render_focus(sid, cam, **FOCUS)
    s._clear_focus()
    knn = kernels.knn_select.launches
    with profiling.enable():
        _, syncs = _syncs(lambda: s.render_focus(sid, cam, **FOCUS))
    (req,) = profiling.records("Session.render_focus")
    # the curvature's k-NN is one kernel launch and adds no wait
    assert kernels.knn_select.launches == knn + 1
    assert {"hull.directions", "hull.planes",
            "hull.survivors"} <= set(req["waited"])
    assert sum(req["waited"].values()) == len(syncs), (
        req["waited"], "\n".join(syncs))
    recs = profiling.records()
    beside = {"focus.axis", "focus.hull", "focus.rbv"}
    for r in recs:
        kids = [c for c in recs if c["parent"] == r["id"]]
        assert sum(c["device_s"] for c in kids
                   if c["name"] not in beside) <= r["device_s"] + 0.05e-3, (
            r["name"])
        assert all(c["device_s"] <= r["device_s"] + 0.05e-3 for c in kids)
        assert r["device_s"] > 0
