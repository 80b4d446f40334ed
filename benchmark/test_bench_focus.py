"""The focus cell (``als15m-focus``) on the CPU at the tiny size: its
traffic is fixed by the seed, its traced line reads the focused view's
spans, and faults planted in the port's focused view turn ``correct``
false: curvature from 15 neighbours, the crown hull of the direction
support points alone, and a stale frame returned for a new tree."""

import json

import numpy as np
import pytest
import torch

from harness import cell, files, tiny

WORKLOAD = "als15m-focus"
SPEC = files.spec()


def result(lines):
    return json.loads(lines[-1])


def _traffic(seed):
    """The focus traffic of ``seed`` prepared on the port at the tiny size:
    (its cycle of requests, its cameras, its trees)."""
    from harness import scene
    sections, scene_, over = tiny.sizes(WORKLOAD)
    params = {**files.load_json("traffic", "focus"), **over}
    kind = files.load_module("requests", "focus")
    pts = scene.make_points(scene_, 4)
    t = kind.Traffic(params, seed, pts, None, sections)
    api = cell.ProgramApi(sections, torch.device("cpu"))
    with torch.no_grad():
        t.prepare(api.session(pts), api, None)
    return ([t.slot(i) for i in range(24)],
            [np.asarray(c[0]).tolist() for c in t.cameras], t.trees)


def test_focus_traffic_is_fixed_by_the_seed():
    a, b = _traffic(2**33 + 1), _traffic(2**33 + 1)
    assert a == b
    other = _traffic(2**33 + 2)
    assert a[0] != other[0] and a[1] != other[1]
    # every seed opens the same trees, in its own order, each once a cycle
    assert a[2] == other[2] and len(set(a[2])) == len(a[2]) == 8
    assert sorted(a[0][:8]) == list(range(8))


def test_focus_trees_are_the_nearest_counts():
    kind = files.load_module("requests", "focus")
    counts = np.array([0, 10, 30, 31, 50, 7, 29])
    present = counts > 0
    assert kind.pick(counts, present, [30, 30, 30, 100, 1, 1]) == [
        2, 3, 6, 4, 5, 1]
    present[4] = False
    assert kind.pick(counts, present, [100]) == [3]


def test_focus_traced_line_reads_the_spans():
    rc, out, err = tiny.run(WORKLOAD, 5, trace=True)
    assert rc == 0, err
    res = result(out)
    assert res["correct"] is True
    spans = {m["name"] for m in SPEC["per_layer"]
             if files.applies(m, WORKLOAD) and m["source"] == "program_span"}
    assert spans == {"knn_p95_ms", "overlays_p95_ms", "host_waits.focus"}
    # a CPU run has no device trace: only the span metrics are read
    assert set(res["metrics"]) == spans
    assert all(m["value"] > 0 for m in res["metrics"].values())


# ---- faults planted in the port's focused view ------------------------------

def _fewer_neighbours(monkeypatch):
    from treee_tpu_torch import characteristics as ch
    orig = ch.segment_curvature
    monkeypatch.setattr(ch, "segment_curvature",
                        lambda pos, member, k=31, **kw: orig(pos, member, 15,
                                                              **kw))


def _support_hull(monkeypatch):
    """The hull of the 512 directions' support points alone; at the tiny
    size, where few crowns reach 512 points, of 64 directions'."""
    from treee_tpu_torch import hull3d

    def convex_hull(pos, mask, k_dirs=512, exact=False, **kw):
        dirs = torch.from_numpy(hull3d._fibonacci_sphere(64))
        idx = torch.unique(hull3d.support_candidates(pos, mask, dirs))
        only = torch.zeros_like(mask)
        only[idx.long()] = True
        return orig(pos, mask & only, exact=True)
    orig = hull3d.convex_hull
    monkeypatch.setattr(hull3d, "convex_hull", convex_hull)


def _stale_frame(monkeypatch):
    """Each tree's members and curvature computed, and the frame of the
    tree opened before it returned."""
    from treee_tpu_torch import pipeline
    orig = pipeline.Session.render_focus
    last = {}

    def render_focus(self, segment_id, camera=None, **kw):
        img = orig(self, segment_id, camera, **kw)
        stale, last["img"] = last.get("img", img), img
        return stale
    monkeypatch.setattr(pipeline.Session, "render_focus", render_focus)


@pytest.mark.parametrize("fault", [_fewer_neighbours, _support_hull,
                                   _stale_frame],
                         ids=lambda f: f.__name__.strip("_"))
def test_focus_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    rc, out, err = tiny.run(WORKLOAD, 11)
    assert rc == 0, err
    res = result(out)
    assert res["correct"] is False, res["checks"]
