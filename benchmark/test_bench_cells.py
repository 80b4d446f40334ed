"""The benchmark's cells run on the CPU at a tiny size through the internal
entry (``harness.tiny``): the result line, the traced line, the comparison
with the reference, its control and the faults it has to catch."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import control
from harness import files, tiny

SPEC = files.spec()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def result(lines: list[str]) -> dict:
    return json.loads(lines[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload):
    rc, out, err = tiny.run(workload, 2**31 + 77)
    assert rc == 0, err
    res = result(out)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in SPEC["end_to_end"]
            if files.applies(m, workload)}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["value"] > 0 and isinstance(m["unit"], str), name
    assert res["device"]["count"] == 1
    # every compared number beside its limit, last on standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    assert "setup_parts" in json.loads(out[-2])


@pytest.mark.parametrize("workload", ["grid15m-slider", "grid15m-orbit"])
def test_traced_line(workload):
    rc, out, err = tiny.run(workload, 5, trace=True)
    assert rc == 0, err
    res = result(out)
    assert res["correct"] is True
    spans = {m["name"] for m in SPEC["per_layer"]
             if files.applies(m, workload) and m["source"] == "program_span"}
    # a CPU run has no device trace: only the span metrics are read
    assert set(res["metrics"]) == spans
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_run():
    a = result(tiny.run("grid15m-orbit", 9)[1])
    b = result(tiny.run("grid15m-orbit", 9)[1])
    assert a["checks"] == b["checks"] and a["correct"] and b["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_rejected(workload):
    """The reference with its positions in bfloat16, in the port's place,
    fails a limit of every cell (as on the card at the cells' sizes)."""
    sections, scene, over = tiny.sizes(workload)
    got = control.readings(workload, 3, torch.device("cpu"), sections,
                           scene, over)
    assert any(v["value"] > v["limit"] for v in got.values()), got


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_on_a_clean_run(workload):
    """The port and the reference read 0 apart on the tiny stands, where
    no f32 sum or view matrix rounds far enough to move a point."""
    rc, out, err = tiny.run(workload, 21)
    assert rc == 0, err
    assert all(v["value"] == 0 for v in result(out)["checks"].values())


# ---- faults planted in the port: each has to make ``correct`` false ------

def _stale_segment(pipeline):
    def segment(self, max_distance=None, **kw):
        if self.table is None:
            return ORIG["segment"](self, max_distance, **kw)
    return segment


def _half_pipeline(pipeline):
    def full_pipeline(pos, valid, max_distance, cfg=pipeline.DEFAULT_CONFIG):
        half = valid.clone()
        half[half.shape[0] // 2:] = False
        return ORIG["full_pipeline"](pos, half, max_distance, cfg)
    return full_pipeline


def _altered_segment(pipeline):
    """One tree's answer altered: its points take the next id."""
    def segment(self, max_distance=None, **kw):
        res = ORIG["segment"](self, max_distance, **kw)
        seg = self.cloud.segment.clone()
        seg[seg == seg[0]] += 1
        self.cloud = self.cloud.replace(segment=seg)
        return res
    return segment


def _stale_render(pipeline):
    last = {}

    def render(self, camera=None, **kw):
        if "img" not in last:
            last["img"] = ORIG["render"](self, camera, **kw)
        return last["img"]
    return render


def _half_render(pipeline):
    def render(self, camera=None, **kw):
        cloud = self.cloud
        valid = cloud.valid.clone()
        valid[valid.shape[0] // 2:] = False
        self.cloud = cloud.replace(valid=valid)
        try:
            return ORIG["render"](self, camera, **kw)
        finally:
            self.cloud = cloud
    return render


def _altered_render(pipeline):
    """One tree's answer altered where the frame is made: the palette
    coordinate of the points of the segment with the most points."""
    def prop_from_segment(segment):
        prop = ORIG["prop_from_segment"](segment)
        ids, n = torch.unique(segment[segment > 0], return_counts=True)
        return torch.where(segment == ids[n.argmax()], (prop + 0.5) % 1.0,
                           prop)
    return prop_from_segment


ORIG = {}
FAULTS = [
    ("grid15m-slider", "segment", _stale_segment),
    ("grid15m-slider", "full_pipeline", _half_pipeline),
    ("grid15m-slider", "segment", _altered_segment),
    ("grid15m-orbit", "render", _stale_render),
    ("grid15m-orbit", "render", _half_render),
    ("grid15m-orbit", "prop_from_segment", _altered_render),
]


@pytest.mark.parametrize("workload,attr,fault", FAULTS,
                         ids=[f[2].__name__.strip("_") for f in FAULTS])
def test_fault_is_caught(workload, attr, fault, monkeypatch):
    """A state left unchanged, half of the rows left out, an answer altered
    where it is produced: each fault planted in the port's timed path turns
    ``correct`` false (a cell on one card has no exchange between cards to
    leave out)."""
    from treee_tpu_torch import pipeline
    owner = {"full_pipeline": pipeline,
             "prop_from_segment": pipeline.splat}.get(attr, pipeline.Session)
    ORIG[attr] = getattr(owner, attr)
    monkeypatch.setattr(owner, attr, fault(pipeline))
    rc, out, err = tiny.run(workload, 11)
    assert rc == 0, err
    res = result(out)
    assert res["correct"] is False, res["checks"]


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(files.BENCH_DIR / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=files.ROOT, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_thinned_stand_is_exact():
    from harness import scene
    pts = np.arange(3000, dtype=np.float32).reshape(1000, 3)
    a = scene.thin(pts, 700, 4)
    assert len(a) == 700 and np.array_equal(a, scene.thin(pts, 700, 4))
    assert (np.diff(a[:, 0]) > 0).all()        # the generator's order
    with pytest.raises(ValueError):
        scene.thin(pts, 1001, 4)


@pytest.mark.cuda
def test_cell_on_card():
    """One short run of the first cell on the card, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(files.BENCH_DIR / "run.py"),
                        "--workload", CELLS[0], "--seed", "2147483700",
                        "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=files.ROOT,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
