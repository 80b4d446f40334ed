"""The benchmark's files: ``BENCHMARK.json`` against the contract's shapes,
every name found by its file, the imports it allows, and a cell, traffic
mix and metric added by files alone."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import cell, files, scene

SPEC = files.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            # a per-layer metric's cells report the metric it moves
            mover = next(e for e in SPEC["end_to_end"]
                         if e["name"] == m["moves"])
            assert files.applies(mover, w), (m["name"], w)
    for w in SPEC["workloads"]:
        got = [m for m in SPEC["end_to_end"] if files.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert any(files.applies(m, w["name"]) for m in SPEC["per_layer"])


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        conf = json.loads((files.ROOT / c["file"]).read_text())
        assert files.has_module("scenes", conf["scene"]["generator"])
    for w in SPEC["workloads"]:
        t = files.load_json("traffic", w["traffic"])
        assert files.has_module("requests", t["request"])
        assert t["limits"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        reader = files.load_module("metrics", m["name"])
        for k in getattr(reader, "KERNELS", ()):
            count = files.load_module("kernels", k)
            assert count.DEVICE_NAMES and callable(count.work)


def test_config_files_state_the_config_run():
    """The configurations are the port's ``Config()`` at its defaults, and
    the file states every field of it, which the reference reads."""
    import dataclasses
    from treee_tpu_torch import config as port_cfg
    for c in SPEC["configs"]:
        sections = json.loads((files.ROOT / c["file"]).read_text())["config"]
        port = scene.config_from(port_cfg, sections)
        assert port == port_cfg.Config()
        full = json.loads(json.dumps(dataclasses.asdict(port)))
        assert sections == full


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_imports():
    """No file of the benchmark imports JAX, flax or the JAX package, and
    the reference imports nothing of the port (whole top-level names:
    ``treee_tpu_torch`` is not ``treee_tpu``)."""
    for path in files.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(cell.FORBIDDEN), path
        if "reference" in path.relative_to(files.BENCH_DIR).parts:
            assert "treee_tpu_torch" not in tops, path


def test_run_loads_no_forbidden_module():
    """What a run loads, checked in a fresh process after a tiny run: no
    JAX, no JAX package; and the reference alone loads nothing of the
    port."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference.session\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('treee_tpu_torch', 'jax', 'treee_tpu')], 'reference'\n"
        "from harness import cell, tiny\n"
        "rc, out, err = tiny.run('grid15m-orbit', 1)\n"
        "assert rc == 0, err\n"
        "assert not cell.forbidden_modules(), cell.forbidden_modules()\n"
        % (str(files.BENCH_DIR), str(files.ROOT)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]


def test_forbidden_names_are_whole(monkeypatch):
    import treee_tpu_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "jaxlib_probe", sys)
    assert not {"treee_tpu_torch", "jaxlib_probe"} & set(
        cell.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in cell.forbidden_modules()


def test_new_mix_and_metric_by_files_alone(tmp_path):
    """A later change adds a traffic mix, a metric and a cell by adding
    files and entries: in a copy of the benchmark, a throwaway mix (three
    distances) and metric (the median request) run with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(files.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = json.loads((files.ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark/traffic/slider3.json").write_text(json.dumps({
        "request": "segment", "distances": [0.6, 0.75, 0.9], "sample": 2,
        "limits": {"ids_apart_ppm": 100, "classes_apart_ppm": 100,
                   "table_apart_ppm": 100}}))
    (root / "benchmark/metrics/p50_ms.py").write_text(
        "def read(run):\n"
        "    lat = sorted(run.latencies_s)\n"
        "    return 1e3 * lat[len(lat) // 2] if lat else None\n")
    spec["workloads"].append({"name": "grid15m-slider3", "config": "grid15m",
                              "traffic": "slider3", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "p50_ms", "unit": "ms",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["grid15m-slider3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from harness import tiny\n"
            "rc, out, err = tiny.run('grid15m-slider3', 4)\n"
            "assert rc == 0, err\n"
            "print(out[-1])\n" % (str(root / "benchmark"), str(files.ROOT)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"p50_ms", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("kind,params", [
    ("segment", "slider"), ("render", "orbit")])
def test_traffic_is_fixed_by_the_seed(kind, params):
    import numpy as np
    from harness import tiny
    mod = files.load_module("requests", kind)
    p = {**files.load_json("traffic", params), **tiny.TRAFFIC.get(kind, {})}
    scene_mod = files.load_module("scenes", "synthetic_forest")
    pts = scene_mod.generate(tiny.SCENES["synthetic_forest"], 3)
    conf = json.loads((files.ROOT / SPEC["configs"][0]["file"]).read_text())
    sections = {"render": {**conf["config"]["render"], **tiny.RENDER}}

    def trace(seed):
        t = mod.Traffic(p, seed, pts, scene_mod, sections)
        if kind == "segment":
            return [t.distance(i) for i in range(30)]
        return [t.pose(i) for i in range(30)]
    assert trace(2**33 + 1) == trace(2**33 + 1)
    assert trace(2**33 + 1) != trace(2**33 + 2)
    if kind == "segment":
        # every seed sends the same set of distances, in its own order
        assert sorted(trace(1)[:11]) == sorted(trace(2)[:11]) == sorted(
            np.asarray(p["distances"]).tolist())
