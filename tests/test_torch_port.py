"""The port's host-level pieces against the JAX package: the no-JAX import
rule, the copied configuration and synthetic scenes, Morton keys and
``build_keys`` bit for bit, and the state carried between the two packages
(``PointCloud`` and ``SegmentTable`` to and from numpy)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import cloud as jcloud
from treee_tpu import config as jconfig
from treee_tpu.io import las as jlas
from treee_tpu.ops import morton as jmorton
from treee_tpu.ops import octree as joctree
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import cloud as tcloud
from treee_tpu_torch import config as tconfig
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import morton as tmorton
from treee_tpu_torch.ops import octree as toctree

import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
before = set(sys.modules)
import treee_tpu_torch
for m in pkgutil.walk_packages(treee_tpu_torch.__path__, "treee_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "flax", "treee_tpu"))
print(" ".join(sorted(m for m in new if m.startswith("treee_tpu_torch"))))
print(bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    """The card's machine has no JAX: importing every module of the port,
    and chip_smoke.py, must not load jax, flax or the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods, bad = out.stdout.splitlines()
    mods = set(mods.split())
    assert len(mods) >= 54
    # the interactive and focused views', the rasters', ingest's, the
    # front ends' and the tiles' and shards' modules among them
    assert {"treee_tpu_torch.interactive", "treee_tpu_torch.ops.octree",
            "treee_tpu_torch.ops.morton", "treee_tpu_torch.cloud",
            "treee_tpu_torch.characteristics",
            "treee_tpu_torch.pipeline", "treee_tpu_torch.ops.eigen",
            "treee_tpu_torch.ops.neighbors", "treee_tpu_torch.hull3d",
            "treee_tpu_torch.geo", "treee_tpu_torch.rasters",
            "treee_tpu_torch.change", "treee_tpu_torch.io.exports",
            "treee_tpu_torch.io.las", "treee_tpu_torch.io.laz_native",
            "treee_tpu_torch.io.native_build", "treee_tpu_torch.io.ipc",
            "treee_tpu_torch.utils.errors", "treee_tpu_torch.input",
            "treee_tpu_torch.repl", "treee_tpu_torch.serve",
            "treee_tpu_torch.app", "treee_tpu_torch.__main__",
            "treee_tpu_torch.utils.profiling", "treee_tpu_torch.parallel",
            "treee_tpu_torch.parallel.tiles",
            "treee_tpu_torch.parallel.sharding",
            "treee_tpu_torch.parallel.program",
            "treee_tpu_torch.tools.bench_tiled",
            "treee_tpu_torch.tools.survey_trees"} <= mods
    assert bad.strip() == "[]"


# JAX-package fields the port leaves out: TPU/XLA implementation switches
# and bounds that the port's single algorithm does not read
DROPPED = {
    "SegmentationConfig": {
        "use_pallas", "use_pallas_cc", "use_pallas_match",
        "use_sorted_extract", "cc_iters", "cc_pallas_bodies"},
    "CharacteristicsConfig": {
        "use_pallas_scan", "pallas_scan_block", "score_chunk"},
    "RenderConfig": {"use_pallas", "raster_tile"},
}
RENAMED = {"cc_sweeps": "cc_pallas_sweeps"}


@pytest.mark.parametrize("cls", ["SegmentationConfig", "CharacteristicsConfig",
                                 "RenderConfig", "NeighborConfig",
                                 "InteractiveConfig"])
def test_config_defaults_match_jax(cls):
    port = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))}
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}
    for name, default in port.items():
        assert default == ref[RENAMED.get(name, name)], name
    kept = {RENAMED.get(n, n) for n in port}
    assert set(ref) - kept == DROPPED.get(cls, set())
    assert not hasattr(tconfig, "resolve_use_pallas")


def test_config_has_the_jax_fields_in_order():
    """``Config`` takes the JAX package's sections, in its order and with
    its defaults, so that ``Config(neighbors=...)`` works in both."""
    port = [f.name for f in dataclasses.fields(tconfig.Config)]
    assert port == [f.name for f in dataclasses.fields(jconfig.Config)]
    cfg = tconfig.Config()
    for name in port:
        got, ref = getattr(cfg, name), getattr(jconfig.Config(), name)
        assert type(got).__name__ == type(ref).__name__
        if name in ("neighbors", "interactive"):
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    cfg = tconfig.Config(neighbors=tconfig.NeighborConfig(k=8))
    assert cfg.neighbors.k == 8 and cfg.replace(
        interactive=tconfig.InteractiveConfig(draw_radius=1.0)
    ).interactive.draw_radius == 1.0


def _device_defaults():
    """Every entry point that places tensors, with its device default: the
    named ones, and every function of the focused view's modules whose
    ``device`` has a default (the others run on their inputs' device)."""
    import inspect

    from treee_tpu_torch import geo as tgeo
    from treee_tpu_torch import hull3d as thull
    from treee_tpu_torch import pipeline as tpl
    from treee_tpu_torch.ops import eigen as teig
    from treee_tpu_torch.ops import neighbors as tnb
    from treee_tpu_torch.render import Camera
    from treee_tpu_torch.render import palettes as tpal

    def takes_device(f):
        p = inspect.signature(f).parameters.get("device")
        return p is not None and p.default is not p.empty

    scanned = {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": f
               for m in (teig, tnb, thull, tgeo)
               for n, f in vars(m).items()
               if inspect.isfunction(f) and f.__module__ == m.__name__
               and takes_device(f)}
    assert "hull3d.convex_hull" in scanned
    fns = {**scanned,
           "Session": tpl.Session.__init__,
           "Session.from_points": tpl.Session.from_points,
           "Session.from_las": tpl.Session.from_las,
           "Session.open": tpl.Session.open,
           "PointCloud.from_numpy": tcloud.PointCloud.from_numpy,
           "PointCloud.empty": tcloud.PointCloud.empty,
           "SegmentTable.from_numpy": tch.SegmentTable.from_numpy,
           "Camera.orbital": Camera.orbital,
           "Camera.from_numpy": Camera.from_numpy,
           **{f"palettes.{n}": getattr(tpal, n)
              for n in ("get", "turbo", "warm", "white", "rgb_cube")}}
    return {name: inspect.signature(fn).parameters["device"].default
            for name, fn in fns.items()}


def test_entry_points_default_to_the_card(tmp_path):
    """The port runs on the card unless asked for the CPU: every entry
    point defaults to CUDA, and without a card it raises instead of running
    on the CPU.  The CLI (``python -m treee_tpu_torch``) too: without
    ``--cpu`` it runs on the card or raises."""
    from treee_tpu_torch import app as tapp
    from treee_tpu_torch import device as tdevice
    from treee_tpu_torch import pipeline as tpl
    from treee_tpu_torch.render import Camera
    from treee_tpu_torch.render import palettes as tpal

    assert tdevice.DEFAULT_DEVICE == "cuda"
    assert set(_device_defaults().values()) == {"cuda"}
    pts = np.zeros((5, 3), np.float32)
    if torch.cuda.is_available():
        assert tpl.Session().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpl.Session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpl.Session.from_points(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(["--demo"])
    proc = subprocess.run([sys.executable, "-m", "treee_tpu_torch", "--demo"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert "segments:" not in proc.stdout
    scan, ckpt = str(tmp_path / "s.las"), str(tmp_path / "s.npz")
    tlas.write_las(scan, pts)
    tpl.Session.from_points(pts, device="cpu").save(ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpl.Session.from_las(scan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpl.Session.open(ckpt)
    assert tpl.Session.from_las(scan, device="cpu").cloud.count == 5
    assert tpl.Session.open(ckpt, device="cpu").cloud.count == 5
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcloud.PointCloud.from_numpy(pts)
    with pytest.raises((RuntimeError, AssertionError)):
        Camera.orbital()
    with pytest.raises((RuntimeError, AssertionError)):
        tpal.get("turbo")
    s = tpl.Session.from_points(pts, device="cpu")
    assert s.device.type == "cpu" and s.cloud.pos.device.type == "cpu"
    assert s.camera.device.type == "cpu" and s.palette.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(n_trees=5, points_per_tree=300, ground_points=500, seed=2),
    dict(n_trees=3, spacing=7.0, points_per_tree=1000, ground_points=77,
         seed=0, jitter=0.5),
])
def test_synthetic_forest_is_byte_equal(kw):
    got, ref = tlas.synthetic_forest(**kw), jlas.synthetic_forest(**kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    base = np.array([1.5, 0.25, -3.0])
    t_got = tlas.synthetic_tree(np.random.default_rng(7), base, n_points=101)
    t_ref = jlas.synthetic_tree(np.random.default_rng(7), base, n_points=101)
    assert t_got.tobytes() == t_ref.tobytes()


def _cloud(n, cap, seed):
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = rng.uniform(-40, 25, (n, 3)).astype(np.float32)
    pos[:n:7, 1] = 25.0  # points on the upper bound
    valid = np.arange(cap) < n
    return pos, valid


def test_morton_encode_is_bit_exact():
    pos, _ = _cloud(5000, 5000, seed=1)
    lo, hi = pos.min(0), pos.max(0)
    ref = np.asarray(jmorton.encode_positions(jnp.asarray(pos), jnp.asarray(lo),
                                              jnp.asarray(hi)))
    got = tmorton.encode_positions(torch.from_numpy(pos), torch.from_numpy(lo),
                                   torch.from_numpy(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # every corner of the 1024^3 grid interleaves like the JAX package's
    cells = np.array([[0, 0, 0], [1023, 0, 0], [0, 1023, 0], [0, 0, 1023],
                      [1023, 1023, 1023], [512, 341, 682]], np.int32)
    ref = np.asarray(jmorton.encode(jnp.asarray(cells.astype(np.uint32))))
    np.testing.assert_array_equal(tmorton.encode(torch.from_numpy(cells)).numpy(),
                                  ref)


@pytest.mark.parametrize("n,cap", [(3000, 4096), (0, 1024), (1, 1024),
                                   (2048, 2048)])
def test_build_keys_is_bit_exact(n, cap):
    pos, valid = _cloud(n, cap, seed=n)
    ref = np.asarray(joctree.build_keys(jnp.asarray(pos), jnp.asarray(valid)))
    got = toctree.build_keys(torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int((got == toctree.INVALID_KEY).sum()) >= cap - n


def test_point_cloud_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(1500, 3)).astype(np.float32)
    seg = rng.integers(0, 9, 1500).astype(np.int32)
    ref = jcloud.PointCloud.from_numpy(pts, segment=seg)
    got = tcloud.PointCloud.from_numpy(pts, segment=seg, device="cpu")
    assert got.capacity == ref.capacity == 2048
    for f in ("pos", "segment", "classification", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert got.count == 1500 and type(got.count) is int
    assert got.count == int(ref.count) == int(got.valid.sum())
    back = got.to_numpy()
    np.testing.assert_array_equal(back["pos"], pts)
    np.testing.assert_array_equal(back["segment"], seg)
    with pytest.raises(ValueError):
        tcloud.PointCloud.from_numpy(pts, capacity=1024, device="cpu")
    assert (tcloud.CLASS_GROUND, tcloud.CLASS_TRUNK, tcloud.CLASS_CROWN,
            tcloud.DELETED_SEGMENT) == (jcloud.CLASS_GROUND, jcloud.CLASS_TRUNK,
                                        jcloud.CLASS_CROWN,
                                        jcloud.DELETED_SEGMENT)


def test_segment_table_round_trip():
    rng = np.random.default_rng(4)
    s, ms = 9, 16
    arrays = {
        "present": rng.random(s) < 0.5,
        "count": rng.integers(0, 99, s).astype(np.int32),
        "lo": rng.normal(size=(s, 3)).astype(np.float32),
        "hi": rng.normal(size=(s, 3)).astype(np.float32),
        "areas": rng.random((s, ms)).astype(np.float32),
        "n_slices": rng.integers(1, ms, s).astype(np.int32),
        **{f: rng.normal(size=s).astype(np.float32)
           for f in ("ground_sep", "crown_sep", "trunk_height", "crown_height")},
    }
    table = tch.SegmentTable.from_numpy(arrays, device="cpu")
    assert table.areas.dtype == torch.float32 and table.present.dtype == torch.bool
    back = table.to_numpy()
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("k", [8, 12, 16])
def test_support_directions_match_jax(k):
    """The slice hulls' directions equal XLA's f32 cos/sin bit for bit."""
    from treee_tpu import characteristics as jch

    np.testing.assert_array_equal(tch._support_directions(k, "cpu").numpy(),
                                  np.asarray(jch._support_directions(k)))


def test_exports_copy_is_byte_equal():
    """The port's io/exports.py is the JAX package's (numpy only), byte for
    byte, but for one addition: the PNG encoder, which the JAX package keeps
    in serve.py, appended whole, and the two stdlib imports it needs
    (tests/test_torch_serve.py holds its output to the JAX encoder's)."""
    import inspect

    from treee_tpu_torch.io import exports

    with open(os.path.join(REPO, "treee_tpu", "io", "exports.py"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "treee_tpu_torch", "io", "exports.py"),
              "rb") as f:
        port = f.read()
    encoder = ("\n\n" + inspect.getsource(exports.png_encode)).encode()
    assert port.endswith(encoder)
    imports = b"import json\nimport struct\nimport zlib\n"
    assert port.count(imports) == 1
    assert port[:-len(encoder)].replace(imports, b"import json\n") == ref


def test_change_copy_matches_jax():
    """The port's change.py holds the JAX package's host functions: each one
    that reads no session has the same source, and the constants agree;
    ``_map_bounds`` and ``chm_change`` read the port's sessions and are
    held against the JAX package by tests/test_torch_rasters.py."""
    import inspect

    from treee_tpu import change as jchange
    from treee_tpu import rasters as jrasters
    from treee_tpu_torch import change as tchange
    from treee_tpu_torch import rasters as trasters

    for name in ("_positions", "match_trees", "_subset", "_tree_rows",
                 "tree_changes", "stand_changes"):
        assert (inspect.getsource(getattr(tchange, name))
                == inspect.getsource(getattr(jchange, name))), name
    # chm_change is the same source but for its one raster call, which
    # asks the session for its rasters (one device or a mesh)
    ref = inspect.getsource(jchange.chm_change).replace(
        "    from . import rasters as rs\n\n", "").replace(
        """rs.compute_rasters(
            s.cloud.pos, s.cloud.classification, s.cloud.alive,
            lo, hi, cell, cap=cap,
        )""", "s._raster_grids(lo, hi, cell, cap=cap)")
    assert inspect.getsource(tchange.chm_change) == ref
    assert tchange.DELTA_TRAITS == jchange.DELTA_TRAITS
    assert tchange.NODATA == jchange.NODATA == trasters.NODATA == jrasters.NODATA
    assert inspect.getsource(trasters.grid_dims) == inspect.getsource(
        jrasters.grid_dims)


# ---- the package's layering -------------------------------------------------

PACKAGE = os.path.join(REPO, "treee_tpu_torch")


def _modules() -> dict[str, str]:
    """Every module of the port by dotted name (a package by its own name)
    -> its file."""
    mods = {}
    for d, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                parts = os.path.relpath(path, REPO)[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                mods[".".join(parts)] = path
    return mods


def _import_graph() -> dict[str, set[str]]:
    """Module -> the port's modules it imports, function-level imports
    included.  ``from X import n`` points at the submodule X.n where there
    is one, else at X; a parent package's ``__init__`` is not counted, as
    Python runs it before any of its submodules."""
    import ast

    mods = _modules()
    graph = {m: set() for m in mods}
    for m, path in mods.items():
        here = m.split(".")
        if not path.endswith("__init__.py"):
            here = here[:-1]
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                graph[m] |= {a.name for a in node.names if a.name in mods}
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = here[:len(here) - node.level + 1]
                    src = ".".join(base + [node.module] if node.module
                                   else base)
                else:
                    src = node.module
                if src not in mods:
                    continue
                for a in node.names:
                    sub = f"{src}.{a.name}"
                    graph[m].add(sub if sub in mods else src)
    return graph


def _cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """The strongly connected components of more than one module, or of one
    that imports itself (Tarjan's algorithm, iterative)."""
    index, low, stack, on, out = {}, {}, [], set(), []
    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = len(index)
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            w = next(it, None)
            if w is not None:
                if w not in index:
                    index[w] = low[w] = len(index)
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                elif w in on:
                    low[v] = min(low[v], index[w])
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in graph[v]:
                    out.append(sorted(comp))
    return out


def test_package_imports_form_no_cycle():
    """The port's imports point one way: no module reaches itself through
    the modules it imports, counting imports inside functions too."""
    graph = _import_graph()
    assert len(graph) >= 55
    # the graph sees imports at module level and inside functions
    assert ("treee_tpu_torch.pipeline"
            in graph["treee_tpu_torch.parallel.tiles"])
    assert "treee_tpu_torch.serve" in graph["treee_tpu_torch.app"]
    assert _cycles(graph) == []
    assert _cycles({"a": {"b"}, "b": {"c"}, "c": {"a"}, "d": {"a"}}) == [
        ["a", "b", "c"]]


def test_float_rules_are_defined_only_in_f32():
    """``full``, ``div``, ``sum3``, ``order``, ``unorder`` and ``NAN_ORDER``
    have one definition in the port, in ops/f32.py."""
    import ast

    names = {"full", "div", "sum3", "order", "unorder", "NAN_ORDER"}
    found = {}
    for m, path in _modules().items():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in names:
                found.setdefault(node.name, []).append(m)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "NAN_ORDER":
                        found.setdefault(t.id, []).append(m)
    assert found == {n: ["treee_tpu_torch.ops.f32"] for n in names}


@pytest.mark.parametrize("value", [
    # scene coordinates: a bound's x or z, as numpy f32 and f64 scalars
    np.float32(-123.456789), np.float32(4321.0625), np.float64(-0.3),
    np.float32(0.1), np.float64(65432.1234567), -0.0, 0.0, 1e-40,
    # 1 / cell for cells 0.1 to 1.0, and a cell grown past the cap
    1.0 / 0.1, 1.0 / 0.2, 1.0 / 0.25, 1.0 / 0.3, 1.0 / 0.5, 1.0 / 0.75,
    1.0 / 1.0, 1.0 / 3.0, 1.0 / 0.1234567,
    # a y offset
    -12.345, 387.25,
])
def test_full_is_the_f32_rounding_of_a_python_number(value):
    """``f32.full(v, like)`` holds the bits of ``np.float32(v)`` on
    ``like``'s device, for the kinds of value the rasters and tiles pass."""
    from treee_tpu_torch.ops.f32 import full

    like = torch.zeros(3, dtype=torch.int32)
    got = full(value, like)
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.device == like.device
    assert got.view(torch.int32).item() == int(
        np.float32(value).view(np.int32))
