"""The port's ``Session`` over a mesh (its mesh mode) on CPU devices, against
the port's one-device session on the same rows and against the JAX
package's mesh session on the conftest's 8 CPU devices.

Row order is the parity hinge.  A mesh session orders its rows by Morton key
at ingest and rounds its capacity to blocks of 1024 x D, so the one-device
reference is fed the mesh session's rows (``cloud.to_numpy()``) at its
capacity, as tests/test_sharding.py:576-586 builds it.

Tolerances, and why:

- against the port's one-device session (D = 8): ids, classes, every table
  column, LOD indices and positions, picks, rasters, the height above
  ground, curvature, normals, properties, the files the exports write and
  every frame bit or byte for byte (every cross-shard value there is an
  integer sum, an f32 min or max, a gather of a count or a key, or a copy
  of rows); the inventory's integer columns, ``axis_found`` and the columns
  of the table exact, its traits and stem positions within JAX's own mesh
  tolerances (tests/test_sharding.py:537-547, 669-672: rtol 1e-4, atol
  1e-5), since the axes' band and layer sums and the mean grids add each
  shard's own sums in shard order, and the summary, which sums them, rtol
  1e-4;
- against JAX's mesh session (``cc_iters=4096``: jitted JAX on the CPU
  stops connected components early, tests/test_torch_sharding.py): the same
  Morton row order, ids, classes, LOD indices, pick (distance rtol 1e-6),
  rasters and the inventory's segment and point counts exactly, DBH within
  the tolerance above, frames at >= 0.98 of pixels, JAX's own bound for its
  mesh frames (its jitted frame contracts ``p22 * vz + p23`` into an FMA,
  tests/test_torch_render.py).
"""

import copy
import io
import json
import re
import urllib.request

import numpy as np
import pytest
import torch

from treee_tpu.config import CharacteristicsConfig as JCC
from treee_tpu.config import Config as JConfig
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.parallel import sharding as jsh
from treee_tpu import pipeline as jpl
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch.config import CharacteristicsConfig as TCC
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.parallel import sharding as tsh
from treee_tpu_torch.render import Camera

import torch_threads

torch_threads.share_cores()

SEG = dict(grid_size=128, max_bands=16, max_segments=128,
           max_trees_per_band=32)
FRAME = dict(width=128, height=96)
TCFG = TConfig(segmentation=TSC(**SEG), characteristics=TCC(max_slices=96),
               render=TRC(**FRAME))
JCFG = JConfig(segmentation=JSC(**SEG, cc_iters=4096),
               characteristics=JCC(max_slices=96), render=JRC(**FRAME))
D = 8
RTOL, ATOL = 1e-4, 1e-5
MIN_JAX_PIXELS = 0.98
EDIT_RADIUS = 2.0


def _forest():
    # tests/test_sharding.py:568's scene
    return tlas.synthetic_forest(n_trees=4, points_per_tree=3000,
                                 ground_points=3000, seed=11)


def _one_device_twin(sm, config=TCFG):
    """The one-device session on the mesh session's rows and capacity."""
    host = sm.cloud.to_numpy()
    s1 = tpl.Session.from_points(host["pos"], config, device="cpu",
                                 capacity=sm.cloud.capacity)
    s1.world_offset = sm.world_offset.copy()
    return s1


@pytest.fixture(scope="module")
def base():
    """A mesh session of 8 CPU shards and its one-device twin, segmented."""
    sm = tpl.Session.from_points(_forest(), TCFG,
                                 mesh=tsh.make_mesh(["cpu"] * D))
    s1 = _one_device_twin(sm)
    sm.segment(0.75)
    s1.segment(0.75)
    counts = np.where(s1.table.present.numpy(), s1.table.count.numpy(), 0)
    order = np.argsort(-counts[1:], kind="stable") + 1
    return dict(sm=sm, s1=s1, big=int(order[0]), pair=(int(order[1]),
                                                       int(order[2])),
                centre=sm.cloud.to_numpy()["pos"].mean(0))


@pytest.fixture
def pair(base):
    return copy.deepcopy(base["sm"]), copy.deepcopy(base["s1"])


def _np(x):
    """A result as numpy: the shards of a per-point value gathered, floats
    by their bits."""
    if isinstance(x, list):
        x = tsh.gather(x)
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _state(s) -> dict:
    """Ids, classes and every table column."""
    cloud = s.cloud.gather() if s.mesh is not None else s.cloud
    out = {"segment": _np(cloud.segment),
           "classification": _np(cloud.classification)}
    if s.table is not None:
        for k, v in vars(s.table).items():
            out[f"table.{k}"] = _np(v)
    return out


def _same(got: dict, ref: dict, close=()):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in close:
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            g, r = got[k], ref[k]
            if isinstance(r, (bytes, str, int, float, bool, tuple,
                              type(None))):
                assert g == r, k
            else:
                np.testing.assert_array_equal(_np(g), _np(r), err_msg=k)


# ---- the user surface: one case per public method of Session ---------------

def _cam(s, distance=60.0):
    return Camera.orbital(distance=distance, device=s.device)


def case_preview_frame(s, ctx):
    return {"frame": s.preview_frame(), "far": s.preview_frame(_cam(s, 120))}


def case_segment(s, ctx):
    frames = []
    res = s.segment(0.5, preview_cb=frames.append, preview_stride=16)
    out = _state(s)
    out.update(n=int(res.n_segments), preview=frames[0],
               overflow=bool(res.occupied_overflow),
               tracked=_np(res.tracked_pos))
    return out


def case_characteristics(s, ctx):
    s.delete_sphere(ctx["centre"], EDIT_RADIUS)
    s.characteristics()
    return _state(s)


def case_full_table(s, ctx):
    s.combine(*ctx["pair"])
    t = s.full_table()
    return {k: _np(v) for k, v in vars(t).items()}


def case_properties(s, ctx):
    exp, hgt = s.properties()
    return {"expansion": exp, "height": hgt}


def case_curvature(s, ctx):
    return {"curve": s.curvature(ctx["big"]),
            "cached": s.curvature(ctx["big"])}


def case_normals(s, ctx):
    return {"normals": s.normals(ctx["big"])}


def case_segment_coords(s, ctx):
    s.source_location = "+proj=utm +zone=33 +north"
    return {"coords": s.segment_coords(ctx["big"])}


def case_segment_rows(s, ctx):
    pos, cls_, member = s.segment_rows(ctx["big"])
    return {"pos": pos, "classification": cls_, "member": member}


def case_build_lod(s, ctx):
    out = {}
    s.build_lod(level=6)
    tree = s._tree
    s.delete_sphere(ctx["centre"], EDIT_RADIUS)
    for name, kw in (("level6", dict(level=6)),
                     ("level9x2", dict(level=9, points_per_node=2)),
                     ("frustum", dict(level=8, camera=_cam(s, 40))),
                     ("adaptive", dict(camera=_cam(s, 40),
                                       adaptive_tau_px=2.0)),
                     ("capacity", dict(level=5, capacity=4096))):
        s.build_lod(**kw)
        pos_c, idx, count = s._lod
        out.update({f"{name}.idx": idx, f"{name}.pos": pos_c,
                    f"{name}.count": count,
                    f"{name}.frame": s.render(use_lod=True)})
    out["tree_kept"] = s._tree is tree
    return out


def case_solve_adaptive_tau(s, ctx):
    cam = _cam(s, 50)
    budgets = (500, 3000, 100000)
    return {"budget": tuple(s.solve_adaptive_tau(budget_rows=b, camera=cam)
                            for b in budgets),
            "match": s.solve_adaptive_tau(match_floor=0.9, camera=cam)}


def case_render(s, ctx):
    out = {"frame": s.render(), "near": s.render(_cam(s, 40))}
    s.delete_sphere(ctx["centre"], EDIT_RADIUS)
    out["deleted"] = s.render()
    out["show_deleted"] = s.render(show_deleted=True)
    out["lod"] = s.render(use_lod=True)
    out["hag"] = s.render(prop=s.hag_prop())
    ramp = torch.linspace(0.0, 1.0, s.cloud.capacity)
    out["ramp"] = s.render(prop=ramp, palette=s.palette)
    out["ramp_lod"] = s.render(prop=ramp, use_lod=True)
    return out


def case_render_focus(s, ctx):
    out = {}
    cam = _cam(s, 30)
    for display in tpl.FOCUS_DISPLAYS:
        out[display] = s.render_focus(ctx["big"], cam, display=display)
    out["overlays"] = s.render_focus(ctx["big"], cam, show_hull=True,
                                     show_rbv=True, show_axis=True)
    out["lowhigh_mean"] = s.render_focus(
        ctx["big"], cam, show_rbv=True, show_axis=True, rbv_method="mean",
        rbv_symmetric=True, axis_algo="lowhigh", rbv_slices=6, rbv_sectors=8)
    return out


def case_delete_sphere(s, ctx):
    s.delete_sphere(ctx["centre"], EDIT_RADIUS)
    return _state(s)


def case_draw_sphere(s, ctx):
    s.delete_sphere(ctx["centre"], EDIT_RADIUS)
    s.draw_sphere(ctx["centre"] + [1.0, 0.0, 0.0], ctx["big"], EDIT_RADIUS,
                  include_deleted=True)
    s.full_table()
    return _state(s)


def case_reclassify_sphere(s, ctx):
    s.reclassify_sphere(ctx["centre"] + [0.0, 3.0, 0.0], 2, ctx["big"],
                        3 * EDIT_RADIUS)
    return _state(s)


def case_update_separators_from_classes(s, ctx):
    s.characteristics()
    s.update_separators_from_classes(ctx["big"])
    return _state(s)


def case_combine(s, ctx):
    s.combine(*ctx["pair"])
    return _state(s)


def case_spawn(s, ctx):
    nid = s.spawn(ctx["centre"], EDIT_RADIUS)
    out = _state(s)
    out["nid"] = nid
    out["next"] = s.spawn(ctx["centre"] + [0.0, 5.0, 0.0], EDIT_RADIUS)
    return out


def case_pick(s, ctx):
    out = {}
    for x, y in ((64, 48), (30, 40), (100, 70), (0, 0)):
        out[f"{x},{y}"] = s.pick(x, y)
    s.delete_sphere(ctx["centre"], 3 * EDIT_RADIUS)
    out["deleted"] = s.pick(64, 48)
    out["include_deleted"] = s.pick(64, 48, include_deleted=True)
    return out


def case_export_points_ply(s, ctx):
    d = ctx["dir"]
    n_tree = s.export_points_ply(d / "tree.ply", segment_id=ctx["big"],
                                 include="crown")
    n_all = s.export_points_ply(d / "all.ply")
    return {"n": (n_tree, n_all), "tree": (d / "tree.ply").read_bytes(),
            "all": (d / "all.ply").read_bytes()}


def case_export_las(s, ctx):
    d = ctx["dir"]
    n = s.export_las(str(d / "all.las"))
    m = s.export_las(str(d / "tree.las"), segment_id=ctx["big"],
                     include="trunk")
    return {"n": (n, m), "all": (d / "all.las").read_bytes(),
            "tree": (d / "tree.las").read_bytes()}


TRAIT_COLS = ("stem_easting", "stem_northing", "diameter_breast_height",
              "trunk_cross_area", "crown_diameter", "crown_projected_area",
              "crown_volume", "crown_surface", "stem_volume", "wood_volume")


def case_inventory(s, ctx):
    out = {}
    for tag, kw in (("max", {}),
                    ("mean", dict(method="mean", symmetric=True,
                                  axis_algo="lowhigh", crown_slices=12,
                                  trunk_sectors=16))):
        for k, v in s.inventory(**kw).items():
            out[f"{tag}.{k}"] = v
    return out


def case_forest_summary(s, ctx):
    return {k: float(v) for k, v in s.forest_summary(chm_cell=1.0).items()}


def case_rasters(s, ctx):
    grids, corner, cell = s.rasters(1.0, cap=256)
    out = {f"grid.{k}": v for k, v in grids.items()}
    out["corner"], out["cell"] = corner, cell
    return out


def case_height_above_ground(s, ctx):
    return {"hag": s.height_above_ground(2.0)}


def case_hag_prop(s, ctx):
    return {"hag": s.hag_prop(), "cached": s.hag_prop()}


def case_export_raster(s, ctx):
    d = ctx["dir"]
    shape = s.export_raster(d / "chm.asc", "chm", cell=1.0, cap=256)
    return {"shape": tuple(shape), "asc": (d / "chm.asc").read_bytes()}


def case_save(s, ctx):
    d = ctx["dir"]
    s.save(d / "all.npz")
    s.save(d / "tree.ipc", segment_id=ctx["big"])
    with np.load(d / "all.npz") as z:
        out = {f"npz.{k}": z[k] for k in z.files}
    out["ipc"] = (d / "tree.ipc").read_bytes()
    return out


def case_open(s, ctx):
    d = ctx["dir"]
    s.save(d / "all.npz")
    o = tpl.Session.open(str(d / "all.npz"), TCFG, device="cpu",
                         mesh=s.mesh)
    o.segment(0.75)
    out = {f"table.{k}": _np(v) for k, v in vars(o.table).items()}
    out.update(o.cloud.to_numpy())   # the one device pads to less
    return out


def case_add_session(s, ctx):
    d = ctx["dir"]
    s.save(d / "tree.ipc", segment_id=ctx["big"])
    s.add_session(str(d / "tree.ipc"))
    out = {k: np.sort(v) for k, v in s.cloud.to_numpy().items()
           if k != "pos"}
    out["n"] = s.cloud.count
    out["nid"] = s.spawn(ctx["centre"], EDIT_RADIUS)
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}
# float columns that add per-shard sums (module docstring)
CLOSE = {"inventory": {f"{t}.{c}" for t in ("max", "mean")
                       for c in TRAIT_COLS},
         "forest_summary": None}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_session_method_equals_one_device(pair, base, tmp_path, name):
    sm, s1 = pair
    outs = []
    for s, sub in ((sm, "mesh"), (s1, "one")):
        d = tmp_path / sub
        d.mkdir()
        ctx = dict(base, dir=d)
        outs.append(CASES[name](s, ctx))
    got, ref = outs
    if name == "forest_summary":
        assert sorted(got) == sorted(ref)
        np.testing.assert_allclose([got[k] for k in sorted(ref)],
                                   [ref[k] for k in sorted(ref)], rtol=RTOL)
        return
    if name == "build_lod":
        assert got["tree_kept"] is True
    _same(got, ref, close=CLOSE.get(name) or ())


def test_cases_cover_every_public_method():
    """Each public method of the port's Session has its case above, or is a
    constructor that the cases and the LAS test below drive."""
    public = {n for n in dir(tpl.Session) if not n.startswith("_")
              and callable(getattr(tpl.Session, n))}
    covered = set(CASES) | {"from_points", "from_las", "add_las",
                            "attribute_prop"}
    assert public <= covered, sorted(public - covered)


def test_mesh_session_las_ingest_and_attributes(tmp_path):
    """from_las over a mesh: the rows in Morton order of the one-device
    session's, the attributes following them; add_las, the attribute
    properties and their frames as the one-device twin's."""
    pts = tlas.synthetic_forest(n_trees=3, points_per_tree=1500,
                                ground_points=1500, seed=5)
    rng = np.random.default_rng(60)
    n = len(pts)
    rec = np.zeros((n, tlas.POINT_LENGTHS[7]), np.uint8)
    inten = rng.integers(0, 1 << 16, n, dtype=np.uint16)
    rec[:, 12:14] = inten.astype("<u2").view(np.uint8).reshape(n, 2)
    t = rng.uniform(3.0e8, 3.0e8 + 2000.0, n)
    rec[:, 22:30] = t.astype("<f8").view(np.uint8).reshape(n, 8)
    rgb = rng.integers(0, 1 << 16, (n, 3), dtype=np.uint16)
    rec[:, 30:36] = rgb.astype("<u2").view(np.uint8).reshape(n, 6)
    src = str(tmp_path / "forest.las")
    tlas.write_las(src, pts, point_format=7, records=rec,
                   las_offset=np.array([700000.0, 6600000.0, 0.0]))
    extra = str(tmp_path / "extra.las")
    tlas.write_las(extra, (rng.uniform(-3, 3, (700, 3)) + [20.0, 1.5, 20.0])
                   .astype(np.float32), las_offset=np.zeros(3))

    frames = []
    sm = tpl.Session.from_las(src, TCFG, mesh=tsh.make_mesh(["cpu"] * 4),
                              preview_cb=frames.append, slab_points=1000)
    one = tpl.Session.from_las(src, TCFG, device="cpu")
    assert frames and sm.cloud.count == one.cloud.count == n
    order = tsh.morton_order(one.cloud.pos[:n],
                             torch.ones(n, dtype=torch.bool)).numpy()
    host = sm.cloud.to_numpy()
    np.testing.assert_array_equal(host["pos"], one.cloud.pos[:n].numpy()[order])
    for k, v in one.attributes.items():
        np.testing.assert_array_equal(sm.attributes[k][:n], v[:n][order],
                                      err_msg=k)
    s1 = _one_device_twin(sm)
    s1.attributes = copy.deepcopy(sm.attributes)
    for name in ("intensity", "rgb", "gps_time"):
        pm, pal_m = sm.attribute_prop(name)
        p1, pal_1 = s1.attribute_prop(name)
        assert isinstance(pm, list) and len(pm) == 4
        np.testing.assert_array_equal(_np(pm), _np(p1), err_msg=name)
        np.testing.assert_array_equal(
            sm.render(prop=pm, palette=pal_m),
            s1.render(prop=p1, palette=pal_1), err_msg=name)
    # add_las: one new segment; the mesh orders the merged rows anew, so
    # the two hold the same rows in another order
    for s in (sm, s1):
        s.segment(0.75)
        s.add_las(extra)
        assert s.table is None and s.cloud.count == n + 700
    rows = []
    for s in (sm, s1):
        h = s.cloud.to_numpy()
        at = np.lexsort(h["pos"].T[::-1])
        rows.append({k: v[at] for k, v in h.items()})
        rows[-1]["intensity"] = s.attributes["intensity"][:n + 700][at]
    _same(rows[0], rows[1])
    merged = s1.cloud.pos[:n + 700]
    order = tsh.morton_order(merged, torch.ones(n + 700, dtype=torch.bool))
    np.testing.assert_array_equal(sm.cloud.to_numpy()["pos"],
                                  merged.numpy()[order.numpy()])


# ---- the mesh form of each function, over 1, 2 and 8 shards ---------------
# (tests/test_torch_sharding.py holds the shard programs at the function
# level; here the session's own routes)

def test_session_mesh_argument_forms():
    """``mesh="auto"`` on the CPU is one device, as ``--mesh auto`` is; a
    mesh puts the camera and palette on its first device; one shard equals
    one device."""
    s = tpl.Session(TCFG, device="cpu", mesh="auto")
    assert s.mesh is None and s.device == torch.device("cpu")
    mesh = tsh.make_mesh(["cpu"])
    sm = tpl.Session.from_points(_forest(), TCFG, mesh=mesh)
    assert sm.mesh is mesh and sm.camera.device == torch.device("cpu")
    assert sm.cloud.capacity == 15360 and len(sm.cloud.shards) == 1
    s1 = _one_device_twin(sm)
    kernels.reset_launches()
    sm.segment(0.75)
    s1.segment(0.75)
    assert sum(kernels.launches().values()) == 0    # CPU: plain versions
    _same(_state(sm), _state(s1))
    np.testing.assert_array_equal(sm.render(), s1.render())


def test_mesh_capacity_rounds_to_blocks_of_the_mesh():
    """The capacity is a multiple of 1024 x D, a caller's capacity rounded
    up to it (treee_tpu/pipeline.py:270-281); shards are contiguous."""
    mesh = tsh.make_mesh(["cpu"] * 4)
    pts = _forest()
    sm = tpl.Session.from_points(pts, TCFG, mesh=mesh)
    assert sm.cloud.capacity == 16384 and sm.cloud.rows == 4096
    sm = tpl.Session.from_points(pts, TCFG, mesh=mesh, capacity=17000)
    assert sm.cloud.capacity == 20480
    assert sm.cloud.count == len(pts)
    valid = _np(tsh.gather(sm.cloud.column("valid")))
    assert valid[:len(pts)].all() and not valid[len(pts):].any()


# ---- against the JAX package's mesh session --------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """JAX's mesh session over the conftest's 8 CPU devices and the port's
    over 8 CPU shards, both segmented, both with a level-6 LOD."""
    pts = _forest()
    js = jpl.Session.from_points(pts, JCFG, mesh=jsh.make_mesh())
    assert len(js.mesh.devices.flat) == D
    ts = tpl.Session.from_points(pts, TCFG, mesh=tsh.make_mesh(["cpu"] * D))
    rows = (np.asarray(js.cloud.to_numpy()["pos"]), ts.cloud.to_numpy()["pos"])
    js.segment(0.75)
    ts.segment(0.75)
    js.build_lod(level=6)
    ts.build_lod(level=6)
    return js, ts, rows


def test_mesh_rows_ids_and_lod_match_jax(jax_pair):
    js, ts, (j_rows, t_rows) = jax_pair
    assert ts.cloud.capacity == js.cloud.capacity
    np.testing.assert_array_equal(t_rows, j_rows)     # the same Morton order
    t = ts.cloud.gather()
    np.testing.assert_array_equal(t.segment.numpy(),
                                  np.asarray(js.cloud.segment))
    np.testing.assert_array_equal(t.classification.numpy(),
                                  np.asarray(js.cloud.classification))
    np.testing.assert_array_equal(ts._lod[1].numpy(), np.asarray(js._lod[1]))
    assert int(ts._lod[2]) == int(js._lod[2])


def _jax_camera(jc):
    return Camera.from_numpy(np.asarray(jc.transform), np.asarray(jc.offset),
                             device="cpu")


def test_mesh_pick_rasters_and_inventory_match_jax(jax_pair):
    js, ts, _ = jax_pair
    for x, y in ((64, 48), (30, 40), (100, 70), (0, 0)):
        got, ref = ts.pick(x, y), js.pick(x, y)
        assert got[0] == ref[0] and got[2] == ref[2], (x, y)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    gt, ct, _ = ts.rasters(2.0, cap=256)
    gj, cj, _ = js.rasters(2.0, cap=256)
    assert ct == cj
    for k in gj:
        np.testing.assert_array_equal(gt[k], np.asarray(gj[k]), err_msg=k)
    it, ij = ts.inventory(), js.inventory()
    np.testing.assert_array_equal(it["segment"], ij["segment"])
    np.testing.assert_array_equal(it["n_points"], ij["n_points"])
    np.testing.assert_allclose(it["diameter_breast_height"],
                               ij["diameter_breast_height"], rtol=RTOL,
                               atol=ATOL)


def test_mesh_frames_match_jax(jax_pair):
    js, ts, _ = jax_pair
    for distance in (100.0, 50.0):
        jc = type(js.camera).orbital(distance=distance)
        tc = _jax_camera(jc)
        for lod in (False, True):
            got = ts.render(tc, use_lod=lod)
            ref = np.asarray(js.render(jc, use_lod=lod))
            assert got.shape == ref.shape
            share = (got == ref).all(-1).mean()
            assert share >= MIN_JAX_PIXELS, (distance, lod, share)


# ---- the front ends over a mesh session ------------------------------------

def test_repl_and_serve_on_mesh_session(tmp_path):
    """tests/test_sharding.py:675-721: the REPL's commands and the viewer's
    frames, LOD toggle, pick-click and info run unchanged on a mesh
    session; a REPL script prints what it prints over the one-device twin
    and leaves the same ids."""
    from treee_tpu_torch.repl import Repl
    from treee_tpu_torch.serve import ViewerServer

    pts = tlas.synthetic_forest(n_trees=3, points_per_tree=2500,
                                ground_points=2500, seed=21)
    sm = tpl.Session.from_points(pts, TCFG, mesh=tsh.make_mesh(["cpu"] * D))
    s1 = _one_device_twin(sm)
    script = ["distance 0.75", "mode view", "click 64 48", "info", "traits",
              "display hag", f"render {tmp_path / 'hag.png'}",
              "lod level 5", "mode delete",
              "drag 64 48", "lod adaptive", "mode combine", "click 40 50",
              "click 90 50", "summary", "status"]
    outs = []
    for s in (sm, s1):
        r = Repl(s, out=io.StringIO())
        for line in script:
            assert r.handle(line) is True, line
        outs.append(r.out.getvalue())
    assert "error" not in outs[0], outs[0]
    # the text equal but for the summary's decimals, which sum the
    # inventory's float columns (module docstring)
    num = r"-?\d+\.\d+(?:e[-+]?\d+)?"
    assert re.split(num, outs[0]) == re.split(num, outs[1])
    np.testing.assert_allclose(
        [float(x) for x in re.findall(num, outs[0])],
        [float(x) for x in re.findall(num, outs[1])], rtol=RTOL, atol=ATOL)
    _same(_state(sm), _state(s1))

    v = ViewerServer(sm, port=0)
    v.serve_background()
    try:
        def cmd(line):
            req = urllib.request.Request(
                f"http://127.0.0.1:{v.port}/cmd", data=line.encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        assert cmd("rotate 20 5")["ok"]
        assert cmd("lod on")["ok"]
        assert cmd("mode view")["ok"]
        assert cmd("click 64 48")["ok"]
        out = cmd("status")
        assert out["ok"] and "points" in out["output"]
        png = v.frame_png()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{v.port}/info", timeout=300) as r:
            info = json.loads(r.read())
        assert info["points"] == len(pts) and info["segments"] >= 1
    finally:
        v.shutdown()

