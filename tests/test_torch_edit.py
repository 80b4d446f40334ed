"""The port's sphere edits, picking and the Session's edit methods against the
JAX package on the CPU, at a few thousand points.

The JAX edit functions are jitted.  The port equals them run op by op
(``jax.disable_jit()``, the radius passed as an f32 scalar, as ``jit``
traces it) bit for bit.  Tolerances, and why:

- the jitted JAX edits: XLA may contract the squared distance's products
  into FMAs, so a point whose squared distance lies within 4 ulps of r^2
  may fall on the other side of the sphere; every point on which the two
  differ must lie there;
- ``pick``: the segment id and ``found`` exact; the distance within rtol
  1e-6 when both get the same ray (the three-term dot summed in another
  order), 1e-5 when each session makes its own ray (``ray_direction``
  normalises by ``vector_norm``, held within rtol 1e-6);
- ``full_table()`` after the edits: counts exact, floats rtol = atol = 1e-5,
  as in ``tests/test_torch_pipeline.py`` (XLA's FMAs in the table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import characteristics as jch
from treee_tpu import cloud as jcloud
from treee_tpu import interactive as jedit
from treee_tpu import pipeline as jpl
from treee_tpu.config import CharacteristicsConfig as JCC
from treee_tpu.config import Config as JConfig
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.render import Camera as JCamera
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import cloud as tcloud
from treee_tpu_torch import interactive as tedit
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch.config import CharacteristicsConfig as TCC
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.render import Camera as TCamera

import torch_threads

torch_threads.share_cores()

FRAME = dict(width=160, height=120)
EPS = float(np.finfo(np.float32).eps)
TABLE_INT = ("present", "count", "n_slices")
TABLE_FLOAT = ("lo", "hi", "ground_sep", "crown_sep", "trunk_height",
               "crown_height")


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_camera(jc):
    return TCamera.from_numpy(np.asarray(jc.transform), np.asarray(jc.offset),
                              jc.fov_y, jc.near, jc.far, device="cpu")


def _points():
    return jlas.synthetic_forest(n_trees=4, points_per_tree=600,
                                 ground_points=1200, seed=5)


def _ids_and_classes(pts, cap, seed=0):
    """Ids 1-16 from a 6 m grid over x/z, 0 (deleted) for the lowest ground
    points, and random classes."""
    ids = np.zeros(cap, np.int32)
    cell = np.floor((pts[:, [0, 2]] + 12.0) / 6.0).astype(np.int32)
    ids[:len(pts)] = 1 + (cell[:, 0] * 4 + cell[:, 1]) % 16
    ids[:len(pts)][pts[:, 1] < 0.02] = 0
    cls_ = np.random.default_rng(seed).integers(0, 3, cap).astype(np.int32)
    return ids, cls_


@pytest.fixture(scope="module")
def clouds():
    pts = _points()
    cap = 4096
    ids, cls_ = _ids_and_classes(pts, cap)
    jc = jcloud.PointCloud.from_numpy(pts, cap, ids[:len(pts)],
                                      cls_[:len(pts)])
    tc = tcloud.PointCloud.from_numpy(pts, cap, ids[:len(pts)],
                                      cls_[:len(pts)], device="cpu")
    return pts, jc, tc


def _same_cloud(got, ref):
    for f in ("segment", "classification", "valid", "pos"):
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool,
                           np.dtype(np.float32): torch.float32}[r.dtype]
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f)


# ---- the cloud's helpers -------------------------------------------------------------

@pytest.mark.parametrize("mode", tcloud.INCLUDE_MODES)
def test_include_mask_matches_jax(clouds, mode):
    _, jc, tc = clouds
    assert tcloud.INCLUDE_MODES == jcloud.INCLUDE_MODES
    np.testing.assert_array_equal(
        tcloud.include_mask(tc.classification, mode).numpy(),
        np.asarray(jcloud.include_mask(jc.classification, mode)))


def test_cloud_masks_and_bounds_match_jax(clouds):
    _, jc, tc = clouds
    np.testing.assert_array_equal(tc.alive.numpy(), np.asarray(jc.alive))
    for fill in (float("inf"), -7.5):
        np.testing.assert_array_equal(tc.masked_pos(fill).numpy(),
                                      np.asarray(jc.masked_pos(fill)))
    for g, r in zip(tc.bounds(), jc.bounds()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    gone = tc.replace(segment=torch.zeros_like(tc.segment))
    for g, r in zip(gone.bounds(),
                    jc.replace(segment=jnp.zeros_like(jc.segment)).bounds()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    empty = tcloud.PointCloud.empty(100, device="cpu")
    ref = jcloud.PointCloud.empty(100)
    _same_cloud(empty, ref)
    assert empty.count == 0 and not empty.alive.any()
    with pytest.raises(ValueError, match="include mode"):
        tcloud.include_mask(tc.classification, "leaves")


# ---- the edit functions ---------------------------------------------------------------

def _centers(pts):
    """A tree's trunk point, a ground point, a point in the air, a point of
    segment 3 and a deleted point."""
    ids, _ = _ids_and_classes(pts, len(pts))
    return [pts[0], pts[-1], np.array([0.5, 6.0, -0.5], np.float32),
            pts[np.flatnonzero(ids == 3)[0]], pts[np.flatnonzero(ids == 0)[0]]]


EDITS = {
    "remove": (lambda m, c, ctr, r: m.remove_points(c, ctr, r)),
    "remove_into_5": (lambda m, c, ctr, r: m.remove_points(c, ctr, r, 5)),
    "remove_from_3": (lambda m, c, ctr, r: m.remove_points(c, ctr, r, 9, 3)),
    "remove_deleted": (lambda m, c, ctr, r: m.remove_points(c, ctr, r, 4, 0)),
    "restore": (lambda m, c, ctr, r: m.restore_deleted(c, ctr, r, 6)),
    "reclassify": (lambda m, c, ctr, r: m.change_classification(
        c, ctr, r, 2, 3)),
    "spawn": (lambda m, c, ctr, r: m.spawn_segment(c, ctr, r, 40)),
}


def _boundary_only(pts_pad, valid, differ, center, radius):
    """Whether every differing point lies within 4 ulps of r^2 of the
    sphere's surface."""
    d2 = ((pts_pad.astype(np.float64) - center) ** 2).sum(-1)
    r2 = float(np.float32(radius) * np.float32(radius))
    near = np.abs(d2 - r2) <= 4 * EPS * r2
    return bool((near | ~differ | ~valid).all())


@pytest.mark.parametrize("radius", [0.3, 1.5, 2.0])
@pytest.mark.parametrize("name", sorted(EDITS))
def test_edit_functions_match_jax(clouds, name, radius):
    pts, jc, tc = clouds
    fn = EDITS[name]
    changed = 0
    for center in _centers(pts):
        got = fn(tedit, tc, _t(center), radius)
        with jax.disable_jit():
            ref = fn(jedit, jc, jnp.asarray(center), jnp.float32(radius))
        _same_cloud(got, ref)
        changed += int((got.segment != tc.segment).sum()
                       + (got.classification != tc.classification).sum())
        jitted = fn(jedit, jc, jnp.asarray(center), radius)
        differ = ((got.segment.numpy() != np.asarray(jitted.segment))
                  | (got.classification.numpy()
                     != np.asarray(jitted.classification)))
        assert _boundary_only(np.asarray(jc.pos), np.asarray(jc.valid),
                              differ, center, radius), int(differ.sum())
        # numpy centres and python radii work too
        assert torch.equal(fn(tedit, tc, center, radius).segment, got.segment)
    assert changed > 0 or radius < 1.0


def test_combine_and_segment_exists_match_jax(clouds):
    _, jc, tc = clouds
    got = tedit.combine_segments(tc, 3, 8)
    ref = jedit.combine_segments(jc, 3, 8)
    _same_cloud(got, ref)
    for s in (3, 8, 0, 99):
        assert (bool(tedit.segment_exists(got, s))
                == bool(jedit.segment_exists(ref, s)))
    assert not bool(tedit.segment_exists(got, 3))


def _rays(jc_cam, pixels):
    return [np.asarray(jc_cam.ray_direction(x, y, FRAME["width"],
                                            FRAME["height"]))
            for x, y in pixels]


PICK_CAMERA = lambda: JCamera.orbital(distance=30.0).rotate_orbital(
    20.0, 30.0)
PIXELS = [(80.0, 60.0), (70.5, 66.0), (100.0, 40.0), (3.0, 4.0)]
PICK_SIZE = 0.3


@pytest.mark.parametrize("include_deleted", [False, True])
def test_pick_matches_jax(clouds, include_deleted):
    _, jc, tc = clouds
    cam = PICK_CAMERA()
    origin = np.asarray(cam.position)
    hits = 0
    for d in _rays(cam, PIXELS):
        seg, dist, found = tedit.pick(tc, _t(origin), _t(d), PICK_SIZE,
                                      include_deleted)
        assert seg.dtype == torch.int32 and found.dtype == torch.bool
        ref = jedit.pick(jc, jnp.asarray(origin), jnp.asarray(d), PICK_SIZE,
                         include_deleted)
        assert int(seg) == int(ref[0]) and bool(found) == bool(ref[2])
        np.testing.assert_allclose(float(dist), float(ref[1]), rtol=1e-6)
        hits += bool(found)
    assert 0 < hits < len(PIXELS)


def test_update_separators_from_classes_matches_jax(clouds):
    _, jc, tc = clouds
    rng = np.random.default_rng(3)
    s, ms = 20, 8
    arrays = {
        "present": rng.random(s) < 0.7,
        "count": rng.integers(0, 99, s).astype(np.int32),
        "lo": rng.normal(size=(s, 3)).astype(np.float32),
        "hi": rng.normal(size=(s, 3)).astype(np.float32),
        "areas": rng.random((s, ms)).astype(np.float32),
        "n_slices": rng.integers(0, ms, s).astype(np.int32),
        "ground_sep": rng.normal(size=s).astype(np.float32),
        "crown_sep": rng.normal(size=s).astype(np.float32),
        "trunk_height": rng.random(s).astype(np.float32),
        "crown_height": rng.random(s).astype(np.float32),
    }
    jtab = jch.SegmentTable(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ttab = tch.SegmentTable.from_numpy(arrays, device="cpu")
    # a segment with every class, one without trunk points, an absent one
    cls_ = tc.classification.clone()
    cls_[tc.segment == 7] = 2
    for sid in (5, 7, 19):
        got = tch.update_separators_from_classes(
            tc.pos, tc.segment, tc.valid, cls_, ttab, sid)
        ref = jch.update_separators_from_classes(
            jc.pos, jc.segment, jc.valid, jnp.asarray(cls_.numpy()), jtab,
            sid)
        for f, g in got.to_numpy().items():
            np.testing.assert_array_equal(g, np.asarray(getattr(ref, f)),
                                          err_msg=f"{sid} {f}")
        assert ttab.count[sid] == arrays["count"][sid]  # a new table


# ---- the Session's edit methods -------------------------------------------------------

@pytest.fixture(scope="module")
def sessions():
    pts = _points()
    jcfg = JConfig(segmentation=JSC(max_segments=64),
                   characteristics=JCC(max_slices=64),
                   render=JRC(**FRAME, point_size=PICK_SIZE))
    tcfg = TConfig(segmentation=TSC(max_segments=64),
                   characteristics=TCC(max_slices=64),
                   render=TRC(**FRAME, point_size=PICK_SIZE))
    js = jpl.Session.from_points(pts, jcfg)
    ts = tpl.Session.from_points(pts, tcfg, device="cpu")
    ids, _ = _ids_and_classes(pts, js.cloud.capacity)
    js.cloud = js.cloud.replace(segment=jnp.asarray(ids))
    ts.cloud = ts.cloud.replace(segment=_t(ids))
    js.characteristics()
    ts.characteristics()
    return pts, js, ts


def _check_table(got, ref):
    for f in TABLE_INT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in TABLE_FLOAT:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def test_session_edits_match_jax(sessions):
    pts, js, ts = sessions
    c = _centers(pts)
    strokes = [
        ("delete_sphere", (c[0],), {"radius": 2.0}),
        ("draw_sphere", (c[1], 5), {"radius": 1.5}),
        ("draw_sphere", (c[0], 7), {"radius": 2.0, "include_deleted": True}),
        ("delete_sphere", (c[2],), {}),            # the default radius, 0.5
        ("reclassify_sphere", (c[1], 2, 5), {"radius": 1.5}),
        ("combine", (3, 4), {}),
        ("spawn", (c[2],), {"radius": 2.0}),
        ("spawn", (c[1],), {"radius": 1.5}),
    ]
    for name, args, kw in strokes:
        got = getattr(ts, name)(*args, **kw)
        with jax.disable_jit():
            ref = getattr(js, name)(*args, **kw)
        assert got == ref, name                      # spawn's new ids
        _same_cloud(ts.cloud, js.cloud)
        assert ts._counts_stale == js._counts_stale, name
        _check_table(ts.table, js.table)
    # the reclassified segment's row, from its class extents: exact
    for f in ("count", "present", "trunk_height", "crown_height"):
        assert getattr(ts.table, f)[5] == np.asarray(getattr(js.table, f))[5]
    assert ts._counts_stale
    stale = ts.table
    _check_table(ts.full_table(), js.full_table())
    assert ts.table is not stale and not ts._counts_stale
    assert ts.full_table() is ts.table      # fresh: no second recompute
    ts.update_separators_from_classes(5)
    js.update_separators_from_classes(5)
    _check_table(ts.table, js.table)


@pytest.mark.parametrize("include_deleted", [False, True])
def test_session_pick_matches_jax(sessions, include_deleted):
    _, js, ts = sessions
    js.camera = PICK_CAMERA()
    ts.camera = _port_camera(js.camera)
    hits = 0
    for x, y in PIXELS:
        seg, dist, found = ts.pick(x, y, include_deleted=include_deleted)
        rseg, rdist, rfound = js.pick(x, y, include_deleted=include_deleted)
        assert type(seg) is int and type(dist) is float
        assert (seg, found) == (rseg, rfound)
        np.testing.assert_allclose(dist, rdist, rtol=1e-5)
        hits += found
    assert hits > 0


def test_update_separators_without_a_table_computes_it():
    s = tpl.Session.from_points(_points(), TConfig(
        segmentation=TSC(max_segments=64), characteristics=TCC(max_slices=64)),
        device="cpu")
    assert s.table is None
    s.update_separators_from_classes(3)
    assert s.table is not None and not s._counts_stale


def test_edits_reuse_the_cached_octree_and_subset():
    """Edits rewrite segment ids only: the next LOD frame re-reads them
    through the cached indices, with no new sort or compaction; deleting
    everything leaves only the background.  A new segmentation drops the
    subset and the id counter but keeps the tree (positions never move)."""
    cfg = TConfig(segmentation=TSC(grid_size=64, max_bands=8,
                                   max_segments=256, max_trees_per_band=32),
                  render=TRC(**FRAME))
    pts = jlas.synthetic_forest(n_trees=2, points_per_tree=1500,
                                ground_points=2000, seed=6)
    s = tpl.Session.from_points(pts, cfg, device="cpu")
    s.segment(0.75)
    s.build_lod(level=6)
    tree_before, before = s._tree, s._lod
    assert before is not None
    s.delete_sphere(np.asarray(pts[0], np.float32), radius=1.5)
    assert s._lod is before
    img = s.render(use_lod=True)
    assert img.shape[2] == 3
    assert s._tree is tree_before and s._lod is before
    c = (pts.min(0) + pts.max(0)) / 2.0
    s.delete_sphere(c, radius=float(np.abs(pts - c).max()) * 2.0)
    img2 = s.render(use_lod=True)
    bg = np.clip(np.asarray(s.config.render.background, np.float32) * 255.0
                 + 0.5, 0, 255).astype(np.uint8)
    assert (img2 == bg[None, None, :]).all()
    assert s._tree is tree_before and s._lod is before
    s.spawn(pts[0])
    assert s._next_id is not None and s._counts_stale
    s.segment(0.75)
    assert s._lod is None and s._next_id is None and not s._counts_stale
    assert s._tree is tree_before
