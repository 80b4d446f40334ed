"""The port's whole-forest inventory against the JAX package on the CPU, at
small sizes: the batched trunk axes, the axis frames, the split RBVs and
traits, and ``Session.inventory`` / ``full_table``.

The JAX package on the CPU runs its scatter formulations (and, for the
average axis, also its sorted form with the Pallas scans in interpret
mode); the port runs its sorted form, with its kernels' plain versions.
Tolerances, and why:

- integer and bool outputs (segment ids, counts, ``found`` /
  ``axis_found``) and the run fills and extents: exact;
- axis origins and directions, rtol 1e-5 and atol 1e-5: means of float
  sums that JAX adds in scatter (row) order and the port in the segmented
  cumsum's doubling order, so each sum of n terms may round apart by
  ~log2(n) ulps of the summands' size;
- max RBV grids, rtol 1e-6: a cell's value is one point's distance from
  the axis, sqrt(x^2 + z^2) of axis-frame coordinates that jitted XLA
  computes with fused multiply-adds, so it lands 1-3 ulps from the port's
  (op by op, one cell of 336 differs, by one ulp).  A point moved across a
  cell edge would show as a difference of centimetres, far outside this.
  Mean grids, rtol 1e-5, for the same reason as the axes;
- traits and the inventory's float columns: rtol 1e-5, atol 1e-6 times the
  column's largest value: sums over up to 832 grid cells in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import rbv as jrbv
from treee_tpu import trunk_axis as jta
from treee_tpu.cloud import PointCloud as JPointCloud
from treee_tpu.config import Config as JConfig
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.pipeline import Session as JSession
from treee_tpu_torch import config as tconfig
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch import rbv as trbv
from treee_tpu_torch import trunk_axis as tta
from treee_tpu_torch.cloud import PointCloud as TPointCloud
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import sums as tsums

import torch_threads

torch_threads.share_cores()

INV_SEG = dict(grid_size=128, max_bands=16, max_segments=64,
               max_trees_per_band=16)
RTOL = 1e-5
FLOAT_COLUMNS = ("x", "z", "easting", "northing", "stem_easting",
                 "stem_northing", "tree_height", "ground_sep", "crown_sep",
                 "trunk_height", "crown_height", *trbv.TRAITS)
EXACT_COLUMNS = ("segment", "n_points", "n_ground", "n_trunk", "n_crown",
                 "axis_found")


def _cylinder(n, radius, height, lean, seed):
    """Points on a (possibly leaning) vertical cylinder shell."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    y = rng.uniform(0, height, n)
    x = radius * np.cos(th) + lean * y
    z = radius * np.sin(th)
    return np.stack([x, y, z], -1).astype(np.float32)


def _forest_arrays(seed=5):
    """tests/test_analytics.py's scene: three trees (trunk and crown
    cylinders, distinct leans and offsets) with a segment-id gap; pos
    f32[N,3], cls i32[N], segment i32[N], S."""
    rng = np.random.default_rng(seed)
    pos, cls_, seg = [], [], []
    for sid, (ox, oz, lean) in zip((1, 2, 4), ((0, 0, 0.0), (12, 3, 0.25),
                                               (-8, 9, -0.15))):
        trunk = _cylinder(1200, 0.25, 4.0, lean, seed + sid)
        crown = _cylinder(2400, 2.0, 5.0, lean, seed + sid + 10)
        crown[:, 1] += 4.0
        ground = np.stack([rng.uniform(-3, 3, 300), rng.uniform(0, 0.2, 300),
                           rng.uniform(-3, 3, 300)], -1).astype(np.float32)
        for p, c in ((trunk, 1), (crown, 2), (ground, 0)):
            pos.append(p + np.array([ox, 0.0, oz], np.float32))
            cls_.append(np.full(len(p), c, np.int32))
            seg.append(np.full(len(p), sid, np.int32))
    return (np.concatenate(pos), np.concatenate(cls_), np.concatenate(seg), 6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _check_axes(got, ref):
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    _close(got.origin, ref.origin)
    _close(got.direction, ref.direction)


@pytest.fixture(scope="module")
def forest():
    pos, cls_, seg, s = _forest_arrays()
    return dict(pos=pos, cls=cls_, seg=seg, S=s, trunk=cls_ == 1)


@pytest.mark.parametrize("algo", ["average", "lowhigh"])
def test_batched_axes_match_jax(forest, algo):
    """Row i: segment i's axis; rows without trunk points: found False,
    origin 0, direction +y, as in JAX."""
    args = (forest["pos"], forest["trunk"], forest["seg"])
    jfn, tfn = {"average": (jta.batched_average_direction,
                            tta.batched_average_direction),
                "lowhigh": (jta.batched_low_high_layer,
                            tta.batched_low_high_layer)}[algo]
    ref = jfn(*map(jnp.asarray, args), forest["S"])
    got = tfn(*map(_t, args), forest["S"])
    _check_axes(got, ref)
    assert got.found.numpy().tolist() == [False, True, True, False, True,
                                          False]
    np.testing.assert_array_equal(got.direction.numpy()[~got.found.numpy()],
                                  [[0, 1, 0]] * 3)
    if algo == "average":
        # the JAX package's sorted form, its Pallas scans in interpret mode
        ref_sorted = jta._batched_average_direction_sorted(
            *map(jnp.asarray, args), forest["S"], 10, None, interpret=True)
        _check_axes(got, ref_sorted)


def test_batched_axis_transform_matches_jax(forest):
    """[S,4,4] frames: y the trunk direction, x and z orthonormal, the
    origin in the last column."""
    args = (forest["pos"], forest["trunk"], forest["seg"])
    ref_axes = jta.batched_average_direction(*map(jnp.asarray, args),
                                             forest["S"])
    axes = tta.TrunkAxis(origin=_t(ref_axes.origin),
                         direction=_t(ref_axes.direction),
                         found=_t(ref_axes.found))
    got = tta.batched_axis_transform(axes).numpy()
    ref = np.asarray(jta.batched_axis_transform(ref_axes))
    _close(got, ref, rtol=1e-6, atol=1e-6)
    rot = got[:, :3, :3]
    _close(np.einsum("sij,sik->sjk", rot, rot), np.eye(3)[None].repeat(6, 0),
           rtol=0, atol=1e-6)


def _jax_transforms(forest):
    axes = jta.batched_average_direction(
        jnp.asarray(forest["pos"]), jnp.asarray(forest["trunk"]),
        jnp.asarray(forest["seg"]), forest["S"])
    return np.asarray(jta.batched_axis_transform(axes))


@pytest.mark.parametrize("method,symmetric", [(trbv.METHOD_MAX, False),
                                              (trbv.METHOD_MEAN, True)])
def test_batched_split_rbv_and_traits_match_jax(forest, method, symmetric):
    """Both packages through the same axis frames: the grids, their
    (min y, slice height), and the traits."""
    tfs = _jax_transforms(forest)
    valid = np.ones(len(forest["pos"]), bool)
    args = (forest["pos"], forest["cls"], valid, forest["seg"])
    kw = dict(crown_slices=6, crown_sectors=8, trunk_slices=4,
              trunk_sectors=8, method=method, symmetric=symmetric)
    jc, jt = jrbv.batched_split_rbv(*map(jnp.asarray, args), forest["S"],
                                    jnp.asarray(tfs), **kw)
    tc, tt = trbv.batched_split_rbv(*map(_t, args), forest["S"], _t(tfs), **kw)
    for got, ref in ((tc, jc), (tt, jt)):
        assert (got.slices, got.sectors) == (ref.slices, ref.sectors)
        _close(got.min_y, ref.min_y, rtol=1e-6, atol=1e-6)
        _close(got.slice_height, ref.slice_height, rtol=1e-6, atol=1e-7)
        _close(got.distances, ref.distances,
               rtol=1e-6 if method == trbv.METHOD_MAX else RTOL, atol=1e-7)
    ref_tr = jrbv.batched_traits(jc, jt)
    got_tr = trbv.batched_traits(tc, tt)
    for name in trbv.TRAITS:
        ref = np.asarray(getattr(ref_tr, name))
        _close(getattr(got_tr, name), ref,
               atol=1e-6 * max(1.0, np.abs(ref).max()), err_msg=name)
    dbh = got_tr.diameter_breast_height.numpy()
    assert (dbh[[1, 2, 4]] > 0.4).all() and (dbh[[0, 3, 5]] == 0).all()


def test_run_fill_and_extents_edge_cases():
    """Empty runs go to the drop row; rows past the last segment get -INF;
    a run with no selected row gives (+INF, -INF), as the JAX package's
    scan forms (interpret mode) give."""
    key = np.array([0, 0, 2, 2, 2, 3, 5, 5], np.int32)  # 1 and 4 are empty
    n_seg = 5                                           # 5 is past the table
    q = np.arange(n_seg + 1, dtype=np.int32)
    bounds = np.searchsorted(key, q, side="left").astype(np.int32)
    left, right = bounds[:-1], bounds[1:]
    table = np.arange(n_seg * 2, dtype=np.float32).reshape(n_seg, 2) - 3.0
    ref = np.asarray(jrbv._run_fill(jnp.asarray(key), jnp.asarray(left),
                                    jnp.asarray(right), jnp.asarray(table),
                                    True, True))
    got = tta.run_fill(_t(key), _t(left).long(), _t(right).long(),
                       _t(table)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:6], table[[0, 0, 2, 2, 2, 3]])
    assert (got[6:] == -3.0e38).all()

    y = np.linspace(-1, 2, len(key)).astype(np.float32)
    sels = (key != 3, key == 0)
    ref = jrbv._sorted_extents(jnp.asarray(key), jnp.asarray(left),
                               jnp.asarray(right), jnp.asarray(y),
                               tuple(map(jnp.asarray, sels)), n_seg, True,
                               True)
    got = trbv._sorted_extents(_t(key), _t(left).long(), _t(right).long(),
                               _t(y), tuple(map(_t, sels)))
    for (gmn, gmx), (rmn, rmx) in zip(got, ref):
        np.testing.assert_array_equal(gmn.numpy(), np.asarray(rmn))
        np.testing.assert_array_equal(gmx.numpy(), np.asarray(rmx))
    # segment 3 has a row but none selected; 1 and 4 have none
    assert got[0][0][3] == 3.0e38 and got[0][1][3] == -3.0e38
    assert got[1][0][2] == 3.0e38 and got[0][0][1] == 3.0e38


@pytest.mark.parametrize("n,n_keys", [(5000, 7), (3000, 2000)])
def test_sums_by_key_leave_out_other_keys(n, n_keys):
    """The mean grid's and the axes' sums: within f32 rounding of the exact
    sums, zero for keys without rows, rows keyed past ``size`` (the
    unselected ones) left out, and the same bits on every call."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, n_keys, n).astype(np.int32)
    sel = rng.random(n) < 0.7
    val = (rng.random((n, 2)) * 5).astype(np.float32)
    size = n_keys + 3
    args = (_t(np.where(sel, key, size)), _t(val), size)
    got = tsums.sums_by_key(*args)
    assert torch.equal(got, tsums.sums_by_key(*args))
    ref = np.stack([np.bincount(key[sel], val[sel, c].astype(np.float64),
                                minlength=size) for c in range(2)], 1)
    _close(got, ref, rtol=1e-5, atol=1e-6)
    assert not got[n_keys:].any()


@pytest.fixture(scope="module")
def sessions():
    """tests/test_analytics.py's end-to-end inventory scene, segmented by
    both packages with a world offset."""
    jcfg = JConfig(segmentation=JSC(**INV_SEG))
    tcfg = tconfig.Config(segmentation=tconfig.SegmentationConfig(**INV_SEG))
    pts = jlas.synthetic_forest(n_trees=5, points_per_tree=3000,
                                ground_points=3000, seed=11)
    off = np.array([512000.25, 12.5, -5400000.75])
    js = JSession.from_points(pts, jcfg, world_offset=off)
    js.segment(0.75)
    ts = tpl.Session.from_points(pts, tcfg, world_offset=off, device="cpu")
    ts.segment(0.75)
    np.testing.assert_array_equal(ts.cloud.segment.numpy(),
                                  np.asarray(js.cloud.segment))
    ts.segment_table = ts.table  # segment()'s own table, for full_table's test
    return js, ts


def _check_inventory(got, ref):
    assert list(got) == list(ref)
    for k in EXACT_COLUMNS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in FLOAT_COLUMNS:
        r = np.asarray(ref[k], np.float64)
        assert got[k].dtype == ref[k].dtype, k
        _close(got[k], r, atol=1e-6 * np.abs(r).max(initial=1.0), err_msg=k)


@pytest.mark.parametrize("method", ["max", "mean"])
@pytest.mark.parametrize("axis_algo", ["average", "lowhigh"])
def test_session_inventory_matches_jax(sessions, axis_algo, method):
    """``Session.inventory()`` as a user calls it, against the JAX
    session's: the same columns, rows and counts; floats within RTOL."""
    js, ts = sessions
    kw = dict(method=method, symmetric=method == "mean", axis_algo=axis_algo)
    kernels.reset_launches()
    got = ts.inventory(**kw)
    assert sum(kernels.launches().values()) == 0  # CPU tensors: plain only
    ref = js.inventory(**kw)
    _check_inventory(got, ref)
    n = len(got["segment"])
    assert n >= 5
    live = int((ts.cloud.valid & (ts.cloud.segment != 0)).sum())
    assert int(got["n_points"].sum()) == live
    has_axis = got["axis_found"] & (got["n_trunk"] > 0)
    assert has_axis.any()
    assert (got["diameter_breast_height"][has_axis] > 0).all()
    for col in got.values():
        assert len(col) == n and np.isfinite(col).all()


def test_full_table_bounds_match_jax(sessions):
    """``segment()`` leaves zero x/z bounds; ``full_table()`` recomputes the
    characteristics with full boxes, as JAX's ``characteristics()``."""
    js, ts = sessions
    assert not ts.segment_table.lo[:, 0].any()
    assert not ts.segment_table.hi[:, 2].any()
    table = ts.full_table()
    assert ts._bbox_full and ts.full_table() is table
    ref = js.characteristics()
    for f in ("lo", "hi"):
        _close(getattr(table, f), getattr(ref, f), atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(table.present.numpy(),
                                  np.asarray(ref.present))
    live = ts.cloud.valid & (ts.cloud.segment != 0)
    np.testing.assert_array_equal(ts.cloud.classification[live].numpy(),
                                  np.asarray(js.cloud.classification)[
                                      live.numpy()])


def test_inventory_degenerate_sessions():
    """An unsegmented all-ground session gives one trunkless row; a cloud
    whose points are all deleted gives an empty table; both as in JAX."""
    cfg = dict(grid_size=64, max_bands=8, max_segments=32,
               max_trees_per_band=8)
    rng = np.random.default_rng(21)
    pts = np.stack([rng.uniform(-5, 5, 2000), rng.uniform(0, 0.3, 2000),
                    rng.uniform(-5, 5, 2000)], -1).astype(np.float32)
    js = JSession.from_points(pts, JConfig(segmentation=JSC(**cfg)))
    ts = tpl.Session.from_points(
        pts, tconfig.Config(segmentation=tconfig.SegmentationConfig(**cfg)),
        device="cpu")
    got, ref = ts.inventory(), js.inventory()
    _check_inventory(got, ref)
    assert len(got["segment"]) == 1
    assert got["n_trunk"][0] == 0 and not got["axis_found"][0]
    assert got["diameter_breast_height"][0] == 0.0

    deleted = np.zeros(len(pts), np.int32)
    js.cloud = JPointCloud.from_numpy(pts, segment=deleted)
    js.table = None
    ts.cloud = TPointCloud.from_numpy(pts, segment=deleted, device="cpu")
    ts.table = None
    got, ref = ts.inventory(), js.inventory()
    _check_inventory(got, ref)
    assert len(got["segment"]) == 0
    assert set(got) == set(EXACT_COLUMNS) | set(FLOAT_COLUMNS)


def test_inventory_on_an_empty_cloud():
    """No points at all: every column empty, nothing raised."""
    s = tpl.Session.from_points(np.zeros((0, 3), np.float32), device="cpu")
    inv = s.inventory(axis_algo="lowhigh", method="mean")
    assert all(len(c) == 0 for c in inv.values())
