"""The port's linear octree, LOD and screen-adaptive cuts against the JAX
package on the CPU, at a few thousand points.

``build``, ``lod_mask``, ``adaptive_mask``, ``node_table``, ``compact`` and
``compact_indices`` run eagerly in the JAX package, one XLA op at a time, and
the port equals them bit for bit.  ``adaptive_counts`` is jitted there: the
port equals it run op by op (``jax.disable_jit()``) and, on these scenes,
jitted too.  Mask-level tests feed both sides the same frustum planes (the
JAX camera's, as numpy), since the port's planes are held to the JAX ones
only within rtol 1e-6 (``tests/test_torch_render.py``).

Session-level tolerances, and why:

- the LOD subsets built with a camera come from each package's own planes;
  the number of points that differ is stated and must be 0 here;
- frames: byte-equal wherever the raw key images agree, and those agree on
  at least 99.9% of the pixels: the rotated view matrix is a 4x4 product
  that XLA sums in another order (``tests/test_torch_render.py``); with the
  session's default camera every frame is byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import pipeline as jpl
from treee_tpu.config import CharacteristicsConfig as JCC
from treee_tpu.config import Config as JConfig
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.ops import morton as jmorton
from treee_tpu.ops import octree as joctree
from treee_tpu.render import Camera as JCamera
from treee_tpu.render import splat as jsplat
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch.config import CharacteristicsConfig as TCC
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import morton as tmorton
from treee_tpu_torch.ops import octree as toctree
from treee_tpu_torch.render import Camera as TCamera
from treee_tpu_torch.render import splat as tsplat

import torch_threads

torch_threads.share_cores()

FRAME = dict(width=160, height=120)
ASPECT = FRAME["width"] / FRAME["height"]
MIN_KEY_AGREEMENT = 0.999
IBIG = 0x7FFFFFFF


def _forest():
    return jlas.synthetic_forest(n_trees=4, points_per_tree=600,
                                 ground_points=1200, seed=5)


def _ties():
    """Points snapped to a 0.25 m grid: many share a leaf key, so the
    stable sort's tie order and the ranks within a leaf matter."""
    return np.round(_forest() * 4.0) / 4.0


SCENES = {"forest": _forest, "ties": _ties}


def _padded(pts, extra=37):
    """Positions padded by ``extra`` rows to a row count that is no
    multiple of 1024, the padding rows invalid."""
    n = len(pts)
    pos = np.zeros((n + extra, 3), np.float32)
    pos[:n] = pts
    return pos, np.arange(n + extra) < n


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_camera(jc):
    return TCamera.from_numpy(np.asarray(jc.transform), np.asarray(jc.offset),
                              jc.fov_y, jc.near, jc.far, device="cpu")


# a view that culls part of the scene, and one that culls nothing
CAMERAS = {
    "partial": lambda: JCamera.orbital(distance=14.0).rotate_orbital(
        120.0, -80.0),
    "whole": lambda: JCamera.orbital(distance=80.0),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def trees(request):
    pos, valid = _padded(SCENES[request.param]())
    rng = np.random.default_rng(0)
    live = valid & (rng.random(len(valid)) < 0.8)
    jt = joctree.build(jnp.asarray(pos), jnp.asarray(valid))
    tt = toctree.build(_t(pos), _t(valid))
    return dict(pos=pos, valid=valid, live=live, jt=jt, tt=tt)


def _opt(a, to_jax):
    if a is None:
        return None
    return jnp.asarray(a) if to_jax else _t(a)


def _planes(name):
    return None if name is None else np.asarray(
        CAMERAS[name]().frustum_planes(ASPECT))


# ---- Morton decode and the stable sort ------------------------------------------

def test_decode_and_sort_by_key_are_bit_exact():
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.integers(0, 1 << 30, 2000),
        rng.integers(-(1 << 31), 1 << 31, 2000),   # wrapped prefixes too
        [0x7FFFFFFF, (0x7FFFFFFF << 3) & 0xFFFFFFFF, -1, 1 << 30],
    ]).astype(np.int64).astype(np.uint32).view(np.int32)
    ref = np.asarray(jmorton.decode(jnp.asarray(keys)))
    got = tmorton.decode(_t(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    cells = rng.integers(0, 1024, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tmorton.decode(tmorton.encode(_t(cells))).numpy(), cells)
    # many equal keys: equal keys keep their input order, as jax.lax.sort's
    dup = rng.integers(0, 7, 3000).astype(np.int32)
    vals = np.arange(3000, dtype=np.int32)
    ref = jmorton.sort_by_key(jnp.asarray(dup), jnp.asarray(vals))
    got = tmorton.sort_by_key(_t(dup), _t(vals))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---- the tree --------------------------------------------------------------------

def test_build_is_bit_exact(trees):
    jt, tt = trees["jt"], trees["tt"]
    for f in ("keys", "order", "rank", "inv", "lo", "hi"):
        got, ref = getattr(tt, f), np.asarray(getattr(jt, f))
        assert got.dtype == (torch.int32 if ref.dtype == np.int32
                             else torch.float32), f
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f)
    assert tt.capacity == jt.capacity == len(trees["valid"])
    assert int(tt.rank.max()) >= 1 or not trees["valid"].any()


@pytest.mark.parametrize("n,cap", [(0, 1024), (1, 1024), (1, 1)])
def test_build_edge_clouds_are_bit_exact(n, cap):
    rng = np.random.default_rng(n + cap)
    pos = rng.uniform(-3, 3, (cap, 3)).astype(np.float32)
    valid = np.arange(cap) < n
    jt = joctree.build(jnp.asarray(pos), jnp.asarray(valid))
    tt = toctree.build(_t(pos), _t(valid))
    for f in ("keys", "order", "rank", "inv", "lo", "hi"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    for level in (0, 10):
        ref = joctree.lod_mask(jt, level, frustum=jnp.asarray(
            _planes("whole")))
        got = toctree.lod_mask(tt, level, frustum=_t(_planes("whole")))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- the fixed-level LOD ------------------------------------------------------------

@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("view", [None, "partial", "whole"])
@pytest.mark.parametrize("level,ppn", [(0, 1), (5, 1), (5, 4), (7, 1),
                                       (7, 4), (10, 1), (10, 4)])
def test_lod_mask_is_bit_exact(trees, level, ppn, view, live):
    planes = _planes(view)
    lv = trees["live"] if live else None
    ref = np.asarray(joctree.lod_mask(trees["jt"], level, ppn,
                                      _opt(lv, True), _opt(planes, True)))
    got = toctree.lod_mask(trees["tt"], level, ppn, _opt(lv, False),
                           _opt(planes, False))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()


def test_frustum_views_cull_as_named(trees):
    """The "partial" view culls some level-5 nodes and keeps some, the
    "whole" view keeps every node."""
    tt = trees["tt"]
    full = toctree.lod_mask(tt, 5)
    part = toctree.lod_mask(tt, 5, frustum=_t(_planes("partial")))
    whole = toctree.lod_mask(tt, 5, frustum=_t(_planes("whole")))
    assert 0 < int(part.sum()) < int(full.sum())
    assert torch.equal(whole, full)
    # a frustum that culls everything: the camera looks away from the scene
    away = JCamera.orbital(distance=-200.0).frustum_planes(ASPECT)
    assert not toctree.lod_mask(tt, 5, frustum=_t(np.asarray(away))).any()
    box_lo, box_hi = _t(np.zeros((2, 3), np.float32)), _t(np.ones((2, 3),
                                                                  np.float32))
    np.testing.assert_array_equal(
        toctree.aabb_in_frustum(box_lo, box_hi, _t(_planes("whole"))).numpy(),
        np.asarray(joctree.aabb_in_frustum(jnp.asarray(box_lo.numpy()),
                                           jnp.asarray(box_hi.numpy()),
                                           jnp.asarray(_planes("whole")))))


# ---- the screen-error cut -------------------------------------------------------------

def _cam_pos_scale(view="partial"):
    jc = CAMERAS[view]()
    f = float(jc.projection_matrix(ASPECT)[1, 1])
    return np.asarray(jc.position), np.float32(f) * np.float32(
        FRAME["height"] / 2.0)


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("view", [None, "partial"])
@pytest.mark.parametrize("tau,levels", [(0.75, (4, 10)), (1.5, (4, 10)),
                                        (4.0, (4, 10)), (2.0, (2, 8))])
def test_adaptive_mask_is_bit_exact(trees, tau, levels, view, live):
    cam_pos, px = _cam_pos_scale()
    planes = _planes(view)
    lv = trees["live"] if live else None
    ref = np.asarray(joctree.adaptive_mask(
        trees["jt"], jnp.asarray(cam_pos), px, tau, *levels,
        live=_opt(lv, True), frustum=_opt(planes, True)))
    got = toctree.adaptive_mask(trees["tt"], _t(cam_pos), px, tau, *levels,
                                live=_opt(lv, False),
                                frustum=_opt(planes, False))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum()


@pytest.mark.parametrize("view", [None, "partial"])
def test_adaptive_counts_match_the_masks_and_jax(trees, view):
    cam_pos, px = _cam_pos_scale()
    planes = _planes(view)
    taus = tpl.Session.TAU_LADDER
    assert taus == jpl.Session.TAU_LADDER
    args = (cam_pos, px, taus)
    got = toctree.adaptive_counts(trees["tt"], _t(cam_pos), px, taus,
                                  live=_t(trees["live"]),
                                  frustum=_opt(planes, False))
    assert got.dtype == torch.int32 and got.shape == (len(taus),)
    with jax.disable_jit():
        ref = np.asarray(joctree.adaptive_counts(
            trees["jt"], jnp.asarray(args[0]), px, taus,
            live=jnp.asarray(trees["live"]), frustum=_opt(planes, True)))
    np.testing.assert_array_equal(got.numpy(), ref)
    if view is not None:
        # jitted, XLA may contract the distance's products into FMAs; on
        # these scenes no count moves
        jitted = np.asarray(joctree.adaptive_counts(
            trees["jt"], jnp.asarray(cam_pos), px, taus,
            live=jnp.asarray(trees["live"]), frustum=_opt(planes, True)))
        np.testing.assert_array_equal(got.numpy(), jitted)
    for k, tau in enumerate(taus):
        mask = toctree.adaptive_mask(trees["tt"], _t(cam_pos), px, tau,
                                     live=_t(trees["live"]),
                                     frustum=_opt(planes, False))
        assert int(mask.sum()) == int(got[k])


# ---- node tables and compaction ----------------------------------------------------

@pytest.mark.parametrize("level", [0, 3, 7, 10])
def test_node_table_and_bounds_are_bit_exact(trees, level):
    n_nodes = int(joctree.node_table(trees["jt"], level, 1).n)
    # exactly enough, and 64 and 4096 slots: overflow (nodes dropped) from
    # level 3 on, room to spare below
    for max_nodes in sorted({n_nodes, 64, 4096}):
        ref = joctree.node_table(trees["jt"], level, max_nodes)
        got = toctree.node_table(trees["tt"], level, max_nodes)
        for f in ("prefix", "start", "count", "n"):
            g = getattr(got, f)
            assert g.dtype == torch.int32, f
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
        assert int(got.n) == n_nodes
        for g, r in zip(toctree.node_bounds(got, trees["tt"], level),
                        joctree.node_bounds(ref, trees["jt"], level)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_compact_and_compact_indices_are_bit_exact(trees):
    mask = np.asarray(joctree.lod_mask(trees["jt"], 7,
                                       live=jnp.asarray(trees["live"])))
    n_kept = int(mask.sum())
    pos, valid = trees["pos"], trees["valid"]
    for cap in (n_kept - 100, n_kept, n_kept + 1, len(mask) + 50):
        rc, ri = joctree.compact_indices(jnp.asarray(mask), cap)
        gc, gi = toctree.compact_indices(_t(mask), cap)
        assert gi.dtype == gc.dtype == torch.int32 and gi.shape == (cap,)
        assert int(gc) == int(rc) == min(n_kept, cap)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        sc, si = toctree._compact_indices_scatter(_t(mask), cap)
        assert int(sc) == int(gc) and torch.equal(si, gi)
        rc, (rp, rv) = joctree.compact(jnp.asarray(mask), cap,
                                       jnp.asarray(pos), jnp.asarray(valid))
        gc, (gp, gv) = toctree.compact(_t(mask), cap, _t(pos), _t(valid))
        assert int(gc) == int(rc)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("n", [0, 1, 3276, 3277, 4096, 65535, 65536, 65537,
                               6_140_000, 6_291_456])
@pytest.mark.parametrize("headroom", [1.0, 1.25])
def test_snug_capacity_matches_jax_at_granule_edges(n, headroom):
    got = toctree.snug_capacity(n, headroom)
    assert got == joctree.snug_capacity(n, headroom)
    assert got >= int(n * headroom) and got >= 4096


# ---- the Session: build_lod, render(use_lod), solve_adaptive_tau ---------------------

def _segment_ids(pts, cap):
    """Ids from a 6 m grid over x/z, 1-16, and 0 (deleted) for the
    lowest ground points: sessions need ids, not a segmentation."""
    ids = np.zeros(cap, np.int32)
    cell = np.floor((pts[:, [0, 2]] + 12.0) / 6.0).astype(np.int32)
    ids[:len(pts)] = 1 + (cell[:, 0] * 4 + cell[:, 1]) % 16
    ids[:len(pts)][pts[:, 1] < 0.02] = 0
    return ids


@pytest.fixture(scope="module")
def sessions():
    pts = _forest()
    jcfg = JConfig(segmentation=JSC(max_segments=64),
                   characteristics=JCC(max_slices=64), render=JRC(**FRAME))
    tcfg = TConfig(segmentation=TSC(max_segments=64),
                   characteristics=TCC(max_slices=64), render=TRC(**FRAME))
    js = jpl.Session.from_points(pts, jcfg)
    ts = tpl.Session.from_points(pts, tcfg, device="cpu")
    ids = _segment_ids(pts, js.cloud.capacity)
    js.cloud = js.cloud.replace(segment=jnp.asarray(ids))
    ts.cloud = ts.cloud.replace(segment=_t(ids))
    return js, ts


def _assert_lod_equal(js, ts):
    (rp, ri, rc), (gp, gi, gc) = js._lod, ts._lod
    assert gi.dtype == torch.int32 and gi.shape == ri.shape
    assert int(gc) == int(rc)
    differ = int((gi.numpy() != np.asarray(ri)).sum())
    assert differ == 0, f"{differ} subset rows differ"
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))


def _raw_keys_lod(js, ts, jc, tc):
    (rp, ri, rc), (gp, gi, gc) = js._lod, ts._lod
    with jax.disable_jit():
        seg = js.cloud.segment[ri]
        mask = (js.cloud.valid[ri] & (seg != 0)
                & (jnp.arange(ri.shape[0]) < rc))
        kref = np.asarray(jsplat.rasterize_keys(
            rp, jsplat.prop_from_segment(seg), mask, jc, js.config.render))
    seg = ts.cloud.segment[gi]
    mask = (ts.cloud.valid[gi] & (seg != 0)
            & (torch.arange(gi.shape[0]) < gc))
    kgot = tsplat.rasterize_keys(gp, tsplat.prop_from_segment(seg), mask, tc,
                                 ts.config.render).numpy()
    return kgot, kref


def _frames_match(got, ref, kgot, kref, radius):
    """Byte-equal away from the pixels whose raw keys differ (and the
    splats those could grow into); returns the raw keys' agreement."""
    bad = torch.from_numpy(kgot != kref)[None, None].float()
    bad = torch.nn.functional.max_pool2d(bad, 2 * radius + 3, 1, radius + 1)
    near_bad = bad[0, 0].numpy() > 0
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got[~near_bad], ref[~near_bad])
    return float((kgot == kref).mean())


LOD_BUILDS = {
    "level7": dict(),
    "level5x4": dict(level=5, points_per_node=4),
    "frustum": dict(level=9, camera="partial"),
    "adaptive": dict(camera="partial", adaptive_tau_px=1.5),
}


@pytest.mark.parametrize("with_prop", [False, True])
@pytest.mark.parametrize("build", sorted(LOD_BUILDS))
def test_session_lod_frames_match_jax(sessions, build, with_prop):
    js, ts = sessions
    kw = dict(LOD_BUILDS[build])
    if "camera" in kw:
        jc = CAMERAS[kw["camera"]]()
        js.build_lod(**{**kw, "camera": jc})
        ts.build_lod(**{**kw, "camera": _port_camera(jc)})
    else:
        js.build_lod(**kw)
        ts.build_lod(**kw)
    _assert_lod_equal(js, ts)
    prop = np.linspace(0.0, 1.0, js.cloud.capacity, dtype=np.float32)
    for jc in (js.camera, CAMERAS["partial"]()):
        tc = _port_camera(jc)
        kernels.reset_launches()
        got = ts.render(tc, prop=_t(prop) if with_prop else None,
                        use_lod=True)
        assert sum(kernels.launches().values()) == 0  # CPU: plain versions
        with jax.disable_jit():
            ref = js.render(jc, prop=jnp.asarray(prop) if with_prop else None,
                            use_lod=True)
        kgot, kref = _raw_keys_lod(js, ts, jc, tc)
        assert (kref != IBIG).any()
        share = _frames_match(got, ref, kgot, kref,
                              ts.config.render.max_splat_radius)
        assert share >= MIN_KEY_AGREEMENT
        if jc is js.camera:
            np.testing.assert_array_equal(got, ref)


def test_render_use_lod_builds_level7_and_show_deleted_draws_all(sessions):
    js, ts = sessions
    ts._lod = None
    img = ts.render(use_lod=True)
    assert ts._lod is not None and img.shape == (120, 160, 3)
    js.build_lod()
    _assert_lod_equal(js, ts)
    # the subset leaves deleted points out: show_deleted draws the full cloud
    np.testing.assert_array_equal(ts.render(use_lod=True, show_deleted=True),
                                  ts.render(show_deleted=True))
    with pytest.raises(ValueError, match="camera"):
        ts.build_lod(adaptive_tau_px=1.0)


@pytest.mark.parametrize("mode", ["budget_rows", "match_floor"])
def test_solve_adaptive_tau_matches_jax(sessions, mode):
    js, ts = sessions
    jc = CAMERAS["partial"]()
    tc = _port_camera(jc)
    js.build_lod()
    ts.build_lod()
    before = ts._lod
    if mode == "budget_rows":
        counts = toctree.adaptive_counts(
            ts._lod_tree(), tc.position, tpl._px_scale(tc, ts.config.render),
            ts.TAU_LADDER, live=ts.cloud.alive,
            frustum=tc.frustum_planes(ASPECT)).numpy()
        # a budget between two rungs, one below the finest, one above all
        budgets = [int(counts[3]) + 1, int(counts[-1]) - 1, int(counts[0])]
        for budget in budgets:
            got = ts.solve_adaptive_tau(budget_rows=budget, camera=tc)
            ref = js.solve_adaptive_tau(budget_rows=budget, camera=jc)
            assert got == ref
        assert got == ts.TAU_LADDER[0]
    else:
        got = ts.solve_adaptive_tau(match_floor=0.95, camera=tc)
        with jax.disable_jit():
            ref = js.solve_adaptive_tau(match_floor=0.95, camera=jc)
        assert got == ref
    assert ts._lod is before   # the solver's probes do not leak into the view
    with pytest.raises(ValueError):
        ts.solve_adaptive_tau()
