"""The port's rasters, height above ground, forest summary and change
detection against the JAX package on the CPU.

Inputs are made from numpy seeds, or come from one small two-epoch scene
that the port segments (``tests/test_change.py:121-151``: epoch B 15%
taller, tree 0 felled, a tree planted, another world offset); the JAX
sessions take the port's ids, classes and tables, so both packages raster
the same classification.  The port runs its kernels' plain versions, its
tensors being on the CPU.

The JAX side of every flood runs op by op (``jax.disable_jit``): jitted,
``jfa_fill``'s 72-112 unrolled directions cost ~15-20 s of XLA compile per
grid shape, op by op ~4 s for the first call at a shape and ~0.15 s after,
so the tests keep to three shapes.  Both forms give the same bits (as at
128x256 and 256x128): the flood's distances are sums of two exact integer
squares below 2^24, so the one rounding of the sum is the same with or
without an FMA.

Tolerances, and why:

- ``jfa_fill``, ``height_grids``, ``compute_rasters``,
  ``height_above_ground``, ``hag_prop``: bit for bit (``==`` for the
  heights, so that -0.0 and +0.0 count as equal: the port takes the min
  and max over an order-preserving integer image, where -0.0 < +0.0, XLA's
  scatter over the floats), NODATA at the same cells;
- ``grid_dims``, ``Session.rasters``' corner and cell, ``export_raster``:
  equal (the ``.asc`` byte for byte);
- ``forest_summary`` from the same inventory: rtol 1e-6 (it is host
  arithmetic on equal inputs);
- ``render_focus(display="hag")``: byte for byte against JAX op by op
  (jitted, XLA contracts ``p22 * vz + p23`` into an FMA,
  tests/test_torch_render.py);
- ``match_trees``, ``tree_changes``, ``stand_changes``: equal on the same
  inventories; ``chm_change``: the diff bit for bit, corner and cell equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import change as jchange
from treee_tpu import characteristics as jch
from treee_tpu import pipeline as jpl
from treee_tpu import rasters as jrs
from treee_tpu.config import Config as JConfig
from treee_tpu.config import NeighborConfig as JNC
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.render import Camera as JCamera
from treee_tpu_torch import change as tchange
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch import rasters as trs
from treee_tpu_torch.cloud import CLASS_CROWN, CLASS_GROUND
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import NeighborConfig as TNC
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.render import Camera as TCamera
from treee_tpu_torch.segmentation import scene_bounds

import torch_threads

torch_threads.share_cores()

SEG = dict(grid_size=128, max_bands=16, max_segments=64,
           max_trees_per_band=16)
FRAME = dict(width=160, height=120)
TCFG = TConfig(segmentation=TSC(**SEG), render=TRC(**FRAME))
JCFG = JConfig(segmentation=JSC(**SEG), render=JRC(**FRAME))
# the scene spans ~32 m, so its rasters at the default 0.5 m cells (and the
# hag's 1 m) are padded 128x128 grids: every session flood has one shape
CELL = 0.5
OFF_B = np.array([10.0, 0.0, 5.0])


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, ref):
    """Equal values (``==``, so that the zeros' signs do not count) of
    equal dtype and shape."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (got == ref).all(), int((got != ref).sum())


# ---- the flood -------------------------------------------------------------

def _seeds(kind: str, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    grid = rng.normal(0.0, 3.0, (h, w)).astype(np.float32)
    have = np.zeros((h, w), bool)
    if kind == "holes":
        have = rng.random((h, w)) < 0.3
        have[h // 4: h // 2, w // 3: w // 2] = False    # one large hole
    elif kind == "one_seed":
        have[rng.integers(h), rng.integers(w)] = True
    elif kind == "wrap_edge":
        # seeds on the last row and column only: every other cell's nearest
        # seed is reached both directly and through the wrapped rolls
        have[-1, rng.integers(w, size=3)] = True
        have[rng.integers(h, size=3), -1] = True
    elif kind == "full":
        have[:] = True
    return grid, have


def _jax_jfa(grid, have):
    with jax.disable_jit():
        v, ok = jrs.jfa_fill(jnp.asarray(grid), jnp.asarray(have))
    return np.asarray(v), np.asarray(ok)


@pytest.mark.parametrize("h,w,kind", [
    (128, 256, "holes"), (128, 256, "one_seed"), (128, 256, "wrap_edge"),
    (128, 256, "none"), (128, 256, "full"), (256, 128, "holes"),
    (256, 128, "wrap_edge"), (1, 1, "full"), (1, 1, "none"),
])
def test_jfa_fill_matches_jax(h, w, kind):
    grid, have = _seeds(kind, h, w, seed=h + w)
    kernels.reset_launches()
    val, ok = trs.jfa_fill(_t(grid), _t(have))
    assert sum(kernels.launches().values()) == 0
    j_val, j_ok = _jax_jfa(grid, have)
    assert val.numpy().view(np.int32).tobytes() == j_val.view(np.int32).tobytes()
    assert (ok.numpy() == j_ok).all()
    assert ok.numpy().all() == (kind != "none")


def _flood_before(seed_slot, seed_pos, cell_center):
    """The segmentation's plain flood as it was before rectangular grids and
    step lists (square bands, steps G/2, G/4, ..., 1), kept here to show
    that the generalised version's default is unchanged."""
    g = seed_slot.shape[-1]
    cx, cz = cell_center[..., 0], cell_center[..., 1]

    def dist(slot, sx, sz):
        ex = sx - cx
        ez = sz - cz
        return torch.where(slot >= 0, ex * ex + ez * ez, 3.0e38)

    slot = seed_slot
    sx, sz = seed_pos[..., 0], seed_pos[..., 1]
    d = dist(slot, sx, sz)
    s = g // 2
    while s >= 1:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cs = torch.roll(slot, (dy, dx), (1, 2))
                csx = torch.roll(sx, (dy, dx), (1, 2))
                csz = torch.roll(sz, (dy, dx), (1, 2))
                cd = dist(cs, csx, csz)
                better = cd < d
                slot = torch.where(better, cs, slot)
                sx = torch.where(better, csx, sx)
                sz = torch.where(better, csz, sz)
                d = torch.where(better, cd, d)
        s //= 2
    return slot


@pytest.mark.parametrize("b,g,fill", [(3, 1, 1.0), (2, 5, 0.3), (3, 17, 0.05),
                                      (2, 64, 0.002), (2, 96, 0.0)])
def test_plain_flood_default_is_the_segmentations(b, g, fill):
    rng = np.random.default_rng(g)
    seeded = rng.random((b, g, g)) < fill
    slot = _t(np.where(seeded, rng.integers(0, 4, (b, g, g)), -1)
              .astype(np.int32))
    pos = _t(rng.uniform(0, g * 0.75, (b, g, g, 2)).astype(np.float32))
    centre = (np.arange(g, dtype=np.float32) + 0.5) * np.float32(0.75)
    cc = _t(np.stack(np.meshgrid(centre, centre, indexing="ij"), -1))
    ref = _flood_before(slot, pos, cc)
    assert torch.equal(kernels.jump_flood_plain(slot, pos, cc), ref)
    assert torch.equal(kernels.jump_flood_plain(
        slot, pos, cc, kernels.jump_flood_steps(g)), ref)
    assert torch.equal(kernels.jump_flood(slot, pos, cc), ref)


def test_grid_flood_checks_its_input():
    slot = torch.full((4, 6), -1, dtype=torch.int32)
    at = torch.zeros((4, 6, 2))
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(slot, at, at, [2, 0])
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(slot[None], at[None], at, [1])
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(slot, at[:, :5], at, [1])
    assert torch.equal(kernels.jump_flood_grid(slot, at, at, []), slot)


@pytest.mark.parametrize("lo,hi,cell,cap", [
    ((0.0, 0.0, 0.0), (1000.0, 0.0, 500.0), 0.5, 256),   # the cap grows it
    ((-112.3, -1.0, -111.9), (112.1, 20.0, 112.4), 0.5, 4096),
    ((-112.3, -1.0, -111.9), (112.1, 20.0, 112.4), 0.1, 4096),
    ((1.0, 0.0, 1.0), (1.0, 0.0, 1.0), 0.5, 4096),       # one point
    ((0.0, 0.0, 0.0), (12.7, 0.0, 300.0), 1.0, 64),
])
def test_grid_dims_matches_jax(lo, hi, cell, cap):
    lo, hi = np.array(lo, np.float32), np.array(hi, np.float32)
    got = trs.grid_dims(lo, hi, cell, cap=cap)
    assert got == jrs.grid_dims(lo, hi, cell, cap=cap)
    (rows, cols), (ph, pw), c = got
    assert rows <= cap and cols <= cap and ph % 128 == 0 and pw % 128 == 0
    assert c >= cell


# ---- the two-epoch scene -----------------------------------------------------

def _two_epochs():
    """tests/test_change.py:121-151: epoch A, a 5-tree stand; epoch B the
    same stand 15% taller, tree 0 felled, a tree planted at (8, 0) and the
    scan recentred with another world offset."""
    ppt, ground = 3000, 3000
    pts = tlas.synthetic_forest(n_trees=5, points_per_tree=ppt,
                                ground_points=ground, seed=11)
    grown = pts.copy()
    canopy = np.zeros(len(pts), bool)
    canopy[: 5 * ppt] = pts[: 5 * ppt, 1] > 0.3
    grown[canopy, 1] *= 1.15
    new_tree = grown[ppt: 2 * ppt] + np.array([8.0, 0.0, 8.0], np.float32)
    pts_b = (np.concatenate([grown[ppt:], new_tree])
             - OFF_B[None, :].astype(np.float32))
    return pts, pts_b


def _state(s, pts):
    return dict(pts=pts, segment=s.cloud.segment.numpy(),
                classification=s.cloud.classification.numpy(),
                table=s.table.to_numpy(), world_offset=s.world_offset.copy())


@pytest.fixture(scope="module")
def epochs():
    """The port's two segmented epochs (their states), inventories and
    forest summaries."""
    pts_a, pts_b = _two_epochs()
    out = {}
    for name, pts, off in (("a", pts_a, None), ("b", pts_b, OFF_B)):
        s = tpl.Session.from_points(pts, TCFG, world_offset=off, device="cpu")
        s.segment(0.75)
        inv = s.inventory()
        out[name] = dict(_state(s, pts), inventory=inv,
                         summary=s.forest_summary(inventory=inv))
    return out


def _port_session(st, cfg=TCFG):
    s = tpl.Session.from_points(st["pts"], cfg, world_offset=st["world_offset"],
                                device="cpu")
    s.cloud = s.cloud.replace(segment=_t(st["segment"]),
                              classification=_t(st["classification"]))
    s.table = tch.SegmentTable.from_numpy(st["table"], device="cpu")
    s._bbox_full = False
    return s


def _jax_session(st, cfg=JCFG):
    s = jpl.Session.from_points(st["pts"], cfg, world_offset=st["world_offset"])
    s.cloud = s.cloud.replace(segment=jnp.asarray(st["segment"]),
                              classification=jnp.asarray(st["classification"]))
    s.table = jch.SegmentTable(**{k: jnp.asarray(v)
                                  for k, v in st["table"].items()})
    s._bbox_full = False
    return s


def _raster_inputs(s):
    """(pos, ground, live, lo, hi) of a port session, host arrays."""
    c = s.cloud
    live = c.alive
    lo, hi = (a.numpy() for a in scene_bounds(c.pos, live))
    ground = live & (c.classification == CLASS_GROUND)
    return c.pos.numpy(), ground.numpy(), live.numpy(), lo, hi


def test_height_grids_match_jax(epochs):
    pos, ground, live, lo, hi = _raster_inputs(_port_session(epochs["a"]))
    (rows, cols), shape, cell = trs.grid_dims(lo, hi, CELL)
    assert shape == (128, 128)
    args = (np.float32(lo[0]), np.float32(lo[2]), np.float32(1.0 / cell))
    got = trs.height_grids(_t(pos), _t(ground), _t(live),
                           *(torch.tensor(a) for a in args), shape,
                           (rows, cols))
    ref = jrs.height_grids(pos, ground, live, *(jnp.float32(a) for a in args),
                           shape, (rows, cols))
    for g, r, sentinel in zip(got, ref, (jrs._BIG, -jrs._BIG)):
        _same(g.numpy(), np.asarray(r))
        assert ((g.numpy() == np.float32(sentinel))
                == (np.asarray(r) == np.float32(sentinel))).all()
    empty = got[0].numpy() == np.float32(jrs._BIG)
    assert empty.any() and not empty[:rows, :cols].all()


@pytest.mark.parametrize("y_offset", [0.0, 123.25])
def test_compute_rasters_match_jax(epochs, y_offset):
    s = _port_session(epochs["b"])
    pos, _, live, lo, hi = _raster_inputs(s)
    cls_ = s.cloud.classification.numpy()
    got, dims, cell = trs.compute_rasters(_t(pos), _t(cls_), _t(live), lo, hi,
                                          CELL, y_offset=y_offset)
    with jax.disable_jit():
        ref, j_dims, j_cell = jrs.compute_rasters(
            jnp.asarray(pos), jnp.asarray(cls_), jnp.asarray(live), lo, hi,
            CELL, y_offset=y_offset)
    assert (dims, cell) == (j_dims, j_cell) and set(got) == set(ref)
    for k in ref:
        _same(got[k], ref[k])
        assert ((got[k] == trs.NODATA) == (ref[k] == jrs.NODATA)).all()
    assert (got["dtm"] != trs.NODATA).all()
    assert (got["chm"] == trs.NODATA).any() and (got["chm"] > 2.0).any()


def test_height_above_ground_matches_jax(epochs):
    s = _port_session(epochs["a"])
    pos, _, live, lo, hi = _raster_inputs(s)
    cls_ = s.cloud.classification.numpy()
    dims, shape, cell = trs.grid_dims(lo, hi, CELL)
    args = (np.float32(lo[0]), np.float32(lo[2]), np.float32(1.0 / cell))
    got = trs.height_above_ground(_t(pos), _t(cls_), _t(live),
                                  *(torch.tensor(a) for a in args), shape,
                                  dims)
    with jax.disable_jit():
        ref = jrs.height_above_ground(
            jnp.asarray(pos), jnp.asarray(cls_), jnp.asarray(live),
            *(jnp.float32(a) for a in args), shape, dims)
    _same(got.numpy(), np.asarray(ref))
    assert (got.numpy()[~live] == 0).all() and got.numpy().max() > 5.0


@pytest.fixture(scope="module")
def sessions_b(epochs):
    """Epoch B (a world offset) in both packages, with the JAX session's
    rasters at CELL computed once and served from there, so that its
    export_raster and forest_summary run on them without another flood."""
    ts, js = _port_session(epochs["b"]), _jax_session(epochs["b"])
    with jax.disable_jit():
        j_rasters = js.rasters(CELL)
        js.hag_prop()
    js.rasters = lambda cell=0.5, cap=4096: (
        j_rasters if (cell, cap) == (CELL, 4096) else pytest.fail(
            f"unexpected raster call {cell}, {cap}"))
    return ts, js, j_rasters


def test_session_rasters_and_export_match_jax(sessions_b, tmp_path):
    ts, js, (ref, j_ll, j_cell) = sessions_b
    got, ll, cell = ts.rasters(CELL)
    assert ll == j_ll and cell == j_cell
    for k in ref:
        _same(got[k], ref[k])
    for which in ("dtm", "dsm", "chm"):
        paths = [tmp_path / f"{which}_{p}.asc" for p in ("port", "jax")]
        shape = ts.export_raster(str(paths[0]), which, cell=CELL)
        assert shape == js.export_raster(str(paths[1]), which, cell=CELL)
        assert paths[0].read_bytes() == paths[1].read_bytes()
    with pytest.raises(ValueError, match="unknown raster"):
        ts.export_raster(str(tmp_path / "x.asc"), "tin", cell=CELL)


def test_forest_summary_matches_jax(epochs, sessions_b):
    ts, js, _ = sessions_b
    inv = epochs["b"]["inventory"]
    got = ts.forest_summary(inventory=inv)
    ref = js.forest_summary(inventory=inv)
    assert list(got) == list(ref)
    for k in ref:
        assert type(got[k]) is type(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=0.0), k
    assert got["n_trees"] >= 4 and 0.0 < got["canopy_cover"] < 1.0


def test_hag_prop_matches_jax(sessions_b):
    ts, js, _ = sessions_b
    got = ts.hag_prop()
    assert ts.hag_prop() is got                       # cached per cell
    ref = np.asarray(js.hag_prop())
    assert got.numpy().view(np.int32).tobytes() == ref.view(np.int32).tobytes()
    assert got.numpy().max() == 1.0 and got.numpy().min() == 0.0


def _largest_crown(st) -> int:
    seg, cls_ = st["segment"], st["classification"]
    crown = [((seg == i) & (cls_ == CLASS_CROWN)).sum()
             for i in range(seg.max() + 1)]
    return int(np.argmax(crown[1:])) + 1


@pytest.mark.parametrize("path", ["brute", "grid"])
def test_render_focus_hag_matches_jax(epochs, path):
    """The hag focus frame of the largest tree, byte for byte against JAX
    op by op, on the brute path (the compacted rows) and the grid path
    (brute_force_max=0: the full cloud)."""
    st = epochs["a"]
    bfm = dict(neighbors=TNC(brute_force_max=0)) if path == "grid" else {}
    j_bfm = dict(neighbors=JNC(brute_force_max=0)) if path == "grid" else {}
    ts = _port_session(st, TConfig(segmentation=TSC(**SEG),
                                   render=TRC(**FRAME), **bfm))
    js = _jax_session(st, JConfig(segmentation=JSC(**SEG),
                                  render=JRC(**FRAME), **j_bfm))
    jc = JCamera.orbital(distance=40.0).rotate_orbital(30.0, -40.0)
    ts.camera = TCamera.from_numpy(np.asarray(jc.transform),
                                   np.asarray(jc.offset), jc.fov_y, jc.near,
                                   jc.far, device="cpu")
    js.camera = jc
    sid = _largest_crown(st)
    got = ts.render_focus(sid, display="hag")
    assert bool(ts._focus_idx_cache) == (path == "brute")
    with jax.disable_jit():
        ref = js.render_focus(sid, display="hag")
    np.testing.assert_array_equal(got, ref)
    bg = np.round(np.array(TRC().background) * 255).astype(int)
    assert (np.abs(got.astype(int) - bg).max(-1) > 3).mean() > 0.01


def test_hag_cache_resets(epochs):
    """tests/test_interactive.py's rule: segment(), characteristics(), a
    membership edit and reclassify_sphere drop the cached hag_prop."""
    st = epochs["a"]
    s = _port_session(st)
    sid = _largest_crown(st)
    n = len(st["pts"])
    crown = (st["segment"][:n] == sid) & (st["classification"][:n]
                                          == CLASS_CROWN)
    tree = st["pts"][crown][len(st["pts"][crown]) // 2]
    for edit in (s.characteristics, lambda: s.segment(0.75),
                 lambda: s.delete_sphere(tree, radius=0.5),
                 lambda: s.reclassify_sphere(tree, CLASS_GROUND, sid,
                                             radius=1.5)):
        first = s.hag_prop()
        assert s.hag_prop() is first and s._hag_cache
        edit()
        assert not s._hag_cache
    # the reclassified crown points are ground now: the DTM rose under them
    assert not torch.equal(s.hag_prop(), first)


# ---- change detection ----------------------------------------------------------

def _tables_equal(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert g.tobytes() == r.tobytes(), k


def test_tree_changes_match_jax(epochs):
    inv_a, inv_b = epochs["a"]["inventory"], epochs["b"]["inventory"]
    for args in ((inv_a, inv_b), (inv_a, inv_a), (inv_b, inv_a)):
        got = tchange.match_trees(*args, max_dist=2.0)
        ref = jchange.match_trees(*args, max_dist=2.0)
        for g, r in zip(got, ref):
            assert np.array_equal(g, r) and g.dtype == r.dtype
        for trees_only in (True, False):
            got = tchange.tree_changes(*args, max_dist=2.0,
                                       trees_only=trees_only)
            ref = jchange.tree_changes(*args, max_dist=2.0,
                                       trees_only=trees_only)
            assert list(got) == list(ref)
            for part in ref:
                _tables_equal(got[part], ref[part])
    # what the scene was built to show (tests/test_change.py:158-196)
    ch = tchange.tree_changes(inv_a, inv_b, max_dist=2.0)
    m = ch["matched"]
    assert len(m["segment_a"]) >= 4 and (m["delta_tree_height"] > 0.2).all()
    lost, new = ch["lost"], ch["new"]
    assert np.hypot(lost["stem_easting"] + 8.0,
                    lost["stem_northing"] - 8.0).min() < 4.0
    assert np.hypot(new["stem_easting"] - 8.0, new["stem_northing"]).min() < 4.0
    same = tchange.tree_changes(inv_a, inv_a)
    assert len(same["lost"]["segment"]) == len(same["new"]["segment"]) == 0
    assert (same["matched"]["delta_tree_height"] == 0).all()


def test_stand_changes_match_jax(epochs):
    sa, sb = epochs["a"]["summary"], epochs["b"]["summary"]
    got, ref = tchange.stand_changes(sa, sb), jchange.stand_changes(sa, sb)
    assert got == ref and got["max_height"]["delta"] > 0
    assert all(v["delta"] == 0 for v in tchange.stand_changes(sa, sa).values())


def test_chm_change_matches_jax(epochs):
    pa, pb = _port_session(epochs["a"]), _port_session(epochs["b"])
    ja, jb = _jax_session(epochs["a"]), _jax_session(epochs["b"])
    assert tchange._map_bounds(pb) == jchange._map_bounds(jb)
    got, ll, cell = tchange.chm_change(pa, pb, cell=CELL)
    with jax.disable_jit():
        ref, j_ll, j_cell = jchange.chm_change(ja, jb, cell=CELL)
    assert ll == j_ll and cell == j_cell
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    valid = got != tchange.NODATA
    assert float(got[valid].mean()) > 0.0 and float(got[valid].min()) < -1.0
    self_diff, _, _ = tchange.chm_change(pa, pa, cell=CELL)
    assert np.all((self_diff == 0.0) | (self_diff == tchange.NODATA))
