"""The port's point-sharded steps (``treee_tpu_torch/parallel/sharding.py``)
on meshes of CPU devices, against the port's one-device path and the JAX
package's sharded step.

Every cross-shard value of these steps is an integer sum or an f32 min or
max, so the sharded step must equal the port's ``full_pipeline`` bit for
bit at any number of shards: ids, classes, every table column (floats by
their bits), ``n_alloc``, the tracked centroids and the overflow flag.

The JAX side runs ``sharded_session_step`` on 4 of the conftest's 8 CPU
devices with ``cc_iters=4096``: jitted JAX on the CPU stops connected
components after ceil(cc_iters / 4) bodies, the port at the fixpoint.
There the ids, ``n_alloc``, ``tracked_active``, the classes and the table's
integer columns are exact; the table's floats are held as
``tests/test_torch_pipeline.py`` holds them (rtol = atol = 1e-5, the areas
within 4 eps R^2 more), since XLA may fuse the body of ``shard_map``
otherwise than the one-device step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu.config import Config as JConfig
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.parallel import sharding as jsh
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import rasters as trs
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.ops.f32 import full
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.parallel import sharding as tsh
from treee_tpu_torch.pipeline import full_pipeline

import torch_threads

torch_threads.share_cores()

SEG = dict(grid_size=128, max_bands=16, max_segments=128,
           max_trees_per_band=32)
TCFG = TConfig(segmentation=TSC(**SEG))
JCFG = JConfig(segmentation=JSC(**SEG, cc_iters=4096))
N_PAD = 12288       # 4 shards of 3072 rows, each a multiple of 64
EPS = float(np.finfo(np.float32).eps)


def _padded(pts, n_pad):
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:len(pts)] = pts
    return pos, np.arange(n_pad) < len(pts)


def _forest():
    # tests/test_sharding.py's scene
    return jlas.synthetic_forest(n_trees=4, points_per_tree=2000,
                                 ground_points=1500, seed=7)


def _cpu_mesh(d):
    return tsh.make_mesh(["cpu"] * d)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_table(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(_bits(getattr(a, f.name)),
                                      _bits(getattr(b, f.name)),
                                      err_msg=f.name)


def _single(pos, valid):
    return full_pipeline(torch.from_numpy(pos), torch.from_numpy(valid),
                         0.75, TCFG)


def _same_step(got, ref):
    seg, cls, table, res = got
    r_seg, r_cls, r_table, r_res = ref
    np.testing.assert_array_equal(torch.cat(seg).numpy(), r_seg.numpy())
    np.testing.assert_array_equal(torch.cat(cls).numpy(), r_cls.numpy())
    _same_table(table, r_table)
    assert int(res.n_segments) == int(r_res.n_segments)
    np.testing.assert_array_equal(_bits(res.tracked_pos),
                                  _bits(r_res.tracked_pos))
    np.testing.assert_array_equal(res.tracked_active.numpy(),
                                  r_res.tracked_active.numpy())
    assert bool(res.occupied_overflow) == bool(r_res.occupied_overflow)


@pytest.fixture(scope="module")
def scene():
    pos, valid = _padded(_forest(), N_PAD)
    return dict(pos=pos, valid=valid, ref=_single(pos, valid))


@pytest.fixture(scope="module")
def jax_step(scene):
    """JAX's sharded_session_step over 4 CPU devices, run once."""
    mesh = jsh.make_mesh(jax.devices()[:4])
    pos_s, valid_s = jsh.shard_points(mesh, jnp.asarray(scene["pos"]),
                                      jnp.asarray(scene["valid"]))
    seg, cls, table, res = jsh.sharded_session_step(mesh, JCFG)(
        pos_s, valid_s, jnp.float32(0.75))
    return (np.asarray(seg), np.asarray(cls),
            {f.name: np.asarray(getattr(table, f.name))
             for f in dataclasses.fields(table)}, res)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_session_step_equals_single(scene, d):
    mesh = _cpu_mesh(d)
    kernels.reset_launches()
    pos_s, valid_s = tsh.shard_points(mesh, scene["pos"], scene["valid"])
    got = tsh.sharded_session_step(mesh, TCFG)(pos_s, valid_s, 0.75)
    assert len(got[0]) == d and all(s.shape[0] == N_PAD // d for s in got[0])
    _same_step(got, scene["ref"])
    assert int(got[3].n_segments) >= 4
    assert sum(kernels.launches().values()) == 0    # CPU tensors: plain only


def test_sharded_step_forms_agree(scene):
    """sharded_segment and sharded_pipeline_step give the session step's
    ids, n_alloc and table."""
    mesh = _cpu_mesh(4)
    pos_s, valid_s = tsh.shard_points(mesh, scene["pos"], scene["valid"])
    seg, cls, table, res = scene["ref"]
    ids, n_alloc = tsh.sharded_segment(mesh, TCFG)(pos_s, valid_s, 0.75)
    np.testing.assert_array_equal(torch.cat(ids).numpy(), seg.numpy())
    assert int(n_alloc) == int(res.n_segments)
    ids, c, n_alloc, t = tsh.sharded_pipeline_step(mesh, TCFG)(
        pos_s, valid_s, 0.75)
    np.testing.assert_array_equal(torch.cat(c).numpy(), cls.numpy())
    assert int(n_alloc) == int(res.n_segments)
    _same_table(t, table)


def test_sharded_session_step_matches_jax(scene, jax_step):
    """D = 4: the port's sharded step against JAX's on 4 CPU devices."""
    mesh = _cpu_mesh(4)
    pos_s, valid_s = tsh.shard_points(mesh, scene["pos"], scene["valid"])
    seg, cls, table, res = tsh.sharded_session_step(mesh, TCFG)(
        pos_s, valid_s, 0.75)
    j_seg, j_cls, j_table, j_res = jax_step
    np.testing.assert_array_equal(torch.cat(seg).numpy(), j_seg)
    np.testing.assert_array_equal(torch.cat(cls).numpy(), j_cls)
    assert int(res.n_segments) == int(j_res.n_segments)
    np.testing.assert_array_equal(res.tracked_active.numpy(),
                                  np.asarray(j_res.tracked_active))
    np.testing.assert_allclose(res.tracked_pos.numpy(),
                               np.asarray(j_res.tracked_pos), rtol=1e-6)
    assert bool(res.occupied_overflow) == bool(j_res.occupied_overflow)
    for f in ("present", "count", "n_slices"):
        np.testing.assert_array_equal(getattr(table, f).numpy(), j_table[f],
                                      err_msg=f)
    for f in ("lo", "hi", "ground_sep", "crown_sep", "trunk_height",
              "crown_height"):
        np.testing.assert_allclose(getattr(table, f).numpy(), j_table[f],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    r = float(np.abs(scene["pos"][:, [0, 2]]).max())
    np.testing.assert_allclose(table.areas.numpy(), j_table["areas"],
                               rtol=1e-5, atol=1e-5 + 4 * EPS * r * r)


@pytest.mark.parametrize("full_bbox", [False, True])
def test_sharded_characteristics_equals_single(scene, full_bbox):
    """The table over existing ids, sharded over 4 CPU devices."""
    seg = scene["ref"][0]
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(
        scene["valid"])
    r_table, r_cls = tch.compute_segments(
        pos, seg, valid, SEG["max_segments"] + 1, TCFG.characteristics,
        full_bbox=full_bbox)
    mesh = _cpu_mesh(4)
    pos_s, valid_s = tsh.shard_points(mesh, pos, valid)
    seg_s = tsh.split(mesh, seg)
    table, cls = tsh.sharded_characteristics(mesh, TCFG, full_bbox)(
        pos_s, seg_s, valid_s)
    _same_table(table, r_table)
    np.testing.assert_array_equal(torch.cat(cls).numpy(), r_cls.numpy())
    if full_bbox:
        assert (table.hi[:, 0] > table.lo[:, 0])[table.present].all()


def test_all_padding_shards_do_not_move_the_box():
    """Shards of padding only give the min / max identities to the bounds
    and to the table's y grid: far from the origin, with only shard 0
    holding points, the sharded step equals the one-device step
    (tests/test_sharding.py:246)."""
    pts = jlas.synthetic_forest(n_trees=3, points_per_tree=1500,
                                ground_points=1000, seed=13)
    pts = pts + np.float32([400.0, 50.0, 400.0])
    pos, valid = _padded(pts, 4 * 8192)
    assert len(pts) <= 8192
    mesh = _cpu_mesh(4)
    pos_s, valid_s = tsh.shard_points(mesh, pos, valid)
    assert not any(v.any() for v in valid_s[1:])
    got = tsh.sharded_session_step(mesh, TCFG)(pos_s, valid_s, 0.75)
    _same_step(got, _single(pos, valid))


def test_morton_shards_hold_every_row_once(scene):
    """Morton-range shards are the input's rows reordered by
    ``morton_order``: scattered back by ``order`` they give the input, and
    each shard holds a run of the sorted keys."""
    mesh = _cpu_mesh(4)
    pos_s, valid_s, order = tsh.shard_points_morton(mesh, scene["pos"],
                                                    scene["valid"])
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(
        scene["valid"])
    np.testing.assert_array_equal(order,
                                  tsh.morton_order(pos, valid).numpy())
    assert all(p.shape[0] == N_PAD // 4 for p in pos_s)
    got = np.empty_like(scene["pos"])
    got[order] = torch.cat(pos_s).numpy()
    np.testing.assert_array_equal(got, scene["pos"])
    got_valid = np.empty_like(scene["valid"])
    got_valid[order] = torch.cat(valid_s).numpy()
    np.testing.assert_array_equal(got_valid, scene["valid"])


def test_shard_points_morton_order_matches_jax(scene):
    mesh = _cpu_mesh(4)
    _, _, order = tsh.shard_points_morton(mesh, scene["pos"], scene["valid"])
    jmesh = jsh.make_mesh(jax.devices()[:4])
    _, _, j_order = jsh.shard_points_morton(jmesh, scene["pos"],
                                            scene["valid"])
    np.testing.assert_array_equal(order, np.asarray(j_order))
    # padding rows last, each shard a compact run of keys
    assert not scene["valid"][order][int(scene["valid"].sum()):].any()


@pytest.mark.parametrize("cell", [0.5, 1.0])
def test_sharded_rasters_equal_compute_rasters(scene, cell):
    seg, cls, _, _ = scene["ref"]
    pos = torch.from_numpy(scene["pos"])
    live = torch.from_numpy(scene["valid"]) & (seg > 0)
    lo = scene["pos"][scene["valid"]].min(0)
    hi = scene["pos"][scene["valid"]].max(0)
    ref, dims, r_cell = trs.compute_rasters(pos, cls, live, lo, hi, cell,
                                            cap=128, y_offset=2.5)
    mesh = _cpu_mesh(4)
    got, dims2, cell2 = tsh.sharded_rasters(
        mesh, tsh.split(mesh, pos), tsh.split(mesh, cls),
        tsh.split(mesh, live), lo, hi, cell, cap=128, y_offset=2.5)
    assert dims == dims2 and r_cell == cell2
    for k in ("dtm", "dsm", "chm"):
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32), err_msg=k)


def test_mesh_devices_and_shard_checks():
    """make_mesh resolves names; the default needs a card; shards must
    split evenly into multiples of the anchor stride."""
    mesh = tsh.make_mesh(["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsh.make_mesh()
    with pytest.raises(ValueError):
        tsh.shard_points(mesh, np.zeros((100, 3), np.float32),
                         np.zeros(100, bool))
    with pytest.raises(ValueError):
        tsh.shard_points(mesh, np.zeros((96, 3), np.float32),
                         np.zeros(96, bool))
    assert [int(x) for x in tsh.all_sum([torch.tensor(2), torch.tensor(5)])] \
        == [7, 7]
    lo = tsh.all_min([torch.tensor([0.0, 1.0]), torch.tensor([-0.0, 2.0])])
    assert torch.equal(lo[0].view(torch.int32), lo[1].view(torch.int32))
    assert str(float(lo[0][0])) == "-0.0"


# ---- the interactive half: octree cuts, pick, frame, inventory -----------
#
# Each sharded function against the port's one-device function on the same
# (Morton-ordered) rows, over 1, 2 and 8 shards.  The scene (tests/
# test_sharding.py:373's) has runs of 60 identical positions, so leaf nodes
# span shard boundaries; 3,500 points in 4,096 rows leave the last of 8
# shards all padding.

from treee_tpu_torch import interactive as tedit        # noqa: E402
from treee_tpu_torch import pipeline as tpl             # noqa: E402
from treee_tpu_torch import rbv as trbv                 # noqa: E402
from treee_tpu_torch.cloud import PointCloud            # noqa: E402
from treee_tpu_torch.ops import octree as toct          # noqa: E402
from treee_tpu_torch.parallel.program import run_alone  # noqa: E402
from treee_tpu_torch.render import Camera, palettes, splat  # noqa: E402

SHARDS = [1, 2, 8]


def _spanning_cloud(seed=3, n_pad=4096):
    """Morton-ordered rows with runs of identical positions, a third of
    them dead (not live), padding at the end."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 40, (50, 3)).astype(np.float32)
    pos = np.concatenate([np.repeat(centers, 60, axis=0),
                          rng.uniform(0, 40, (500, 3)).astype(np.float32)])
    out, valid = _padded(pos, n_pad)
    order = tsh.morton_order(torch.from_numpy(out),
                             torch.from_numpy(valid)).numpy()
    live = valid.copy()
    live[::3] = False
    return out[order], valid[order], live[order]


@pytest.fixture(scope="module")
def spanning():
    pos, valid, live = _spanning_cloud()
    tree = toct.build(torch.from_numpy(pos), torch.from_numpy(valid))
    return dict(pos=pos, valid=valid, live=live, tree=tree)


def _trees(mesh, sc):
    return tsh.sharded_octree(mesh)(tsh.split(mesh, sc["pos"]),
                                    tsh.split(mesh, sc["valid"]))


def test_spanning_scene_has_the_hard_cases(spanning):
    """A level-6 node spans the boundary between two of the 8 shards, and
    the last shard holds only padding."""
    keys = spanning["tree"].keys.numpy()
    rows = len(keys) // 8
    coarse = keys >> (3 * (10 - 6))
    n_real = int(spanning["valid"].sum())
    assert any(coarse[k * rows - 1] == coarse[k * rows]
               for k in range(1, 8) if k * rows < n_real)
    assert not spanning["valid"][7 * rows:].any()


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_octree_is_the_shards_of_the_global_sort(spanning, d):
    """The shard-local sorts over the global box concatenate to the one
    device's sorted real keys; the box is the one device's."""
    mesh = _cpu_mesh(d)
    trees = _trees(mesh, spanning)
    ref = spanning["tree"]
    n_real = int(spanning["valid"].sum())
    keys = torch.cat([t.keys for t in trees])
    real = keys != toct.INVALID_KEY
    np.testing.assert_array_equal(keys[real].numpy(), ref.keys[:n_real].numpy())
    rows = len(keys) // d
    order = torch.cat([t.order.long() + k * rows
                       for k, t in enumerate(trees)])
    np.testing.assert_array_equal(order[real].numpy(),
                                  ref.order[:n_real].numpy())
    for t in trees:
        assert torch.equal(t.lo, ref.lo) and torch.equal(t.hi, ref.hi)
        assert t.rank is None and t.inv is None


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("level,ppn,frustum",
                         [(3, 1, False), (6, 2, False), (9, 1, False),
                          (6, 1, True), (10, 3, True)])
def test_sharded_lod_mask_equals_one_device(spanning, d, level, ppn, frustum):
    mesh = _cpu_mesh(d)
    planes = (Camera.orbital(distance=60.0, device="cpu")
              .frustum_planes(16 / 9) if frustum else None)
    live = torch.from_numpy(spanning["live"])
    ref = toct.lod_mask(spanning["tree"], level, ppn, live=live,
                        frustum=planes)
    if frustum:
        assert 0 < int(ref.sum()) < int(live.sum())
    got = tsh.sharded_lod_mask(mesh, level, ppn)(
        _trees(mesh, spanning), tsh.split(mesh, live), planes)
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref.numpy())


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("frustum", [False, True])
def test_sharded_adaptive_mask_and_counts_equal_one_device(spanning, d,
                                                           frustum):
    mesh = _cpu_mesh(d)
    cam = Camera.orbital(distance=50.0, device="cpu")
    planes = cam.frustum_planes(16 / 9) if frustum else None
    cam_pos = torch.tensor([25.0, 30.0, 25.0])
    px = 870.0
    live = torch.from_numpy(spanning["live"])
    trees, live_s = _trees(mesh, spanning), tsh.split(mesh, live)
    ref = toct.adaptive_mask(spanning["tree"], cam_pos, px, tau_px=2.0,
                             live=live, frustum=planes)
    assert 0 < int(ref.sum()) < int(live.sum())
    got = tsh.sharded_adaptive_mask(mesh, px, 2.0)(trees, live_s, cam_pos,
                                                   planes)
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref.numpy())
    taus = tpl.Session.TAU_LADDER
    ref_c = toct.adaptive_counts(spanning["tree"], cam_pos, px, taus,
                                 live=live, frustum=planes)
    got_c = tsh.sharded_adaptive_counts(mesh, px, taus)(trees, live_s,
                                                        cam_pos, planes)
    np.testing.assert_array_equal(got_c.numpy(), ref_c.numpy())


def test_sharded_compact_indices_equal_one_device(spanning):
    mesh = _cpu_mesh(8)
    live = torch.from_numpy(spanning["live"])
    for cap in (64, 1000, 4096, 5000):
        ref = toct.compact_indices(live, cap)
        got = tsh.compact_indices(tsh.split(mesh, live), cap)
        assert int(got[0]) == int(ref[0])
        np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    idx = ref[1][:int(ref[0])]
    np.testing.assert_array_equal(
        tsh.take(tsh.split(mesh, torch.from_numpy(spanning["pos"])),
                 idx).numpy(), spanning["pos"][idx.numpy()])


def _cloud(pos, valid, seg):
    return PointCloud(pos=torch.from_numpy(pos), segment=torch.from_numpy(seg),
                      classification=torch.zeros(len(seg), dtype=torch.int32),
                      valid=torch.from_numpy(valid))


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_pick_equals_one_device(spanning, d):
    """Hits, a miss, and ties: a ray through a run of identical points
    that spans shards hits the lowest row, as ``argmin`` does."""
    mesh = _cpu_mesh(d)
    pos, valid = spanning["pos"], spanning["valid"]
    seg = (np.arange(len(pos)) + 1).astype(np.int32)   # a row's own id
    cloud = _cloud(pos, valid, seg)
    rows = len(pos) // d
    sharded = tsh.ShardedCloud(mesh, tuple(
        _cloud(pos[k * rows:(k + 1) * rows], valid[k * rows:(k + 1) * rows],
               seg[k * rows:(k + 1) * rows]) for k in range(d)))
    pick = tsh.sharded_pick(mesh)
    keys = spanning["tree"].keys.numpy()
    span = next(k * (len(pos) // 8) for k in range(1, 8)
                if keys[k * (len(pos) // 8) - 1] == keys[k * (len(pos) // 8)])
    down = torch.tensor([0.0, -1.0, 0.0])
    rays = [(torch.tensor([20.0, 50.0, 20.0]), down, 1.5),
            (torch.from_numpy(pos[span] + [0.0, 5.0, 0.0]), down, 0.01),
            (torch.tensor([500.0, 500.0, 500.0]),
             torch.tensor([0.0, 1.0, 0.0]), 0.5)]
    hits = []
    for origin, direction, scale in rays:
        ref = tedit.pick(cloud, origin, direction, scale)
        got = pick(sharded, origin, direction, scale)
        assert int(got[0]) == int(ref[0]) and bool(got[2]) == bool(ref[2])
        assert float(got[1]) == float(ref[1])
        hits.append(bool(got[2]))
    assert hits == [True, True, False]
    # the tie: the run's first row, which lies before the boundary
    first = np.flatnonzero((pos == pos[span]).all(1))[0]
    assert int(pick(sharded, *rays[1])[0]) == first + 1 < span + 1


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_render_equals_render_frame(scene, d):
    """The composited key image is the one device's, so the frame is equal
    bit for bit."""
    mesh = _cpu_mesh(d)
    seg = scene["ref"][0]
    pos = torch.from_numpy(scene["pos"])
    mask = torch.from_numpy(scene["valid"]) & (seg > 0)
    prop = splat.prop_from_segment(seg)
    pal = palettes.get(TCFG.render.palette, device="cpu")
    for distance in (100.0, 40.0):
        cam = Camera.orbital(distance=distance, device="cpu")
        ref = splat.render_frame(pos, prop, mask, cam, pal, TCFG.render)
        got = tsh.sharded_render(mesh, TCFG)(
            tsh.split(mesh, pos), tsh.split(mesh, prop),
            tsh.split(mesh, mask), cam, pal)
        assert (ref < 0.999).any()
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("kw", [
    dict(method=0, symmetric=False, axis_algo="average"),
    dict(method=1, symmetric=True, axis_algo="lowhigh")])
def test_sharded_inventory_equals_one_device(scene, d, kw):
    """Counts, ``found`` and the axes' y exact; the directions within 1e-4
    and the traits within JAX's mesh tolerances
    (tests/test_sharding.py:537-547, 669-672): the float sums add per shard,
    then in shard order."""
    mesh = _cpu_mesh(d)
    seg, cls = scene["ref"][0], scene["ref"][1]
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(
        scene["valid"])
    n_seg = SEG["max_segments"] + 1
    rbv_kw = dict(crown_slices=26, crown_sectors=32, trunk_slices=5,
                  trunk_sectors=32)
    ref = run_alone(trbv.inventory_shard(
        pos, seg, cls, valid, n_seg, kw["method"], kw["symmetric"],
        kw["axis_algo"], rbv_kw, across=False))
    got = tsh.sharded_inventory(mesh, TCFG, kw["method"], kw["symmetric"],
                                kw["axis_algo"], **rbv_kw)(
        *(tsh.split(mesh, x) for x in (pos, seg, cls, valid)))
    tr, counts, found, origin = got
    np.testing.assert_array_equal(counts.numpy(), ref[1].numpy())
    np.testing.assert_array_equal(found.numpy(), ref[2].numpy())
    assert int(counts[1:].sum()) > 0 and bool(found.any())
    np.testing.assert_array_equal(origin[:, 1].numpy(), ref[3][:, 1].numpy())
    np.testing.assert_allclose(origin.numpy(), ref[3].numpy(), rtol=1e-4,
                               atol=1e-4)
    for name in tr.__dataclass_fields__:
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   getattr(ref[0], name).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_rbv_grids_equal_one_device(scene, d):
    """Through the same frames, the max grids and every y extent are equal
    bit for bit over shards; the mean grids within rtol 1e-6."""
    from treee_tpu_torch import trunk_axis as tta

    mesh = _cpu_mesh(d)
    seg, cls = scene["ref"][0], scene["ref"][1]
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(
        scene["valid"])
    n_seg = SEG["max_segments"] + 1
    live = valid & (seg > 0)
    tfs = tta.batched_axis_transform(tta.batched_average_direction(
        pos, live & (cls == 1), seg, n_seg))
    split = [tsh.split(mesh, x) for x in (pos, cls, live, seg)]
    for method in (trbv.METHOD_MAX, trbv.METHOD_MEAN):
        ref = trbv.batched_split_rbv(pos, cls, live, seg, n_seg, tfs,
                                     method=method)
        got = tsh.run(mesh, [trbv.batched_split_rbv_shard(
            p, c, m, s, n_seg, tfs, 26, 32, 5, 32, method, False,
            across=True) for p, c, m, s in zip(*split)])[0]
        for g, r in zip(got, ref):
            assert torch.equal(g.min_y, r.min_y)
            assert torch.equal(g.slice_height, r.slice_height)
            if method == trbv.METHOD_MAX:
                assert torch.equal(g.distances, r.distances)
            else:
                np.testing.assert_allclose(g.distances.numpy(),
                                           r.distances.numpy(), rtol=1e-6,
                                           atol=1e-6)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_height_above_ground_equals_one_device(scene, d):
    mesh = _cpu_mesh(d)
    seg, cls = scene["ref"][0], scene["ref"][1]
    pos = torch.from_numpy(scene["pos"])
    live = torch.from_numpy(scene["valid"]) & (seg > 0)
    lo = scene["pos"][scene["valid"]].min(0)
    hi = scene["pos"][scene["valid"]].max(0)
    (rows, cols), shape, cell = trs.grid_dims(lo, hi, 1.0, cap=128)
    ref = trs.height_above_ground(pos, cls, live, full(lo[0], pos),
                                  full(lo[2], pos), full(1.0, pos),
                                  shape, (rows, cols))
    assert float(ref.max()) > 1.0
    got = tsh.sharded_height_above_ground(
        mesh, tsh.split(mesh, pos), tsh.split(mesh, cls),
        tsh.split(mesh, live), lo, hi, 1.0, cap=128)
    np.testing.assert_array_equal(_bits(torch.cat(got)), _bits(ref))


def test_gather_request_stacks_in_shard_order():
    """``("gather", t)`` replies to every shard with the shards' values
    stacked [D, ...]; the carries fold the shards before and after."""
    from treee_tpu_torch.parallel import program

    mesh = _cpu_mesh(3)

    def prog(i):
        g = yield from program.gathered(torch.tensor([i, 10 * i]), True)
        return (g, program.prev_max(g[:, 0], i, -1),
                program.prev_sum(g[:, 1], i), program.next_min(g[:, 0], i, 99))
    out = tsh.run(mesh, [prog(i) for i in range(3)])
    for i, (g, pmax, psum, nmin) in enumerate(out):
        assert g.tolist() == [[0, 0], [1, 10], [2, 20]]
        assert int(pmax) == (i - 1 if i else -1)
        assert int(psum) == sum(10 * k for k in range(i))
        assert int(nmin) == (i + 1 if i < 2 else 99)
    alone = run_alone(program.gathered(torch.tensor([5]), False))
    assert alone.tolist() == [[5]]
