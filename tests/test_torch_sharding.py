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
