"""The port's main path against the JAX package on the CPU, at small sizes.

The JAX reference runs at its TPU defaults, the CC sweep and match kernels
in interpret mode (``use_pallas_cc=True, use_pallas_match=True``): that path
runs CC to its fixpoint, as the port does.  The port runs its kernels' plain
versions, since its tensors are on the CPU.

Tolerances, and why:

- segment ids, ``n_segments``, ``tracked_active``, ``occupied_overflow``,
  ``present``, ``count``, ``n_slices`` and Morton keys: exact;
- ``tracked_pos``: rtol 1e-6 (centroids are float sums of cell centres);
- ``lo``/``hi``, separators and heights: rtol = atol = 1e-5, since XLA on
  the CPU may contract a*b+c into an FMA where torch does not;
- ``areas``: rtol 1e-5 and atol 1e-5 + 4 eps R^2, R the scene's largest
  |x| or |z|.  The shoelace sum cancels products of polygon vertex
  coordinates of size up to R down to areas of a few m^2, so one FMA more
  or less in XLA moves an area by a few ulps of R^2;
- classification: exact, except for points within 1e-4 m of a separator
  quantised to 16 bits over the scene's height, where the two separators'
  last-bit differences may put the point on either side.  The test counts
  those points.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import characteristics as jch
from treee_tpu import pipeline as jpl
from treee_tpu import segmentation as jsg
from treee_tpu.config import CharacteristicsConfig as JCC
from treee_tpu.config import Config as JConfig
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.ops import octree as joctree
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch import segmentation as tsg
from treee_tpu_torch.config import CharacteristicsConfig as TCC
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import octree as toctree

import torch_threads

torch_threads.share_cores()

SMALL_SEG = dict(grid_size=128, max_bands=32, cc_occupied_cap=1 << 14)
SMALL_CH = dict(max_slices=64)
TPU_DEFAULT = dict(use_pallas_cc=True, use_pallas_match=True)
EPS = float(np.finfo(np.float32).eps)
SCENES = {
    "forest": lambda: jlas.synthetic_forest(
        n_trees=6, points_per_tree=400, ground_points=400, seed=3),
    "realistic": lambda: jlas.synthetic_forest_realistic(
        n_trees=10, extent=40.0, mean_points_per_tree=1500,
        ground_points=5000, seed=1),
}
TABLE_INT = ("present", "count", "n_slices")
TABLE_FLOAT = ("lo", "hi", "ground_sep", "crown_sep", "trunk_height",
               "crown_height")


def _padded(pts):
    n = len(pts)
    cap = max(1024, -(-n // 1024) * 1024)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = pts
    return pos, np.arange(cap) < n


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """A scene, the JAX package's full pipeline and keys on it, and the
    JAX characteristics with full boxes on the JAX segment ids."""
    pts = SCENES[request.param]()
    pos, valid = _padded(pts)
    jcfg = JConfig(segmentation=JSC(**SMALL_SEG, **TPU_DEFAULT),
                   characteristics=JCC(**SMALL_CH))
    seg, cls_, table, res = jpl.full_pipeline(
        jnp.asarray(pos), jnp.asarray(valid), 0.75, jcfg)
    keys = joctree.build_keys(jnp.asarray(pos), jnp.asarray(valid))
    num = jcfg.segmentation.max_segments + 1
    table_fb, cls_fb = jch.compute_segments(
        jnp.asarray(pos), seg, jnp.asarray(valid), num, jcfg.characteristics,
        full_bbox=True)
    to_np = lambda t: {f: np.asarray(getattr(t, f)) for f in  # noqa: E731
                       TABLE_INT + TABLE_FLOAT + ("areas",)}
    return dict(
        name=request.param, pts=pts, pos=pos, valid=valid, num=num,
        seg=np.array(seg), res=res, keys=np.asarray(keys),
        tables={False: (to_np(table), np.asarray(cls_)),
                True: (to_np(table_fb), np.asarray(cls_fb))})


def _tcfg(**seg):
    return TConfig(segmentation=TSC(**{**SMALL_SEG, **seg}),
                   characteristics=TCC(**SMALL_CH))


def _check_segmentation(got, ref):
    np.testing.assert_array_equal(got.segment.numpy(), np.asarray(ref.segment))
    assert int(got.n_segments) == int(ref.n_segments)
    np.testing.assert_array_equal(got.tracked_active.numpy(),
                                  np.asarray(ref.tracked_active))
    np.testing.assert_allclose(got.tracked_pos.numpy(),
                               np.asarray(ref.tracked_pos), rtol=1e-6)
    assert bool(got.occupied_overflow) == bool(ref.occupied_overflow)


def _check_table(got, ref, pts):
    for f in TABLE_INT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)
    for f in TABLE_FLOAT:
        np.testing.assert_allclose(getattr(got, f).numpy(), ref[f], rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    r = float(np.abs(pts[:, [0, 2]]).max())
    np.testing.assert_allclose(got.areas.numpy(), ref["areas"], rtol=1e-5,
                               atol=1e-5 + 4 * EPS * r * r, err_msg="areas")


def _check_classification(got, ref, pos, seg, table):
    """Exact apart from points within 1e-4 m of their segment's separator;
    returns how many such points differ."""
    got = got.numpy()
    diff = got != ref
    if not diff.any():
        return 0
    y = pos[:, 1]
    near = np.minimum(np.abs(y - table["ground_sep"][seg]),
                      np.abs(y - table["crown_sep"][seg])) < 1e-4
    assert not (diff & ~near).any(), np.flatnonzero(diff & ~near)[:10]
    return int(diff.sum())


def test_segment_points_matches_jax(scene):
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(scene["valid"])
    got = tsg.segment_points(pos, valid, 0.75, TSC(**SMALL_SEG))
    _check_segmentation(got, scene["res"])
    assert int(got.n_segments) >= 6


@pytest.mark.parametrize("full_bbox", [False, True])
def test_compute_segments_matches_jax(scene, full_bbox):
    """Fed the JAX package's segment ids, both table forms agree."""
    ref_table, ref_cls = scene["tables"][full_bbox]
    table, cls_ = tch.compute_segments(
        torch.from_numpy(scene["pos"]), torch.from_numpy(scene["seg"]),
        torch.from_numpy(scene["valid"]), scene["num"], TCC(**SMALL_CH),
        full_bbox=full_bbox)
    _check_table(table, ref_table, scene["pts"])
    if full_bbox:
        assert (table.hi[:, 0] > table.lo[:, 0])[table.present].all()
    else:
        assert not table.lo[:, 0].any() and not table.hi[:, 2].any()
    n_near = _check_classification(cls_, ref_cls, scene["pos"], scene["seg"],
                                   ref_table)
    assert n_near <= 5, f"{n_near} points next to a separator classify apart"


def test_session_main_path_matches_jax(scene):
    """The slice as a user drives it: Session.from_points(...).segment(0.75),
    .table and .cloud, then build_keys, against JAX full_pipeline +
    build_keys."""
    kernels.reset_launches()
    s = tpl.Session.from_points(scene["pts"], _tcfg(), device="cpu")
    res = s.segment(0.75)
    keys = toctree.build_keys(s.cloud.pos, s.cloud.valid)
    assert s.cloud.capacity == len(scene["pos"])
    _check_segmentation(res, scene["res"])
    np.testing.assert_array_equal(s.cloud.segment.numpy(), scene["seg"])
    ref_table, ref_cls = scene["tables"][False]
    _check_table(s.table, ref_table, scene["pts"])
    n_near = _check_classification(s.cloud.classification, ref_cls,
                                   scene["pos"], scene["seg"], ref_table)
    assert n_near <= 5, f"{n_near} points next to a separator classify apart"
    np.testing.assert_array_equal(keys.numpy(), scene["keys"])
    assert int(s.table.count.sum()) == int((s.cloud.segment > 0).sum())
    assert sum(kernels.launches().values()) == 0  # CPU tensors: plain only


def test_occupied_overflow_matches_jax_and_warns(caplog):
    """A compaction cap below the occupied cells: both packages flag it and
    still agree, and the session warns."""
    pts = SCENES["forest"]()
    pos, valid = _padded(pts)
    jcfg = JSC(**{**SMALL_SEG, "cc_occupied_cap": 256}, **TPU_DEFAULT)
    ref = jsg.segment_points(jnp.asarray(pos), jnp.asarray(valid), 0.75, jcfg)
    assert bool(ref.occupied_overflow)
    got = tsg.segment_points(torch.from_numpy(pos), torch.from_numpy(valid),
                             0.75, TSC(**{**SMALL_SEG, "cc_occupied_cap": 256}))
    _check_segmentation(got, ref)
    with caplog.at_level(logging.WARNING, logger=tpl.__name__):
        tpl.Session.from_points(pts, _tcfg(cc_occupied_cap=256),
                                device="cpu").segment()
    assert "cc_occupied_cap=256" in caplog.text


def test_session_on_empty_cloud():
    """An all-padding cloud segments to nothing without failing."""
    s = tpl.Session.from_points(np.zeros((0, 3), np.float32), _tcfg(),
                               device="cpu")
    res = s.segment(0.75)
    assert int(res.n_segments) == 0 and not s.cloud.segment.any()
    assert not s.table.present.any()


def test_config_replace_keeps_port_fields():
    cfg = tpl.DEFAULT_CONFIG.replace(
        segmentation=dataclasses.replace(tpl.DEFAULT_CONFIG.segmentation,
                                         max_distance=1.0))
    s = tpl.Session(cfg, device="cpu")
    assert s.max_distance == 1.0 and s.device == torch.device("cpu")


def test_ordered_centroid_sums_give_the_jax_ids(scene, monkeypatch):
    """The order-fixed centroid sums that a CUDA tensor takes (stable sort
    by target, segmented cumsum), run here on the CPU: the same ids as the
    JAX package.  Centroids within 1e-4 m: each is a sum of up to ~10^4 f32
    terms (count x cell centre) that XLA adds in row order and the cumsum
    in doubling steps, so the two round apart by up to ~1e-5 of the
    summands' size."""
    monkeypatch.setattr(tsg, "_sums_by_target", tsg.sums_by_key)
    pos, valid = torch.from_numpy(scene["pos"]), torch.from_numpy(scene["valid"])
    got = tsg.segment_points(pos, valid, 0.75, TSC(**SMALL_SEG))
    ref = scene["res"]
    np.testing.assert_array_equal(got.segment.numpy(), np.asarray(ref.segment))
    assert int(got.n_segments) == int(ref.n_segments)
    np.testing.assert_array_equal(got.tracked_active.numpy(),
                                  np.asarray(ref.tracked_active))
    np.testing.assert_allclose(got.tracked_pos.numpy(),
                               np.asarray(ref.tracked_pos), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("n,n_targets", [(1, 1), (5000, 60), (70_000, 3)])
def test_ordered_sums_match_and_repeat(n, n_targets):
    """Per-target sums with a fixed order: within f32 rounding of the exact
    sums, equal to the sequential CPU sums' rounding class, bit-equal from
    call to call, zero where a target has no rows."""
    rng = np.random.default_rng(n)
    tgt = rng.integers(0, n_targets, n)
    tgt[: n // 2] = 0  # one long run, as the ground band's component
    val = (rng.normal(size=(n, 2)) * 1e4 + 3e4).astype(np.float32)
    size = n_targets + 2
    t_tgt, t_val = torch.from_numpy(tgt), torch.from_numpy(val)
    got = tsg.sums_by_key(t_tgt, t_val, size)
    assert torch.equal(got, tsg.sums_by_key(t_tgt, t_val, size))
    ref = np.zeros((size, 2))
    np.add.at(ref, tgt, val.astype(np.float64))
    mag = np.zeros((size, 2))
    np.add.at(mag, tgt, np.abs(val).astype(np.float64))
    bound = 2 * np.ceil(np.log2(max(n, 2))) * EPS * mag
    assert (np.abs(got.numpy() - ref) <= bound).all()
    seq = tsg._sums_by_target(t_tgt, t_val, size).numpy()
    assert (np.abs(seq - ref) <= n * EPS * mag + 1e-30).all()
    assert not got[n_targets:].any()


# tests/test_segmentation.py's configuration and two of its scenes, padded to
# one capacity so that each JAX configuration compiles once
FLOOD_SEG = dict(grid_size=128, max_bands=16, max_segments=128,
                 max_trees_per_band=32)
FLOOD_CAP = 11264
FLOOD_SCENES = {
    "two_trees": lambda: np.concatenate([
        jlas.synthetic_tree(rng, np.array([gap, 0.0, 0.0]), n_points=3000,
                            crown_radius=1.5, trunk_height=3.0,
                            crown_height=4.0)
        for rng in [np.random.default_rng(0)] for gap in (0.0, 6.0)]),
    "forest": lambda: jlas.synthetic_forest(n_trees=6, points_per_tree=1500,
                                            ground_points=2000, seed=11),
}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(FLOOD_SCENES))
def test_flood_fill_voronoi_matches_jax(name, packed):
    """The jump-flood Voronoi (``use_bruteforce_voronoi=False``), unpacked
    (the jump_flood kernel's path) and packed, against the JAX package's
    jnp floods (``use_pallas=False``; the unpacked one equals its Pallas
    kernel, test_torch_kernels.py): the same segment ids bit for bit."""
    pts = FLOOD_SCENES[name]()
    pos = np.zeros((FLOOD_CAP, 3), np.float32)
    pos[:len(pts)] = pts
    valid = np.arange(FLOOD_CAP) < len(pts)
    flags = dict(use_bruteforce_voronoi=False, use_packed_jfa=packed)
    ref = jsg.segment_points(jnp.asarray(pos), jnp.asarray(valid), 0.75,
                             JSC(**FLOOD_SEG, **flags, **TPU_DEFAULT,
                                 use_pallas=False))
    got = tsg.segment_points(torch.from_numpy(pos), torch.from_numpy(valid),
                             0.75, TSC(**FLOOD_SEG, **flags))
    _check_segmentation(got, ref)
    seg = got.segment.numpy()
    assert (seg[valid] > 0).all() and int(got.n_segments) >= 2
