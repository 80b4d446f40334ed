"""The port's halo tiles (``treee_tpu_torch/parallel/tiles.py``) against the
JAX package's on the CPU.

``tests/test_tiles.py``'s wide scene (five trees 15 m apart, the middle
one on the 2-tile edge, ground across 72 m) and its small ``Config``; the
JAX side with ``cc_iters=4096``, since jitted JAX on the CPU stops
connected components after ceil(cc_iters / 4) bodies and the port runs
them to the fixpoint.

Tolerances, and why:

- per-point ids and classes, ``n_segments``, ``capacity``, ``owners``:
  exact.  The tiles are the same rows in the same order (the one x sort),
  so each tile's step sees what JAX's sees;
- each tile's table as ``tests/test_torch_pipeline.py`` holds one: the
  integer columns exact, the floats rtol = atol = 1e-5, the areas within
  4 eps R^2 more (R the scene's largest |x| or |z|);
- the mesh path against the mesh-free path, and ``tiled_rasters`` against
  ``compute_rasters``: bit for bit (the port's own two paths).  Against
  JAX's ``tiled_rasters``: ``==`` with NODATA at the same cells (JAX
  takes its min and max over the floats, the port over an order-preserving
  integer image, so only -0.0 against +0.0 may differ).
"""

import dataclasses

import numpy as np
import pytest
import torch

from treee_tpu.config import Config as JConfig
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.parallel import tiles as jtiles
from treee_tpu_torch import rasters as trs
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.parallel import sharding as tsh
from treee_tpu_torch.parallel import tiles as ttiles

import torch_threads

torch_threads.share_cores()

SEG = dict(grid_size=128, max_bands=16, max_segments=256,
           max_trees_per_band=32)
TCFG = TConfig(segmentation=TSC(**SEG))
JCFG = JConfig(segmentation=JSC(**SEG, cc_iters=4096))
EPS = float(np.finfo(np.float32).eps)
TABLE_INT = ("present", "count", "n_slices")
TABLE_FLOAT = ("lo", "hi", "ground_sep", "crown_sep", "trunk_height",
               "crown_height")


def _forest(xs=(-30.0, -15.0, 0.0, 15.0, 30.0), ground_x=(-36.0, 36.0),
            seed=15):
    """tests/test_tiles.py's scene: a tree at each x, ground between."""
    rng = np.random.default_rng(seed)
    trees = [jlas.synthetic_tree(rng, np.array([tx, 0.0, 0.0]),
                                 trunk_height=4.0, crown_height=6.0,
                                 crown_radius=2.5, n_points=4000)
             for tx in xs]
    ground = np.stack([rng.uniform(*ground_x, 12000),
                       rng.normal(0.0, 0.05, 12000),
                       rng.uniform(-6, 6, 12000)], axis=1)
    return np.concatenate(trees + [ground]).astype(np.float32)


@pytest.fixture(scope="module")
def pts():
    return _forest()


@pytest.fixture(scope="module", params=[2, 3])
def tiled(request, pts):
    """Both packages' tiled_pipeline at 2 and 3 tiles."""
    n_tiles = request.param
    ref = jtiles.tiled_pipeline(pts, n_tiles=n_tiles, max_distance=0.75,
                                cfg=JCFG)
    got = ttiles.tiled_pipeline(pts, n_tiles=n_tiles, max_distance=0.75,
                                cfg=TCFG, device="cpu")
    return n_tiles, got, ref


def test_plan_tiles_matches_jax(pts):
    for n_tiles, halo in ((2, 12.0), (3, 12.0), (4, 10.0), (1, 12.0)):
        assert (ttiles.plan_tiles(pts[:, 0], n_tiles, halo)
                == jtiles.plan_tiles(pts[:, 0], n_tiles, halo))


def test_tiled_pipeline_matches_jax(tiled, pts):
    n_tiles, (seg, cls, tables, info), (j_seg, j_cls, j_tables, j_info) = tiled
    np.testing.assert_array_equal(seg, j_seg)
    np.testing.assert_array_equal(cls, np.asarray(j_cls))
    for k in ("n_tiles", "capacity", "n_segments", "halo", "owners"):
        assert info[k] == j_info[k], k
    assert len(info["tile_times"]) == n_tiles and info["sort_s"] >= 0.0
    assert len(info["n_alloc"]) == n_tiles
    assert not any(info["occupied_overflow"])
    ids = np.unique(seg)
    ids = ids[ids > 0]
    assert ids.min() == 1 and ids.max() == len(ids) == info["n_segments"]
    # the tree on the 2-tile edge carries one id over ~all its points
    mid = (np.abs(pts[:, 0]) < 2.0) & (pts[:, 1] > 1.0)
    mid_ids = np.unique(seg[mid])
    assert len(mid_ids[mid_ids > 0]) == 1
    r = float(np.abs(pts[:, [0, 2]]).max())
    for t, (tab, j_tab) in enumerate(zip(tables, j_tables)):
        for f in TABLE_INT:
            np.testing.assert_array_equal(getattr(tab, f).numpy(),
                                          np.asarray(getattr(j_tab, f)),
                                          err_msg=f"tile {t} {f}")
        for f in TABLE_FLOAT:
            np.testing.assert_allclose(getattr(tab, f).numpy(),
                                       np.asarray(getattr(j_tab, f)),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"tile {t} {f}")
        np.testing.assert_allclose(tab.areas.numpy(),
                                   np.asarray(j_tab.areas), rtol=1e-5,
                                   atol=1e-5 + 4 * EPS * r * r)
    for g, (t, local) in info["owners"].items():
        assert bool(tables[t].present[local]), g


def test_tiled_pipeline_over_mesh_equals_mesh_free(tiled, pts):
    """Each tile sharded over 4 CPU devices in x-strips: the same ids,
    classes, owners and tables, bit for bit."""
    n_tiles, (seg, cls, tables, info), _ = tiled
    m_seg, m_cls, m_tables, m_info = ttiles.tiled_pipeline(
        pts, n_tiles=n_tiles, max_distance=0.75, cfg=TCFG,
        mesh=tsh.make_mesh(["cpu"] * 4))
    np.testing.assert_array_equal(m_seg, seg)
    np.testing.assert_array_equal(m_cls, cls)
    for k in ("capacity", "n_segments", "owners", "n_alloc",
              "occupied_overflow"):
        assert m_info[k] == info[k], k
    assert m_info["capacity"] % 4096 == 0
    for tab, m_tab in zip(tables, m_tables):
        for f in dataclasses.fields(tab):
            a, b = getattr(tab, f.name).numpy(), getattr(m_tab, f.name).numpy()
            np.testing.assert_array_equal(
                a.view(np.int32) if a.dtype == np.float32 else a,
                b.view(np.int32) if b.dtype == np.float32 else b,
                err_msg=f.name)


def test_tiled_pipeline_with_an_empty_tile():
    """A gap in x wider than a tile: the middle tile holds no point, goes
    through with no segment, and the two stands keep their ids."""
    pts = _forest(xs=(-60.0, -50.0, 50.0, 60.0), ground_x=(-66.0, -44.0))
    far = _forest(xs=(), ground_x=(44.0, 66.0), seed=16)
    pts = np.concatenate([pts, far])
    seg, cls, tables, info = ttiles.tiled_pipeline(
        pts, n_tiles=3, max_distance=0.75, cfg=TCFG, halo=5.0, device="cpu")
    assert info["n_alloc"][1] == 0 and not bool(tables[1].present.any())
    ids = np.unique(seg)
    ids = ids[ids > 0]
    assert ids.min() == 1 and ids.max() == len(ids) == info["n_segments"]
    for tx in (-60.0, -50.0, 50.0, 60.0):
        tree = (np.abs(pts[:, 0] - tx) < 1.5) & (pts[:, 1] > 2.0)
        assert (seg[tree] > 0).mean() > 0.9
        assert len(np.unique(seg[tree][seg[tree] > 0])) == 1
    assert {t for t, _ in info["owners"].values()} == {0, 2}
    assert set(np.unique(cls)) <= {0, 1, 2}


@pytest.mark.parametrize("slab", [1300, 9000, 1 << 20])
def test_tiled_rasters_equal_compute_rasters_and_jax(slab):
    """Slabs that do not divide N, that do, and one slab for all."""
    rng = np.random.default_rng(11)
    n = 18000
    pos = np.stack([rng.uniform(0, 60, n), rng.uniform(0, 20, n),
                    rng.uniform(0, 40, n)], axis=1).astype(np.float32)
    cls = rng.integers(0, 3, n).astype(np.uint8)
    ref, dims, cell = trs.compute_rasters(
        torch.from_numpy(pos), torch.from_numpy(cls.astype(np.int32)),
        torch.ones(n, dtype=torch.bool), pos.min(0), pos.max(0), cell=1.0,
        cap=128, y_offset=5.0)
    got, dims2, cell2 = ttiles.tiled_rasters(pos, cls, cell=1.0, cap=128,
                                             slab=slab, y_offset=5.0,
                                             device="cpu")
    j_got, j_dims, j_cell = jtiles.tiled_rasters(pos, cls, cell=1.0, cap=128,
                                                 slab=slab, y_offset=5.0)
    assert dims == dims2 == j_dims and cell == cell2 == j_cell
    for k in ("dtm", "dsm", "chm"):
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32), err_msg=k)
        np.testing.assert_array_equal(got[k] == trs.NODATA,
                                      np.asarray(j_got[k]) == trs.NODATA)
        np.testing.assert_array_equal(got[k], np.asarray(j_got[k]),
                                      err_msg=k)


def test_bench_tiled_tool_prints_the_jax_tools_keys(monkeypatch, capsys):
    """``python -m treee_tpu_torch.tools.bench_tiled --cpu`` at 40,000
    points in one tile, with the CHM: one JSON line with the keys of
    ``tools/bench_tiled.py``."""
    import json
    import os
    import re

    from treee_tpu_torch.tools import bench_tiled

    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_tiled.py")).read()
    body = src[src.index("print(json.dumps({"):]
    want = re.findall(r'^\s+"(\w+)":', body[:body.index("}), flush")],
                      re.M)
    monkeypatch.setenv("TILED_POINTS", "40000")
    monkeypatch.setenv("TILED_TILES", "1")
    monkeypatch.setenv("TILED_CHM", "1")
    bench_tiled.main(["--cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == want
    assert out["points"] == 40000 and out["device"] == "cpu"
    assert out["n_segments"] >= 1 and out["chm_live_cells"] > 0


def test_survey_trees_majority_and_owners():
    """Each tree's majority id (ties to the lowest) and share; a tree owns
    its id when no other tree's majority is the same."""
    from treee_tpu_torch.tools import survey_trees as st

    seg = np.array([3, 3, 1, 3, 2,      # tree 0: 3 holds 3 of 5
                    2, 1, 1, 2, 5,      # tree 1: 1 and 2 tie -> 1
                    3, 3, 3, 3, 3,      # tree 2: all 3
                    4, 4, 4, 4, 4,      # tree 3: all 4
                    9, 9], np.int32)    # ground rows after the trees
    majority, share = st.tree_majority(seg, 4, 5)
    np.testing.assert_array_equal(majority, [3, 1, 3, 4])
    np.testing.assert_allclose(share, [0.6, 0.4, 1.0, 1.0])
    assert st.owned(majority) == 2      # trees 1 and 3


@pytest.mark.parametrize("joined", [True, False])
def test_survey_trees_edge_agreement(joined):
    """Two trees cut by an edge at x = 0: with their sides' ids joined the
    agreement is the chance two points share an id; with nothing joined
    (each side its own ids) it is 0; a tree wholly on one side is not
    cut."""
    from treee_tpu_torch.tools import survey_trees as st

    per = 20
    x = np.concatenate([np.linspace(-1, 1, per), np.linspace(-1, 3, per),
                        np.linspace(1, 2, per)])
    pts = np.zeros((3 * per, 3), np.float32)
    pts[:, 0] = x
    seg = np.repeat(np.int32([1, 2, 3]), per)
    if not joined:
        seg = np.where(x < 0, seg + 10, seg)
    got, n = st.edge_agreement(pts, seg, 3, per, [0.0])
    assert n == 2
    assert got == (1.0 if joined else 0.0)
    seg[:5] = 7                         # a piece of tree 0 left of the edge
    got, _ = st.edge_agreement(pts, seg, 3, per, [0.0])
    assert got == pytest.approx((1.0 + 0.5) / 2 if joined else 0.0)
