"""The port's focused single-tree view against the benchmark's plain
reference (``benchmark/reference/focus.py``: a k-d tree's exact neighbours,
eigenvalues in f64, qhull over every crown point, the axis, the RBVs and
the frame written from the published steps) on the CPU.

Trees stand ~130 m from the origin, as a 220 m tile's do, where squared
distances of ~1e4 m^2 have an f32 ulp of ~1e-3 m^2, more than the gaps
between a point's 31st and 32nd neighbours.  Tolerances, and why:

- curvature: 1e-4 absolute on >= 99% of the members (the port's f32
  closed form against the reference's f64 eigenvalues part by ~1e-5 at
  most); a member's neighbours differ only where the reference's 31st and
  32nd distances lie within 1e-6 of each other (relative);
- the crown hull: the vertex set equal to qhull's over every crown point;
- the trunk axis rtol/atol 1e-5, the RBV max grids rtol 1e-6 and their
  heights 1e-5 (tests/test_torch_focus.py holds the port to the JAX
  package so);
- the focused frame, its members and their curvature: within the
  benchmark cell's own limits (``benchmark/traffic/focus.json``).
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import spatial

from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import hull3d as thull
from treee_tpu_torch import rbv as trbv
from treee_tpu_torch import trunk_axis as tta
from treee_tpu_torch.cloud import CLASS_CROWN, CLASS_TRUNK
from treee_tpu_torch.ops import neighbors as tnb

import torch_threads

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
sys.path.insert(0, BENCH)

from harness import cell, files, scene as scenes, tiny  # noqa: E402
from reference import focus as rf  # noqa: E402
from reference.session import RefSession  # noqa: E402

torch_threads.share_cores()

WORKLOAD = "als15m-focus"
OFFSET = np.array([96.0, 3.0, -88.0])
synthetic_tree = files.load_module("scenes", "synthetic_forest").synthetic_tree


def _tree(n: int, seed: int) -> np.ndarray:
    """One tree of ``n`` points at ``OFFSET``; its first n // 5 points are
    its trunk, the others its crown."""
    rng = np.random.default_rng(seed)
    return synthetic_tree(rng, OFFSET, trunk_height=5.0, crown_height=7.0,
                          crown_radius=3.0, trunk_radius=0.2, n_points=n)


def test_curvature_matches_the_exact_reference():
    p = _tree(4000, 1)
    pos = torch.from_numpy(p)
    member = torch.ones(len(p), dtype=torch.bool)
    got = tch.segment_curvature(pos, member).numpy()
    ref = rf.curvature(p)
    assert (np.abs(got - ref) <= 1e-4).mean() >= 0.99
    # the neighbour sets: equal but where the 31st and 32nd lie that close
    idx, _ = tnb.knn_bruteforce(pos, member)
    q = p.astype(np.float64)
    d, nb = spatial.cKDTree(q).query(q, k=32)
    same = [set(a) == set(b) for a, b in zip(idx.numpy(), nb[:, :31])]
    tie = np.abs(d[:, 31] ** 2 - d[:, 30] ** 2) <= 1e-6 * d[:, 31] ** 2
    assert np.all(np.asarray(same) | tie)
    assert np.mean(same) >= 0.999


@pytest.mark.parametrize("n", [600, 2000, 6000, 20000])
def test_crown_hull_is_the_exact_hull(n):
    """The hull's vertices are qhull's over every crown point, on crowns
    of 600-20,000 points, with more than the 512 support points' hull."""
    p = _tree(n * 5 // 4, n)
    crown = torch.zeros(len(p), dtype=torch.bool)
    crown[len(p) // 5:] = True
    got = thull.convex_hull(torch.from_numpy(p), crown)
    exact = spatial.ConvexHull(p[crown.numpy()].astype(np.float64))
    want = np.flatnonzero(crown.numpy())[exact.vertices]
    np.testing.assert_array_equal(np.sort(got.point_ids), np.sort(want))
    assert got.volume == pytest.approx(exact.volume, rel=1e-9)
    ends = np.unique(rf.hull_lines(p[crown.numpy()]).reshape(-1, 3), axis=0)
    np.testing.assert_array_equal(ends, np.unique(got.vertices, axis=0))
    edges = thull.hull_edges(got.faces)
    assert len(edges) == len(rf.hull_lines(p[crown.numpy()]))


@pytest.fixture(scope="module")
def stand():
    """The focus cell's tiny stand segmented by the port, the reference's
    session on the same points, and the largest tree."""
    sections, scene, _ = tiny.sizes(WORKLOAD)
    pts = scenes.make_points(scene, 7)
    api = cell.ProgramApi(sections, torch.device("cpu"))
    with torch.no_grad():
        sess = api.session(pts)
        sess.segment(0.75)
        table = sess.characteristics()
    ref = RefSession(pts, sections)
    ref.segment(0.75)
    sid = int(table.count[1:].argmax()) + 1
    return dict(pts=pts, sections=sections, api=api, sess=sess, ref=ref,
                sid=sid)


def test_axis_and_rbv_grids_match_the_reference(stand):
    s, sid = stand["sess"], stand["sid"]
    pos, cls_, member = s.segment_rows(sid)
    trunk = member & (cls_ == CLASS_TRUNK)
    axis = tta.average_direction(pos, trunk)
    origin, direction, found = rf.trunk_axis(pos[trunk].numpy())
    assert bool(axis.found) and found
    np.testing.assert_allclose(axis.origin.numpy(), origin, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(axis.direction.numpy(), direction, rtol=1e-5,
                               atol=1e-5)
    tf = tta.axis_transform(axis)
    crown, trunk_rbv = trbv.split_rbv(pos, cls_, member, transform=tf)
    for got, c, (_, slices, sectors) in zip((crown, trunk_rbv),
                                            (CLASS_CROWN, CLASS_TRUNK),
                                            rf.RBV_GRIDS):
        lo, sh, d = rf.rbv_grid(pos[member & (cls_ == c)].numpy(),
                                tf.numpy().astype(np.float64), slices,
                                sectors)
        assert (got.slices, got.sectors) == (slices, sectors)
        np.testing.assert_allclose(got.distances.numpy().reshape(d.shape), d,
                                   rtol=1e-6, atol=1e-6)
        assert float(got.min_y) == pytest.approx(lo, abs=1e-5)
        assert float(got.slice_height) == pytest.approx(sh, abs=1e-5)
        np.testing.assert_allclose(trbv.rbv_lines(got),
                                   rf.rbv_lines(lo, sh, d, tf.numpy()),
                                   rtol=1e-5, atol=1e-5)


def test_focus_frame_is_within_the_cells_limits(stand):
    """A tree's first open through the focus cell's request kind, against
    the reference, within the cell's limits (on this stand: 0 apart)."""
    params = files.load_json("traffic", "focus")
    kind = files.load_module("requests", "focus")
    t = kind.Traffic(params, 2**31 + 9, stand["pts"], None,
                     stand["sections"])
    s, api = stand["sess"], stand["api"]
    with torch.no_grad():
        t.prepare(s, api, None)
        got = {}
        for i in range(len(t.trees)):
            t.before(s, api, None, i)
            got[i] = t.host(t.request(s, api, None, i))
        ref = t.replay(stand["ref"], None, sorted(got))
    checks = t.compare(got, ref)
    assert set(checks) == set(params["limits"])
    assert all(checks[k] <= params["limits"][k] for k in checks), checks
    assert checks == {k: 0.0 for k in checks}, checks
    assert all(len(g["members"]) > 100 for g in got.values())
    # the frames show the tree and its lines
    bg = np.round(np.array(stand["sections"]["render"]["background"])
                  * 255).astype(int)
    for g in got.values():
        f = g["frame"].astype(int)
        assert (np.abs(f - bg).max(-1) > 3).mean() > 0.02
        assert (f.max(-1) <= 10).sum() > 50      # black line pixels
