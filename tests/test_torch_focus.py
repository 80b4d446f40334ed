"""The port's focused single-tree view against the JAX package on the CPU,
at a few thousand points: eigen, both k-NNs, the covariances,
``segment_properties``, curvature and normals, the single-tree trunk axes,
RBVs and traits, the crown hull, the ``geo.py`` copy, and the Session's
focused view with its caches.

Inputs come from numpy seeds (or from one small segmentation by the port,
whose ids, classes and table both packages then take) and go through both
packages; the port runs its kernels' plain versions, its tensors being on
the CPU.  Tolerances, and why:

- eigenvalues, atol 2e-6 of the matrix's largest entry: ``acos`` and
  ``cos`` of the port's libm and XLA's differ by a few ulps; near a
  repeated eigenvalue (two within 1e-3 of the scale) 5e-4, because there
  |r| is near 1, where acos turns one ulp of r into sqrt(ulp) ~ 3.5e-4;
  the fallback branches (diagonal matrices, +y normals) are exact;
- eigenvectors, 1 - |dot| <= 1e-4 where the two smallest eigenvalues lie
  1e-3 of the scale apart (closer, the vector is ill-conditioned);
- brute-force k-NN: |q|^2 + |p|^2 - 2 q.p cancels, and XLA's dot of three
  products rounds otherwise than the port's three products and two adds,
  so distances agree within 2e-6 of |q|^2 + max |p|^2 (a few ulps of the
  terms), and a row's indices differ only where two of its distances lie
  that close; on lattices, whose distances are exact integers, indices
  and distances equal bit for bit (the tie rule), and the INF padding of
  a query with fewer than k members is the same rows;
- grid k-NN on lattices: indices and distances bit for bit, cell overflow
  included; against the brute force where no cell overflows: the same
  sets, up to the brute force's cancellation as above;
- covariances, atol 1e-6 of the squared scale (sums over k in another
  order);
- ``segment_properties``: height bit for bit; expansion within 1e-6 on
  >= 99.9% of points and within 1e-3 everywhere: XLA contracts some of
  the slice polygons' shoelace products into FMAs (as in
  ``compute_segments``, tests/test_torch_pipeline.py), and a slice of one
  or two crown points has an area that is all cancellation, ~ulp(R^2);
- curvature and normals: 1e-4 absolute on >= 99% of member points (sums
  of 31 products in another order, then eigen);
- axes, rtol/atol 1e-5; RBV max grids rtol 1e-6, mean grids and traits
  rtol 1e-5 (sums in another order; the grids' cells: no point of these
  scenes lies within an ulp of a sector or slice edge, so none moves);
- hull area and volume rtol 1e-6, vertices equal; candidates equal.  The
  port's hull is exact (qhull over the support candidates and the points
  its interior discard keeps), the JAX package's over more than 512
  masked points is the 512 support candidates' alone, so above 512 points
  the port is held to the JAX package's ``exact=True`` hull, which the
  JAX side's call takes in these tests (``_exact_jax_hull``);
- focused frames: against the JAX package's ``render_focus`` (its jitted
  parts), within 1 per channel on >= 99.9% of pixels: under ``jit`` XLA
  fuses ``p22 * vz + p23`` into an FMA, which moves some depth keys by a
  step (tests/test_torch_render.py) and the eye-dome shade by 1, and the
  curve, shaded and expansion colours follow float properties that differ
  in the last bits; the classification frame, whose colours are exact,
  against JAX run op by op (``jax.disable_jit``), byte for byte.  Running
  every view op by op would cost ~55 s of XLA compiles.
"""

import dataclasses as dc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import characteristics as jch
from treee_tpu import hull3d as jhull
from treee_tpu import pipeline as jpl
from treee_tpu import rbv as jrbv
from treee_tpu import trunk_axis as jta
from treee_tpu.config import Config as JConfig
from treee_tpu.config import NeighborConfig as JNC
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.ops import eigen as jeig
from treee_tpu.ops import neighbors as jnb
from treee_tpu.render import Camera as JCamera
from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import hull3d as thull
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch import rbv as trbv
from treee_tpu_torch import trunk_axis as tta
from treee_tpu_torch.cloud import CLASS_CROWN, CLASS_TRUNK
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import NeighborConfig as TNC
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import eigen as teig
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import neighbors as tnb
from treee_tpu_torch.render import Camera as TCamera

import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 3.0e38
SEG = dict(grid_size=128, max_bands=16, max_segments=256,
           max_trees_per_band=32)
FRAME = dict(width=160, height=120)
TCFG = TConfig(segmentation=TSC(**SEG), render=TRC(**FRAME))
JCFG = JConfig(segmentation=JSC(**SEG), render=JRC(**FRAME))
MIN_FRAME_MATCH = 0.999


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ---- eigen ---------------------------------------------------------------------

def _matrices(kind: str, n: int = 2000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        a = rng.normal(size=(n, 3, 3)) * rng.uniform(0.01, 10, (n, 1, 1))
        return (a @ a.transpose(0, 2, 1)).astype(np.float32)
    if kind == "diagonal":
        d = rng.uniform(0, 5, (n, 3)).astype(np.float32)
        d[::3, 1] = d[::3, 0]               # repeated eigenvalues
        d[1::7] = 0.0                       # the zero matrix
        return np.einsum("ni,ij->nij", d, np.eye(3, dtype=np.float32))
    # rank-deficient: points on lines (rank 1) and planes (rank 2)
    u = rng.normal(size=(n, 3, 1))
    v = rng.normal(size=(n, 3, 1))
    m = u @ u.transpose(0, 2, 1)
    m[::2] += v[::2] @ v[::2].transpose(0, 2, 1)
    return m.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "diagonal", "rank_deficient"])
def test_eigen_matches_jax(kind):
    m = _matrices(kind)
    scale = np.abs(m).max(axis=(1, 2))
    got = teig.eigvals_sym3(_t(m)).numpy()
    ref = np.asarray(jeig.eigvals_sym3(jnp.asarray(m)))
    gaps = np.minimum(ref[:, 0] - ref[:, 1], ref[:, 1] - ref[:, 2])
    tol = np.where(gaps < 1e-3 * scale, 5e-4, 2e-6) * scale
    assert np.all(np.abs(got - ref) <= tol[:, None] + 1e-30)
    diag = np.abs(m - np.einsum("nii->ni", m)[:, :, None]
                  * np.eye(3, dtype=np.float32)).max(axis=(1, 2)) == 0
    np.testing.assert_array_equal(got[diag], ref[diag])   # the sorted branch
    c_got = teig.curvature_from_cov(_t(m)).numpy()
    c_ref = np.asarray(jeig.curvature_from_cov(jnp.asarray(m)))
    tr = np.maximum(ref.sum(axis=1), 1e-20)
    assert np.all(np.abs(c_got - c_ref) <= 3.0 * tol / tr + 1e-5)
    v_got = teig.smallest_eigenvector(_t(m)).numpy()
    v_ref = np.asarray(jeig.smallest_eigenvector(jnp.asarray(m)))
    assert np.all(v_got[:, 1] >= 0) and np.allclose(
        np.linalg.norm(v_got, axis=1), 1.0, atol=1e-5)
    gap = ref[:, 1] - ref[:, 2]
    good = gap > 1e-3 * scale
    assert good.sum() > 0.3 * len(m)
    dot = np.abs((v_got * v_ref).sum(axis=1))
    assert np.all(1.0 - dot[good] <= 1e-4)
    # the +y fallback (zero matrices, isotropic diagonals) is the same
    up = np.all(v_ref == [0.0, 1.0, 0.0], axis=1)
    np.testing.assert_array_equal(v_got[up], v_ref[up])
    if kind == "diagonal":
        assert up.any()


# ---- k-NN ----------------------------------------------------------------------

def _cloud(kind: str, seed: int = 1):
    """(pos f32[N,3], valid bool[N]) of a k-NN case."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        pos = rng.normal(size=(2000, 3)).astype(np.float32) * [4, 8, 4]
        valid = rng.random(2000) < 0.9
    elif kind == "few_members":     # 12 valid points: fewer than k
        pos = rng.uniform(-5, 5, (1100, 3)).astype(np.float32)
        valid = np.zeros(1100, bool)
        valid[rng.choice(1100, 12, replace=False)] = True
    else:                           # a lattice: exact distances, many ties
        g = np.arange(8, dtype=np.float32)
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        pos = np.concatenate([pos, pos[::5]])       # duplicated points
        valid = np.ones(len(pos), bool)
        valid[::11] = False
    return pos.astype(np.float32), valid


def _cancellation_tol(pos):
    """Per query row, 2e-6 of |q|^2 + max |p|^2: how far the identity's
    distances may round apart between two orders of its terms."""
    mag = (pos.astype(np.float64) ** 2).sum(axis=1)
    return 2e-6 * (mag + mag.max())


def _rows_differ_only_at_ties(idx, dist, j_idx, j_dist, tol):
    """Index rows equal, except rows where two distances lie within the
    row's tolerance of each other; returns the share of equal rows."""
    same = (idx == j_idx).all(axis=1)
    for r in np.flatnonzero(~same):
        d = np.sort(np.concatenate([dist[r], j_dist[r]]))
        assert np.diff(d[d < INF]).min() <= 2 * tol[r], r
    return same.mean()


@pytest.mark.parametrize("kind", ["random", "few_members", "lattice"])
def test_knn_bruteforce_matches_jax(kind):
    pos, valid = _cloud(kind)
    idx, dist = tnb.knn_bruteforce(_t(pos), _t(valid), k=31)
    j_idx, j_dist = jnb.knn_bruteforce(jnp.asarray(pos), jnp.asarray(valid),
                                      k=31)
    idx, dist = idx.numpy(), dist.numpy()
    j_idx, j_dist = np.asarray(j_idx), np.asarray(j_dist)
    assert idx.dtype == np.int32 and idx.shape == (len(pos), 31)
    assert np.all(np.diff(dist, axis=1) >= 0)
    if kind == "lattice":
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(dist, j_dist)
        return
    tol = _cancellation_tol(pos)
    assert np.all(np.abs(dist - j_dist) <= tol[:, None])
    assert _rows_differ_only_at_ties(idx, dist, j_idx, j_dist, tol) >= 0.95
    if kind == "few_members":   # the INF padding: the lowest invalid rows
        n_valid = int(valid.sum())
        assert (dist[:, n_valid:] == np.float32(INF)).all()
        assert (dist[:, :n_valid] < INF).all()
        np.testing.assert_array_equal(idx[:, n_valid:], j_idx[:, n_valid:])
        np.testing.assert_array_equal(
            idx[0, n_valid:], np.flatnonzero(~valid)[:31 - n_valid])


@pytest.mark.parametrize("cap", [2, 16])
def test_knn_grid_matches_jax_on_a_lattice(cap):
    """Exact distances: the candidate order (stable by cell, the 27 cells
    in loop order, each capped at ``cap`` slots), the tie rule and the INF
    padding's indices all equal the JAX package's."""
    pos, valid = _cloud("lattice")
    pos = pos * 0.5
    idx, dist = tnb.knn_grid(_t(pos), _t(valid), 0.5, k=31,
                             cell_capacity=cap)
    j_idx, j_dist = jnb.knn_grid(jnp.asarray(pos), jnp.asarray(valid), 0.5,
                                 k=31, cell_capacity=cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))
    if cap == 2:    # the duplicated points overflow their cells
        assert (dist.numpy() == np.float32(INF)).any()


def test_knn_grid_equals_bruteforce_without_overflow():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 8, (3000, 3)).astype(np.float32)
    valid = rng.random(3000) < 0.95
    g_idx, g_dist = tnb.knn_grid(_t(pos), _t(valid), 2.0, k=8,
                                 cell_capacity=64)
    b_idx, b_dist = tnb.knn_bruteforce(_t(pos), _t(valid), k=8)
    # no cell overflows its 64 slots, and the 8th neighbour is nearer than
    # a cell, so the grid sees every true neighbour
    assert float(b_dist.max()) < 4.0
    # the grid's distances are differences squared, the brute force's the
    # identity's
    tol = _cancellation_tol(pos)
    g_dist, b_dist = g_dist.numpy(), b_dist.numpy()
    assert np.all(np.abs(g_dist - b_dist) <= tol[:, None])
    assert _rows_differ_only_at_ties(g_idx.numpy(), g_dist, b_idx.numpy(),
                                     b_dist, tol) >= 0.95


def test_knn_grid_reduce_blocks_and_rows():
    """A reduction over query blocks equals the one over all rows at once,
    and querying some rows gives those rows' results."""
    pos, valid = _cloud("random")
    full = tnb.knn_grid(_t(pos), _t(valid), 0.5, k=31)
    rows = torch.arange(0, len(pos), 7)
    got = tnb.knn_grid_reduce(_t(pos), _t(valid), 0.5,
                              lambda i, d, nb: (i, d, nb), k=31, rows=rows)
    assert torch.equal(got[0], full[0][rows])
    assert torch.equal(got[1], full[1][rows])
    np.testing.assert_array_equal(
        got[2].numpy(), pos[full[0][rows].numpy()])


def test_neighbor_covariance_matches_jax():
    rng = np.random.default_rng(4)
    nbrs = (rng.normal(size=(500, 31, 3)) * [1, 3, 1] + [100, 5, -40]
            ).astype(np.float32)
    nv = rng.random((500, 31)) < 0.8
    nv[:5] = False                                  # no valid neighbour
    scale = float(np.abs(nbrs - nbrs.mean(1, keepdims=True)).max()) ** 2
    for w in (None, nv):
        got = tnb.neighbor_covariance_from(
            _t(nbrs), None if w is None else _t(w)).numpy()
        ref = np.asarray(jnb.neighbor_covariance_from(
            jnp.asarray(nbrs), None if w is None else jnp.asarray(w)))
        assert np.abs(got - ref).max() <= 1e-6 * scale
        np.testing.assert_array_equal(got, got.transpose(0, 2, 1))
    pos = nbrs.reshape(-1, 3)
    idx = rng.integers(0, len(pos), (400, 31)).astype(np.int32)
    got = tnb.neighbor_covariance(_t(pos), _t(idx), _t(nv[:400])).numpy()
    ref = np.asarray(jnb.neighbor_covariance(jnp.asarray(pos),
                                             jnp.asarray(idx),
                                             jnp.asarray(nv[:400])))
    assert np.abs(got - ref).max() <= 1e-6 * scale


# ---- the segmented scene --------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """One small segmentation by the port: points, ids, classes, table and
    the tree with the most crown points."""
    pts = tlas.synthetic_forest(n_trees=2, points_per_tree=3000,
                                ground_points=2000, seed=11)
    s = tpl.Session.from_points(pts, TCFG, device="cpu")
    s.segment(0.75)
    seg = s.cloud.segment.numpy()
    cls_ = s.cloud.classification.numpy()
    crown = [((seg == i) & (cls_ == CLASS_CROWN)).sum()
             for i in range(seg.max() + 1)]
    sid = int(np.argmax(crown[1:])) + 1
    return dict(pts=pts, segment=seg, classification=cls_,
                table=s.table.to_numpy(), sid=sid)


def _port_session(scene, cfg=TCFG):
    s = tpl.Session.from_points(scene["pts"], cfg, device="cpu")
    s.cloud = s.cloud.replace(segment=_t(scene["segment"]),
                              classification=_t(scene["classification"]))
    s.table = tch.SegmentTable.from_numpy(scene["table"], device="cpu")
    s._bbox_full = False
    return s


def _jax_session(scene, cfg=JCFG):
    s = jpl.Session.from_points(scene["pts"], cfg)
    s.cloud = s.cloud.replace(
        segment=jnp.asarray(scene["segment"]),
        classification=jnp.asarray(scene["classification"]))
    s.table = jch.SegmentTable(**{k: jnp.asarray(v)
                                  for k, v in scene["table"].items()})
    s._bbox_full = False
    return s


def _state(scene):
    s = _port_session(scene)
    c = s.cloud
    return c.pos, c.segment, c.valid, c.classification, s.table


def test_segment_properties_matches_jax(scene):
    pos, seg, valid, cls_, table = _state(scene)
    n_seg = SEG["max_segments"] + 1
    kernels.reset_launches()
    exp, hgt = tch.segment_properties(pos, seg, valid, cls_, table, n_seg)
    assert sum(kernels.launches().values()) == 0
    j_exp, j_hgt = jch.segment_properties(
        jnp.asarray(pos.numpy()), jnp.asarray(seg.numpy()),
        jnp.asarray(valid.numpy()), jnp.asarray(cls_.numpy()),
        jch.SegmentTable(**{k: jnp.asarray(v)
                            for k, v in scene["table"].items()}), n_seg)
    np.testing.assert_array_equal(hgt.numpy(), np.asarray(j_hgt))
    d = np.abs(exp.numpy() - np.asarray(j_exp))
    assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 1e-3
    exp, hgt = exp.numpy(), hgt.numpy()
    live = scene["segment"] > 0
    assert exp[live].max() > 0.5 and 0.0 <= hgt.min() and hgt.max() <= 1.0


def test_segment_properties_on_the_subset_equals_full(scene):
    """The focused view runs segment_properties on a segment's compacted
    rows: at the member rows it must equal the full cloud's values."""
    pos, seg, valid, cls_, table = _state(scene)
    n_seg = SEG["max_segments"] + 1
    full = tch.segment_properties(pos, seg, valid, cls_, table, n_seg)
    sid = scene["sid"]
    member = valid & (seg == sid)
    rows = torch.nonzero(member).flatten()
    pad = torch.cat([rows, torch.zeros(700, dtype=rows.dtype)])
    sub_member = torch.arange(len(pad)) < len(rows)
    sub = tch.segment_properties(pos[pad], seg[pad], sub_member, cls_[pad],
                                 table, n_seg)
    for f, s_ in zip(full, sub):
        assert torch.equal(s_[:len(rows)], f[rows])
        assert (s_[len(rows):] == 0).all()


@pytest.mark.parametrize("use_grid", [False, True])
def test_curvature_and_normals_match_jax(scene, use_grid):
    pos, seg, valid, _, _ = _state(scene)
    member = valid & (seg == scene["sid"])
    jp, jm = jnp.asarray(pos.numpy()), jnp.asarray(member.numpy())
    m = member.numpy()
    got = tch.segment_curvature(pos, member, use_grid=use_grid).numpy()
    ref = np.asarray(jch.segment_curvature(jp, jm, use_grid=use_grid))
    assert (got[~m] == 0).all() and got[m].max() > 0.1
    assert (np.abs(got - ref)[m] <= 1e-4).mean() >= 0.99
    nrm = tch.segment_normals(pos, member, use_grid=use_grid).numpy()
    j_nrm = np.asarray(jch.segment_normals(jp, jm, use_grid=use_grid))
    assert (nrm[~m] == [0.0, 1.0, 0.0]).all()
    assert (np.abs(nrm - j_nrm).max(axis=1)[m] <= 1e-4).mean() >= 0.99


# ---- single-tree axes, RBVs, traits --------------------------------------------

@pytest.mark.parametrize("algo", ["average", "lowhigh"])
def test_single_tree_axes_match_jax_and_the_batched_row(scene, algo):
    pos, seg, valid, cls_, _ = _state(scene)
    sid = scene["sid"]
    trunk = valid & (seg == sid) & (cls_ == CLASS_TRUNK)
    fn, jfn, bfn = ((tta.average_direction, jta.average_direction,
                     tta.batched_average_direction) if algo == "average" else
                    (tta.low_high_layer, jta.low_high_layer,
                     tta.batched_low_high_layer))
    got = fn(pos, trunk)
    ref = jfn(jnp.asarray(pos.numpy()), jnp.asarray(trunk.numpy()))
    assert bool(got.found) and bool(ref.found)
    for f in ("origin", "direction"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5)
    row = bfn(pos, trunk, seg, SEG["max_segments"] + 1)
    for f in ("origin", "direction"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(row, f)[sid].numpy(),
                                   rtol=1e-5, atol=1e-5)
    tf = tta.axis_transform(got).numpy()
    np.testing.assert_allclose(tf, np.asarray(jta.axis_transform(ref)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tta.axis_lines(got, 7.5).numpy(),
        np.asarray(jta.axis_lines(ref, 7.5)), rtol=1e-5, atol=1e-5)
    # no trunk point: not found, origin 0, vertical
    none = fn(pos, torch.zeros_like(trunk))
    assert not bool(none.found)
    assert none.direction.tolist() == [0.0, 1.0, 0.0]
    assert none.origin.tolist() == [0.0, 0.0, 0.0]


RBV_OPTIONS = [dict(), dict(method=1), dict(symmetric=True),
               dict(method=1, symmetric=True, axis=True), dict(axis=True)]


@pytest.mark.parametrize("opts", RBV_OPTIONS,
                         ids=["max", "mean", "symmetric", "mean_sym_axis",
                              "axis"])
def test_build_rbv_matches_jax(scene, opts):
    pos, seg, valid, cls_, _ = _state(scene)
    sid = scene["sid"]
    member = valid & (seg == sid)
    mask = member & (cls_ == CLASS_CROWN)
    kw = dict(slices=26, sectors=32, method=opts.get("method", 0),
              symmetric=opts.get("symmetric", False))
    jpos, jmask = jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy())
    if opts.get("axis"):
        j_axis = jta.average_direction(
            jpos, jnp.asarray((member & (cls_ == CLASS_TRUNK)).numpy()))
        jtf = jta.axis_transform(j_axis)
        kw_t, kw_j = dict(transform=_t(np.asarray(jtf))), dict(transform=jtf)
    else:
        kw_t, kw_j = {}, {}
    got = trbv.build_rbv(pos, mask, **kw, **kw_t)
    ref = jrbv.build_rbv(jpos, jmask, **kw, **kw_j)
    for f in ("center", "min_y", "slice_height", "transform"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6)
    rtol = 1e-6 if kw["method"] == 0 else 1e-5
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(ref.distances), rtol=rtol, atol=1e-6)
    assert (got.distances.numpy() > 0).mean() > 0.5
    np.testing.assert_allclose(
        trbv.rbv_lines(got), jrbv.rbv_lines(ref), rtol=1e-5, atol=1e-5)


def test_split_rbv_traits_and_landmarks_match_jax(scene):
    pos, seg, valid, cls_, _ = _state(scene)
    member = valid & (seg == scene["sid"])
    got = trbv.split_rbv(pos, cls_, member)
    ref = jrbv.split_rbv(jnp.asarray(pos.numpy()), jnp.asarray(cls_.numpy()),
                         jnp.asarray(member.numpy()))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.distances.numpy(),
                                   np.asarray(r.distances), rtol=1e-6,
                                   atol=1e-6)
        for interp in (False, True):
            np.testing.assert_allclose(
                trbv.landmarks(g, 0.25, interp).numpy(),
                np.asarray(jrbv.landmarks(r, 0.25, interp)), rtol=1e-5,
                atol=1e-5)
    tr = trbv.traits(*got)
    jtr = jrbv.traits(*ref)
    for k in trbv.TRAITS:
        np.testing.assert_allclose(float(getattr(tr, k)),
                                   float(getattr(jtr, k)), rtol=1e-5)
    assert float(tr.diameter_breast_height) > 0
    import json
    assert json.loads(tr.to_json()).keys() == json.loads(jtr.to_json()).keys()
    np.testing.assert_allclose(trbv.split_landmarks(*got),
                               jrbv.split_landmarks(*ref), rtol=1e-5,
                               atol=1e-5)


# ---- the crown hull -------------------------------------------------------------

@pytest.fixture
def _exact_jax_hull(monkeypatch):
    """The JAX package's ``convex_hull`` with ``exact=True`` wherever it is
    called (its own reduced hull is the 512 candidates' alone)."""
    orig = jhull.convex_hull
    monkeypatch.setattr(jhull, "convex_hull",
                        lambda pos, mask, **kw: orig(pos, mask,
                                                     **{**kw, "exact": True}))


@pytest.mark.parametrize("case", ["few", "exact", "reduced"])
def test_convex_hull_matches_jax(scene, case, _exact_jax_hull):
    pos, seg, valid, cls_, _ = _state(scene)
    mask = valid & (seg == scene["sid"]) & (cls_ == CLASS_CROWN)
    if case == "few":
        mask = mask & (torch.cumsum(mask.int(), 0) <= 9)
    else:
        assert int(mask.sum()) > 512    # the reduced route is taken
    kw = dict(exact=case == "exact")
    got = thull.convex_hull(pos, mask, **kw)
    ref = jhull.convex_hull(pos.numpy(), mask.numpy(), **kw)
    if case == "few":
        assert got is None and ref is None
        return
    assert got.area == pytest.approx(ref.area, rel=1e-6)
    assert got.volume == pytest.approx(ref.volume, rel=1e-6)
    np.testing.assert_array_equal(np.sort(got.point_ids),
                                  np.sort(ref.point_ids))
    assert got.vertices.dtype == np.float32 and got.faces.dtype == np.int32
    e = thull.hull_edges(got.faces)
    assert e.shape[1] == 2 and (e[:, 0] < e[:, 1]).all()
    if case == "reduced":
        dirs = thull._fibonacci_sphere(512)
        cand = thull.support_candidates(pos, mask, _t(dirs)).numpy()
        j_cand = np.asarray(jhull.support_candidates(
            jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()),
            jnp.asarray(dirs)))
        assert (cand == j_cand).mean() >= 0.99
        none = thull.support_candidates(pos, torch.zeros_like(mask), _t(dirs))
        assert (none == -1).all()


def test_geo_copy_is_byte_equal():
    """The port's geo.py is the JAX package's (which imports only math),
    byte for byte."""
    with open(os.path.join(REPO, "treee_tpu", "geo.py"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "treee_tpu_torch", "geo.py"), "rb") as f:
        assert f.read() == ref


# ---- the Session's focused view -------------------------------------------------

FOCUS_CAM = dict(distance=24.0, turn=(40.0, -60.0))


def _cams():
    jc = JCamera.orbital(distance=FOCUS_CAM["distance"]).rotate_orbital(
        *FOCUS_CAM["turn"])
    tc = TCamera.from_numpy(np.asarray(jc.transform), np.asarray(jc.offset),
                            jc.fov_y, jc.near, jc.far, device="cpu")
    return jc, tc


def test_session_focus_matches_jax(scene):
    ts, js = _port_session(scene), _jax_session(scene)
    sid = scene["sid"]
    for g, r in zip(ts.properties(), js.properties()):
        assert (np.abs(g.numpy() - np.asarray(r)) <= 1e-5).mean() >= 0.999
    m = (scene["segment"] == sid)
    c, jc_ = ts.curvature(sid).numpy(), np.asarray(js.curvature(sid))
    assert (np.abs(c - jc_)[m] <= 1e-4).mean() >= 0.99 and (c[~m] == 0).all()
    n, jn = ts.normals(sid).numpy(), np.asarray(js.normals(sid))
    assert (np.abs(n - jn).max(1)[m] <= 1e-4).mean() >= 0.99
    assert ts.segment_coords(sid) == pytest.approx(js.segment_coords(sid),
                                                   rel=1e-9)


def _frames_close(got, ref, min_share=MIN_FRAME_MATCH):
    assert got.dtype == np.uint8 and got.shape == ref.shape == (120, 160, 3)
    close = (np.abs(got.astype(int) - ref.astype(int)).max(-1) <= 1).mean()
    assert close >= min_share, close
    return close


# the hag display is held byte for byte against JAX op by op in
# tests/test_torch_rasters.py, beside the rasters it reads
FOCUS_VIEWS = {
    **{d: dict(display=d) for d in tpl.FOCUS_DISPLAYS if d != "hag"},
    "overlays_average_max": dict(show_hull=True, show_rbv=True,
                                 show_axis=True),
    "overlays_lowhigh_mean": dict(show_hull=True, show_rbv=True,
                                  show_axis=True, axis_algo="lowhigh",
                                  rbv_method="mean", rbv_symmetric=True,
                                  hull_include="tree", rbv_slices=8,
                                  rbv_sectors=16),
}


@pytest.mark.parametrize("view", sorted(FOCUS_VIEWS))
def test_render_focus_matches_jax(scene, view, _exact_jax_hull):
    ts, js = _port_session(scene), _jax_session(scene)
    jc, tc = _cams()
    ts.camera, js.camera = tc, jc
    kernels.reset_launches()
    got = ts.render_focus(scene["sid"], **FOCUS_VIEWS[view])
    assert sum(kernels.launches().values()) == 0
    share = _frames_close(got, js.render_focus(scene["sid"],
                                               **FOCUS_VIEWS[view]))
    bg = np.round(np.array(TRC().background) * 255).astype(int)
    assert (np.abs(got.astype(int) - bg).max(-1) > 3).mean() > 0.02
    print(f"render_focus {view}: {share:.5f} of pixels within 1")
    if view == "classification":
        with jax.disable_jit():
            ref = js.render_focus(scene["sid"], **FOCUS_VIEWS[view])
        np.testing.assert_array_equal(got, ref)


def test_render_focus_raises_for_later_slices(scene):
    """A source attribute is a display only where the scan carries it
    (tests/test_torch_ingest.py draws them); a session made from bare
    points has none, so its name is as unknown as any other."""
    ts = _port_session(scene)
    assert ts.attributes == {}
    with pytest.raises(ValueError, match="unknown display"):
        ts.render_focus(scene["sid"], display="intensity")
    with pytest.raises(ValueError, match="unknown display"):
        ts.render_focus(scene["sid"], display="bogus")


def test_focus_caches_reuse_and_invalidate(scene):
    """tests/test_focus_parity.py:310 and :338: the compaction and the
    brute-path results are cached and reused; an edit clears them, and the
    deleted segment's curvature drops to zero."""
    s = _port_session(scene)
    sid = scene["sid"]
    c1 = s.curvature(sid)
    member = (s.cloud.valid & (s.cloud.segment == sid)).numpy()
    assert (c1.numpy()[member] > 0).any()
    idx_cached = s._focus_idx_cache[sid][0]
    key = ("curve", sid, s.config.characteristics.neighbors)
    sub = s._focus_prop_cache[key]
    assert torch.equal(s.curvature(sid), c1)
    assert s._focus_idx_cache[sid][0] is idx_cached
    assert s._focus_prop_cache[key] is sub
    n1 = s.normals(sid)
    assert ("normals", sid, 31) in s._focus_prop_cache
    assert torch.equal(s.normals(sid), n1)
    center = s.cloud.pos.numpy()[member].mean(axis=0)
    s.delete_sphere(center, radius=1e6)
    assert sid not in s._focus_idx_cache and not s._focus_prop_cache
    assert not (s.curvature(sid) != 0).any()
    # segment() and characteristics() clear them too
    s = _port_session(scene)
    for redo in (s.characteristics, lambda: s.segment(0.75)):
        s.curvature(sid)
        redo()
        assert not (s._focus_idx_cache or s._focus_prop_cache
                    or s._focus_cnt_cache or s._focus_grid_cache)
        assert s._counts_np is None


def test_render_focus_subset_matches_full_render(scene):
    """tests/test_focus_parity.py:358: the brute path's frame, drawn from
    the compacted rows, equals the grid path's full-cloud frame
    (brute_force_max=0 routes every segment there)."""
    s_sub = _port_session(scene)
    s_full = _port_session(scene, dc.replace(
        TCFG, neighbors=TNC(brute_force_max=0)))
    sid = scene["sid"]
    for display in ("classification", "height", "expansion"):
        np.testing.assert_array_equal(
            s_sub.render_focus(sid, display=display),
            s_full.render_focus(sid, display=display), err_msg=display)
    kw = dict(show_hull=True, show_axis=True, show_rbv=True)
    a, b = s_sub.render_focus(sid, **kw), s_full.render_focus(sid, **kw)
    assert np.mean(np.any(a != b, axis=-1)) < 0.005


def test_focus_count_cache_and_eviction(scene):
    """tests/test_focus_parity.py:394: while the table is stale the member
    count syncs once per segment, then frames build no full-cloud mask; the
    caches are bounded LRU dicts."""
    s = _port_session(scene)
    sid = scene["sid"]
    s.delete_sphere(np.array([1e6, 1e6, 1e6], np.float32), radius=0.1)
    assert s._counts_stale and s._focus_cnt_cache == {}
    calls = []
    orig = s._member_mask
    s._member_mask = lambda i: calls.append(i) or orig(i)
    s.render_focus(sid, display="classification")
    assert sid in s._focus_cnt_cache and len(calls) >= 1
    first = len(calls)
    s.render_focus(sid, display="classification")
    assert len(calls) == first
    d = {i: i for i in range(100)}
    tpl._evict_oldest(d, 8)
    assert len(d) == 8 and list(d) == list(range(92, 100))
    assert tpl._lru_get(d, 92) == 92
    d[100] = 100
    tpl._evict_oldest(d, 8)
    assert 92 in d and 93 not in d


def test_render_focus_expansion_first_frame_matches_steady(scene):
    """tests/test_focus_parity.py:440: with no table, the first expansion
    frame settles characteristics() before it reads the classes."""
    s = _port_session(scene)
    s.table = None
    s._counts_np = None
    i1 = s.render_focus(scene["sid"], display="expansion")
    np.testing.assert_array_equal(
        i1, s.render_focus(scene["sid"], display="expansion"))


def test_focus_grid_path_caches_result(scene):
    """tests/test_focus_parity.py:460: grid-path results are cached per
    (kind, segment, k), and an edit clears them."""
    s = _port_session(scene, dc.replace(TCFG,
                                        neighbors=TNC(brute_force_max=0)))
    sid = scene["sid"]
    c1 = s.curvature(sid)
    key = ("curve", sid, 31)
    cached = s._focus_grid_cache[key]
    assert torch.equal(s.curvature(sid), c1)
    assert s._focus_grid_cache[key] is cached
    s.normals(sid)
    assert ("normals", sid, 31) in s._focus_grid_cache
    member = (s.cloud.valid & (s.cloud.segment == sid)).numpy()
    s.delete_sphere(s.cloud.pos.numpy()[member].mean(axis=0), radius=0.5)
    assert s._focus_grid_cache == {}


def test_curvature_routing_survives_combine(scene):
    """tests/test_app.py:380: after combine() the brute-vs-grid routing
    uses a fresh member count, not the table's stale one."""
    counts = scene["table"]["count"]
    present = np.flatnonzero(counts > 0)
    big = int(present[np.argmax(counts[present])])
    small = int(present[np.argmin(counts[present])])
    limit = int(counts[small]) + 1
    s = _port_session(scene, dc.replace(
        TCFG, neighbors=TNC(brute_force_max=limit)))
    s.characteristics()
    seen = []
    real = tch.segment_curvature

    def spy(pos, member, k=31, use_grid=False, **kw):
        seen.append(use_grid)
        return real(pos, member, k=k, use_grid=use_grid, **kw)

    tch.segment_curvature = spy
    try:
        s.curvature(small)
        assert seen == [False]
        s.combine(big, small)
        s.curvature(small)
        assert seen == [False, True]
    finally:
        tch.segment_curvature = real
