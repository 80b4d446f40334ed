"""Multi-epoch change detection: per-tree growth and stand deltas.

The port's copy of ``treee_tpu/change.py``: the same host functions, which
read the port's sessions, on one device or over a mesh, through their own
live bounds and rasters (``Session._live_bounds``, ``_raster_grids``).

A treee-tpu addition beyond the reference (which has no multi-epoch
product; its whole surface is one scan at a time,
treee/src/program.rs:138-144): forest monitoring re-scans the same stand
every few years and asks which trees grew, died, or appeared, and how the
stand totals moved.

Everything here runs on the host over the *inventory tables*
(:meth:`treee_tpu_torch.pipeline.Session.inventory`) — the expensive [N]-point
work already happened in the batched device pass, and the remaining
matching problem is tree-count-sized (an ``S_a x S_b`` distance matrix in
numpy), where device dispatch overhead would dominate.  The CHM change
raster reuses the device raster path (:func:`rasters.compute_rasters`) on
a shared map-frame grid so the two epochs subtract cell-for-cell.

Matching is by stem map position (easting/northing — the absolute LAS map
frame, so two sessions with different load-time recenter offsets still
align): mutual nearest neighbours within ``max_dist`` metres.  Mutual-NN
is deterministic and order-free, the same design choice as the band
tracker in segmentation.py (vs the reference's hash-order greedy loop,
segmenting.rs:485-523).
"""

from __future__ import annotations

import numpy as np

#: traits reported as per-tree deltas, in output column order
DELTA_TRAITS = (
    "tree_height", "trunk_height", "crown_height",
    "diameter_breast_height", "crown_diameter", "crown_projected_area",
    "crown_volume", "crown_surface", "stem_volume", "wood_volume",
    "n_points",
)

from .rasters import NODATA  # single source of truth for raster holes


def _positions(inv: dict) -> np.ndarray:
    """Stem map positions [S, 2] — trunk-axis origins when the inventory
    carries them (bbox centers drift with the Voronoi-assigned ground area
    around each tree; stems don't), else the plain easting/northing."""
    e = inv.get("stem_easting", inv["easting"])
    n = inv.get("stem_northing", inv["northing"])
    return np.stack(
        [np.asarray(e, np.float64), np.asarray(n, np.float64)], axis=1,
    )


def match_trees(inv_a: dict, inv_b: dict, max_dist: float = 2.0):
    """Match inventory rows between two epochs by stem position.

    Mutual nearest neighbour within ``max_dist`` m in the map frame.
    Returns ``(ia, ib, lost, new)`` — matched row indices into ``inv_a`` /
    ``inv_b``, rows of ``inv_a`` with no partner (mortality / removals),
    and rows of ``inv_b`` with no partner (ingrowth / new detections).
    """
    pa, pb = _positions(inv_a), _positions(inv_b)
    na, nb = len(pa), len(pb)
    if na == 0 or nb == 0:
        e = np.zeros(0, np.int64)
        return e, e, np.arange(na), np.arange(nb)
    d2 = ((pa[:, None, :] - pb[None, :, :]) ** 2).sum(axis=-1)
    nn_ab = d2.argmin(axis=1)
    nn_ba = d2.argmin(axis=0)
    ia = np.arange(na)
    mutual = (nn_ba[nn_ab] == ia) & (
        d2[ia, nn_ab] <= float(max_dist) ** 2
    )
    ia_m = ia[mutual]
    ib_m = nn_ab[mutual]
    lost = np.setdiff1d(ia, ia_m, assume_unique=True)
    new = np.setdiff1d(np.arange(nb), ib_m)
    return ia_m, ib_m, lost, new


def _subset(inv: dict, idx: np.ndarray) -> dict:
    return {k: np.asarray(v)[idx] for k, v in inv.items()}


def _tree_rows(inv: dict) -> np.ndarray:
    if "n_trunk" in inv:
        return np.flatnonzero(np.asarray(inv["n_trunk"]) > 0)
    return np.arange(len(np.asarray(inv["segment"])))


def tree_changes(inv_a: dict, inv_b: dict, max_dist: float = 2.0,
                 trees_only: bool = True) -> dict:
    """Per-tree change tables between two epochs.

    Returns ``{"matched": table, "lost": table, "new": table}``.  The
    matched table has one row per surviving tree: both epochs' segment
    ids, the epoch-b stem position, the horizontal stem drift, and for
    every trait in :data:`DELTA_TRAITS` the epoch-a value plus its delta
    (``delta_x = x_b - x_a``; positive = growth).  ``lost`` / ``new`` are
    the full unmatched inventory rows of the respective epoch.

    ``trees_only`` (default) restricts both inventories to trunk-bearing
    rows first: segments without trunk points are ground/understory
    Voronoi artifacts whose extents are epoch-unstable, and reporting them
    as "lost"/"new" would drown the mortality/ingrowth signal.
    """
    if trees_only:
        inv_a = _subset(inv_a, _tree_rows(inv_a))
        inv_b = _subset(inv_b, _tree_rows(inv_b))
    ia, ib, lost, new = match_trees(inv_a, inv_b, max_dist)
    a, b = _subset(inv_a, ia), _subset(inv_b, ib)
    pa, pb = _positions(a), _positions(b)
    matched: dict[str, np.ndarray] = {
        "segment_a": a["segment"].astype(np.int32),
        "segment_b": b["segment"].astype(np.int32),
        "easting": pb[:, 0],
        "northing": pb[:, 1],
        # stem drift, from the same positions the matching used
        "moved": np.hypot(pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]),
    }
    for t in DELTA_TRAITS:
        va = np.asarray(a[t], np.float64)
        vb = np.asarray(b[t], np.float64)
        matched[f"{t}_a"] = va
        matched[f"delta_{t}"] = vb - va
    return {
        "matched": matched,
        "lost": _subset(inv_a, lost),
        "new": _subset(inv_b, new),
    }


def stand_changes(summary_a: dict, summary_b: dict) -> dict:
    """Stand-level deltas between two :meth:`Session.forest_summary` dicts.

    ``{key: {"a": v_a, "b": v_b, "delta": v_b - v_a}}`` for every numeric
    key the two summaries share.
    """
    out = {}
    for k, va in summary_a.items():
        vb = summary_b.get(k)
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            out[k] = {"a": va, "b": vb, "delta": vb - va}
    return out


def _map_bounds(session) -> tuple[float, float, float, float]:
    """Live-point bounds of a session in the LAS map frame.

    Returns (e_lo, e_hi, n_lo, n_hi).  easting = x + off_x and
    northing = -(z + off_z) (the io/las.py load swizzle), so the northing
    interval comes from the *negated* z interval.
    """
    _, lo, hi = session._live_bounds()
    off = session.world_offset
    e_lo, e_hi = float(lo[0] + off[0]), float(hi[0] + off[0])
    n_lo, n_hi = float(-(hi[2] + off[2])), float(-(lo[2] + off[2]))
    return e_lo, e_hi, n_lo, n_hi


def chm_change(session_a, session_b, cell: float = 0.5, cap: int = 4096):
    """Canopy-height change raster between two epochs of the same stand.

    Rasterizes both sessions' CHMs over the UNION of their map-frame
    extents with one shared grid, so cells subtract in place even when the
    two scans were recentered with different world offsets (CHM = DSM−DTM
    is itself elevation-offset-free).  Returns ``(diff f32[rows, cols],
    (xll, yll), cell)`` with ``diff = chm_b − chm_a`` where both epochs
    have returns and :data:`NODATA` elsewhere — ready for
    :func:`io.exports.save_ascii_grid`.
    """
    ea = _map_bounds(session_a)
    eb = _map_bounds(session_b)
    e_lo, e_hi = min(ea[0], eb[0]), max(ea[1], eb[1])
    n_lo, n_hi = min(ea[2], eb[2]), max(ea[3], eb[3])

    grids = []
    shape = None
    for s in (session_a, session_b):
        off = s.world_offset
        # shared map box -> this session's local frame (z = -n - off_z)
        lo = np.array([e_lo - off[0], 0.0, -n_hi - off[2]])
        hi = np.array([e_hi - off[0], 0.0, -n_lo - off[2]])
        g, (rows, cols), out_cell = s._raster_grids(lo, hi, cell, cap=cap)
        # identical box + cell + cap on both passes => identical dims/cell
        # (hard error, not assert: -O must not turn a future divergence
        # into a silently misaligned subtraction)
        if shape is not None and shape != (rows, cols, out_cell):
            raise RuntimeError(
                f"chm_change: raster dims diverged between epochs: "
                f"{shape} vs {(rows, cols, out_cell)}"
            )
        shape = (rows, cols, out_cell)
        grids.append(g["chm"])
    rows, cols, out_cell = shape
    a, b = grids
    both = (a != NODATA) & (b != NODATA)
    diff = np.where(both, b - a, NODATA).astype(np.float32)
    xll = e_lo
    yll = n_hi - rows * out_cell
    return diff, (xll, yll), out_cell
