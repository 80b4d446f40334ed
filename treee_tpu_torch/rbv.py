"""Radial bounding volumes (RBVs) and forestry traits of every segment at
once, the PyTorch port of the batched functions of ``treee_tpu/rbv.py``
(treee/src/interactive/hull.rs:631-995).

Each segment's crown and trunk points move into the segment's trunk-axis
frame and are binned into ``slices`` x ``sectors`` cells around the axis;
a cell holds the largest (``METHOD_MAX``) or mean (``METHOD_MEAN``) radial
distance of its points, optionally symmetrized across the axis.  The traits
(DBH, crown diameter, projected area, volume and surface, stem and wood
volume) follow from the grids.

One stable sort by (segment, class) puts every segment's rows together.  The
axis frames and the grids' (min y, slice height) reach the rows through run
fills (one run-start scatter, then the CUDA kernel ``segmented_cummax``),
and each grid's y extent is a run reduction by the same kernel.  The max
grid is an f32 scatter-max, which takes no order.  The mean grid's sums
are not scattered with float atomics: the rows are sorted by cell and summed
by the CUDA kernel ``segmented_cumsum``, so they repeat bit for bit on the
card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .cloud import CLASS_CROWN, CLASS_TRUNK
from .ops import kernels
from .ops.kernels.dilate import full
from .ops.sums import sums_by_key

INF = 3.0e38

METHOD_MAX = 0
METHOD_MEAN = 1

TRAITS = ("diameter_breast_height", "trunk_cross_area", "crown_diameter",
          "crown_projected_area", "crown_volume", "crown_surface",
          "stem_volume", "wood_volume")


@dataclasses.dataclass
class Traits:
    """Forestry traits (hull.rs:998-1008), one row per segment."""

    diameter_breast_height: torch.Tensor
    trunk_cross_area: torch.Tensor
    crown_diameter: torch.Tensor
    crown_projected_area: torch.Tensor
    crown_volume: torch.Tensor
    crown_surface: torch.Tensor
    stem_volume: torch.Tensor
    wood_volume: torch.Tensor


@dataclasses.dataclass
class BatchedRBV:
    """RBVs of every segment, [S]-leading, in each segment's axis frame."""

    min_y: torch.Tensor         # f32[S]
    slice_height: torch.Tensor  # f32[S]
    distances: torch.Tensor     # f32[S, slices*sectors]
    slices: int
    sectors: int


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python number ``b``, rounded once as IEEE and XLA
    divide (see ``dilate.full``)."""
    return torch.div(a, full(b, a))


def run_fill(key_s, left, right, table: torch.Tensor) -> torch.Tensor:
    """Each sorted row's segment row of ``table`` f32[S,C], f32[N,C]: the
    table rows are set at their runs' first rows (empty runs go to the drop
    row N), and a segmented cummax carries them down each run.  Rows of keys
    outside [0, S) get -INF."""
    n = key_s.shape[0]
    tgt = torch.where(left < right, left, n)
    start = torch.full((n + 1, table.shape[1]), -INF, dtype=torch.float32,
                       device=key_s.device)
    start[tgt] = table
    return kernels.segmented_cummax(key_s, start[:n])


def _sorted_extents(key_s, left, right, y, sels):
    """Per-segment (min y, max y) under each selection: one segmented cummax
    over [N, 2 per selection] read at each run's end; +INF / -INF where a
    segment has no row, or no selected row."""
    n = key_s.shape[0]
    cols = []
    for sel in sels:
        cols += [torch.where(sel, -y, -INF), torch.where(sel, y, -INF)]
    scan = kernels.segmented_cummax(key_s, torch.stack(cols, dim=1))
    has = right > left
    picked = scan[torch.clamp(right - 1, 0, n - 1)]
    return [(torch.where(has, -picked[:, 2 * k], INF),
             torch.where(has, picked[:, 2 * k + 1], -INF))
            for k in range(len(sels))]


def _grid(key_s, x, z, y, sel, min_y, max_y, n_segments, slices, sectors,
          method, symmetric, per_pt) -> BatchedRBV:
    """One grid over the segment-sorted rows; ``per_pt`` holds each row's
    segment (min y, slice height)."""
    any_pt = min_y < INF
    min_y = torch.where(any_pt, min_y, 0.0)
    max_y = torch.where(any_pt, max_y, 1.0)
    slice_h = torch.clamp(div(max_y - min_y, slices), min=1e-6)

    si = torch.clamp(((y - per_pt[:, 0]) / per_pt[:, 1]).to(torch.int32),
                     0, slices - 1)
    dist = torch.sqrt(x * x + z * z)
    sector_angle = 2.0 * math.pi / sectors
    ang = torch.atan2(z, x) + 2.0 * math.pi
    sec = torch.clamp(torch.remainder(div(ang, sector_angle), sectors)
                      .to(torch.int32), 0, sectors - 1)
    cells = slices * sectors
    size = n_segments * cells
    bucket = torch.where(sel, key_s * cells + si * sectors + sec, size)
    if method == METHOD_MAX:
        d = torch.zeros(size + 1, dtype=torch.float32, device=x.device)
        d.scatter_reduce_(0, bucket.long(), torch.where(sel, dist, 0.0),
                          "amax")
        d = d[:size]
    else:
        tab = sums_by_key(bucket, torch.stack([dist, torch.ones_like(dist)],
                                              dim=1), size)
        d = tab[:, 0] / torch.clamp(tab[:, 1], min=1.0)
    if symmetric and sectors % 2 == 0:
        dg = d.view(n_segments, slices, sectors)
        half = sectors // 2
        avg = div(dg[:, :, :half] + dg[:, :, half:], 2.0)
        d = torch.cat([avg, avg], dim=2)
    return BatchedRBV(min_y=min_y, slice_height=slice_h,
                      distances=d.reshape(n_segments, cells),
                      slices=slices, sectors=sectors)


def batched_split_rbv(pos: torch.Tensor, classification: torch.Tensor,
                      mask: torch.Tensor, segment: torch.Tensor,
                      n_segments: int, transforms: torch.Tensor,
                      crown_slices: int = 26, crown_sectors: int = 32,
                      trunk_slices: int = 5, trunk_sectors: int = 32,
                      method: int = METHOD_MAX, symmetric: bool = False,
                      ) -> tuple[BatchedRBV, BatchedRBV]:
    """Crown and trunk RBVs of every segment (hull.rs:185-208 split),
    through the segments' axis frames ``transforms`` f32[S,4,4]."""
    segc = torch.clamp(segment, 0, n_segments).to(torch.int32)
    # class + 1 in the key's low two bits, 0 for rows outside the mask
    meta = torch.where(mask, classification + 1, 0).to(torch.int32)
    key2_s, order = torch.sort((segc << 2) | meta, stable=True)
    x0, y0, z0 = pos[order, 0], pos[order, 1], pos[order, 2]
    key_s = key2_s >> 2
    meta_s = key2_s & 3
    q = torch.arange(n_segments + 1, dtype=torch.int32, device=pos.device) << 2
    bounds = torch.searchsorted(key2_s, q, side="left")
    left, right = bounds[:-1], bounds[1:]

    comp = [(0, 3), (1, 3), (2, 3), (0, 0), (1, 0), (2, 0),
            (0, 1), (1, 1), (2, 1), (0, 2), (1, 2), (2, 2)]
    table = torch.stack([transforms[:, i, j] for i, j in comp], dim=1)
    tf = run_fill(key_s, left, right, table)
    px = x0 - tf[:, 0]
    py = y0 - tf[:, 1]
    pz = z0 - tf[:, 2]
    # (pos - t) @ R, R the frame's orthonormal columns
    x = px * tf[:, 3] + py * tf[:, 4] + pz * tf[:, 5]
    y = px * tf[:, 6] + py * tf[:, 7] + pz * tf[:, 8]
    z = px * tf[:, 9] + py * tf[:, 10] + pz * tf[:, 11]

    sel_c = meta_s == CLASS_CROWN + 1
    sel_t = meta_s == CLASS_TRUNK + 1
    (cmn, cmx), (tmn, tmx) = _sorted_extents(key_s, left, right, y,
                                             (sel_c, sel_t))

    def finalize(mn, mx, slices):
        any_pt = mn < INF
        mn_f = torch.where(any_pt, mn, 0.0)
        mx_f = torch.where(any_pt, mx, 1.0)
        return mn_f, torch.clamp(div(mx_f - mn_f, slices), min=1e-6)

    per4 = run_fill(key_s, left, right, torch.stack(
        [*finalize(cmn, cmx, crown_slices), *finalize(tmn, tmx, trunk_slices)],
        dim=1))
    crown = _grid(key_s, x, z, y, sel_c, cmn, cmx, n_segments, crown_slices,
                  crown_sectors, method, symmetric, per4[:, 0:2])
    trunk = _grid(key_s, x, z, y, sel_t, tmn, tmx, n_segments, trunk_slices,
                  trunk_sectors, method, symmetric, per4[:, 2:4])
    return crown, trunk


def batched_traits(crown: BatchedRBV, trunk: BatchedRBV) -> Traits:
    """Traits of every segment (hull.rs:926-995 formulas)."""
    t_s, t_k = trunk.slices, trunk.sectors
    c_s, c_k = crown.slices, crown.sectors
    n = crown.min_y.shape[0]
    trunk_height = trunk.slice_height * t_s
    height = crown.min_y + crown.slice_height * c_s - trunk.min_y

    # DBH: twice the mean distance of the trunk slice at 1.3 m
    sl = torch.clamp(torch.div(full(1.3, trunk.slice_height),
                               trunk.slice_height).to(torch.int32),
                     0, t_s - 1)
    td = trunk.distances.view(n, t_s, t_k)
    dbh_slice = torch.gather(td, 1, sl.long()[:, None, None].expand(n, 1, t_k))
    dbh = div(dbh_slice[:, 0, :].sum(dim=-1) * 2.0, t_k)
    half = div(dbh, 2.0)
    trunk_cross_area = math.pi * (half * half)

    cd = crown.distances.view(n, c_s, c_k)
    sector_max = cd.amax(dim=1)
    crown_sum = cd.sum(dim=(1, 2))
    crown_diameter = div(sector_max.sum(dim=-1) * 2.0, c_k)
    crown_projected_area = div((sector_max * sector_max).sum(dim=-1)
                               * math.pi, c_k)
    crown_volume = div((cd * cd).sum(dim=(1, 2)) * math.pi
                       * crown.slice_height, c_k)
    crown_surface = (2.0 * crown_projected_area
                     + div(2.0 * math.pi * crown.slice_height, c_k)
                     * crown_sum)
    stem_volume = trunk_cross_area * (
        trunk_height + div(height - trunk_height, 3.0))
    wood_volume = stem_volume + div(trunk_cross_area, c_s * c_k) * crown_sum
    return Traits(
        diameter_breast_height=dbh, trunk_cross_area=trunk_cross_area,
        crown_diameter=crown_diameter,
        crown_projected_area=crown_projected_area, crown_volume=crown_volume,
        crown_surface=crown_surface, stem_volume=stem_volume,
        wood_volume=wood_volume)
