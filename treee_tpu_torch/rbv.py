"""Radial bounding volumes (RBVs) and forestry traits, the PyTorch port of
``treee_tpu/rbv.py`` (treee/src/interactive/hull.rs:631-995): of one
focused tree (``build_rbv``, ``split_rbv``, ``traits``, ``landmarks``,
``rbv_lines``, ``split_landmarks``) and of every segment at once (the
batched forms).

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
card.  ``batched_split_rbv_shard`` is the same sequence as a shard program
(``parallel/sharding.py``): the extents and max grids combine over shards
by a min and a max (exact), the mean grids' sums and counts by one sum.
``inventory_shard`` is the whole inventory's device part as one program:
every segment's trunk axis (``trunk_axis``), split RBVs, traits and class
counts.

A single tree's RBV is centred on its axis frame when one is given, else on
the midpoint of two farthest points (p farthest from the (x, z) centroid, q
farthest from p: the parallel stand-in for the reference's Ritter pass,
hull.rs:707-726).  Its max grid is a scatter-max; its mean grid's sums are
``ordered_sums`` (row order on the CPU, as XLA's scatter-add; sorted and
scanned on the card).  ``atan2`` may differ between devices in the last
bit, which moves a point across a sector edge only where it lies on one.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

import torch

from . import trunk_axis
from .cloud import CLASS_CROWN, CLASS_TRUNK, DELETED_SEGMENT
from .ops import kernels
from .ops.f32 import div, full
from .ops.sums import ordered_sums, sums_by_key
from .parallel.program import run_alone
from .utils.profiling import waited

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

    def to_json(self) -> str:
        """One tree's traits as a JSON object of floats."""
        return json.dumps({k: float(getattr(self, k)) for k in TRAITS},
                          indent=2)


@dataclasses.dataclass
class RadialBoundingVolume:
    """One tree's distance grid and cylinder frame (hull.rs:631-645)."""

    center: torch.Tensor        # f32[2] (x, z) in axis space
    min_y: torch.Tensor         # f32 cylinder base height
    slice_height: torch.Tensor  # f32
    distances: torch.Tensor     # f32[slices * sectors]
    transform: torch.Tensor     # f32[4,4] axis frame (identity when untilted)
    slices: int
    sectors: int


@dataclasses.dataclass
class BatchedRBV:
    """RBVs of every segment, [S]-leading, in each segment's axis frame."""

    min_y: torch.Tensor         # f32[S]
    slice_height: torch.Tensor  # f32[S]
    distances: torch.Tensor     # f32[S, slices*sectors]
    slices: int
    sectors: int


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
          method, symmetric, per_pt, across: bool):
    """Shard program -> one grid over the segment-sorted rows; ``per_pt``
    holds each row's segment (min y, slice height).  Over shards the max
    grid takes a max (exact), the mean grid's sums and counts one sum."""
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
        if across:
            d = yield "max", d
    else:
        tab = sums_by_key(bucket, torch.stack([dist, torch.ones_like(dist)],
                                              dim=1), size)
        if across:
            tab = yield "sum", tab
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
    return run_alone(batched_split_rbv_shard(
        pos, classification, mask, segment, n_segments, transforms,
        crown_slices, crown_sectors, trunk_slices, trunk_sectors, method,
        symmetric, across=False))


def batched_split_rbv_shard(pos, classification, mask, segment,
                            n_segments: int, transforms, crown_slices: int,
                            crown_sectors: int, trunk_slices: int,
                            trunk_sectors: int, method: int, symmetric: bool,
                            across: bool):
    """:func:`batched_split_rbv` as a shard program: over shards the grids'
    y extents take a min and a max, the grids as in :func:`_grid`."""
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
    tf = trunk_axis.run_fill(key_s, left, right, table)
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
    if across:
        cmn, tmn = (yield "min", torch.stack([cmn, tmn]))
        cmx, tmx = (yield "max", torch.stack([cmx, tmx]))

    def finalize(mn, mx, slices):
        any_pt = mn < INF
        mn_f = torch.where(any_pt, mn, 0.0)
        mx_f = torch.where(any_pt, mx, 1.0)
        return mn_f, torch.clamp(div(mx_f - mn_f, slices), min=1e-6)

    per4 = trunk_axis.run_fill(key_s, left, right, torch.stack(
        [*finalize(cmn, cmx, crown_slices), *finalize(tmn, tmx, trunk_slices)],
        dim=1))
    crown = yield from _grid(key_s, x, z, y, sel_c, cmn, cmx, n_segments,
                             crown_slices, crown_sectors, method, symmetric,
                             per4[:, 0:2], across)
    trunk = yield from _grid(key_s, x, z, y, sel_t, tmn, tmx, n_segments,
                             trunk_slices, trunk_sectors, method, symmetric,
                             per4[:, 2:4], across)
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


def segment_class_counts(segment, classification, mask,
                         n_segments: int) -> torch.Tensor:
    """i32[S,3] point counts per (segment, ground/trunk/crown class)."""
    t = torch.where(mask, segment * 3 + torch.clamp(classification, 0, 2),
                    n_segments * 3)
    counts = torch.zeros(n_segments * 3 + 1, dtype=torch.int32,
                         device=segment.device)
    counts.index_add_(0, t.long(), torch.ones_like(t, dtype=torch.int32))
    return counts[:-1].view(n_segments, 3)


def inventory_shard(pos, segment, classification, valid, n_segments: int,
                    method: int, symmetric: bool, axis_algo: str,
                    rbv_kw: dict, across: bool):
    """The inventory's device part as a shard program
    (``parallel/program.py``) -> (Traits, counts i32[S,3], axes' found and
    origin): every segment's trunk axis, split RBVs, traits and class
    counts.  ``Session.inventory`` runs it alone or over the shards
    (``sharding.sharded_inventory``); the counts add across shards."""
    live = (valid & (segment != DELETED_SEGMENT) & (segment >= 0)
            & (segment < n_segments))
    trunk = live & (classification == CLASS_TRUNK)
    if axis_algo == "lowhigh":
        axes = yield from trunk_axis.batched_low_high_layer_shard(
            pos, trunk, segment, n_segments, 1.0, across)
    else:
        axes = yield from trunk_axis.batched_average_direction_shard(
            pos, trunk, segment, n_segments, 10, across)
    transforms = trunk_axis.batched_axis_transform(axes)
    crown, trunk_rbv = yield from batched_split_rbv_shard(
        pos, classification, live, segment, n_segments, transforms,
        rbv_kw.get("crown_slices", 26), rbv_kw.get("crown_sectors", 32),
        rbv_kw.get("trunk_slices", 5), rbv_kw.get("trunk_sectors", 32),
        method, symmetric, across)
    counts = segment_class_counts(segment, classification, live, n_segments)
    if across:
        counts = yield "sum", counts
    return (batched_traits(crown, trunk_rbv), counts, axes.found,
            axes.origin)


def _apply_inverse(tf: torch.Tensor, pos: torch.Tensor):
    """(x, y, z) of ``(pos - t) @ R`` for the rigid frame ``tf`` f32[4,4]
    (R^-1 = R^T), as f32 products and adds, not a matrix multiply."""
    p = pos - tf[:3, 3]
    return [(p[:, 0] * tf[0, j] + p[:, 1] * tf[1, j]) + p[:, 2] * tf[2, j]
            for j in range(3)]


def build_rbv(pos: torch.Tensor, mask: torch.Tensor, slices: int = 8,
              sectors: int = 8, method: int = METHOD_MAX,
              symmetric: bool = False,
              transform: torch.Tensor | None = None) -> RadialBoundingVolume:
    """The RBV of the masked points (hull.rs:656-858), in the axis frame
    ``transform`` (centred on the axis) or untilted (centred on the two
    farthest points' midpoint)."""
    dev = pos.device
    tf = (transform if transform is not None
          else torch.eye(4, dtype=torch.float32, device=dev))
    x, y, z = _apply_inverse(tf, pos)
    any_pt = mask.any()
    min_y = torch.where(any_pt, torch.where(mask, y, INF).amin(), 0.0)
    max_y = torch.where(any_pt, torch.where(mask, y, -INF).amax(), 1.0)

    if transform is not None:
        center = torch.zeros(2, dtype=torch.float32, device=dev)
    else:
        xz = torch.stack([x, z], dim=-1)
        n = torch.clamp(mask.float().sum(), min=1.0)
        centroid = torch.div(torch.where(mask[:, None], xz, 0.0).sum(dim=0),
                             n)

        def farthest_from(c):
            d = xz - c
            return xz[torch.argmax(torch.where(
                mask, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1], -1.0))]

        pa = farthest_from(centroid)
        pb = farthest_from(pa)
        center = torch.where(any_pt, div(pa + pb, 2.0), 0.0)

    slice_h = torch.clamp(div(max_y - min_y, slices), min=1e-6)
    sector_angle = 2.0 * math.pi / sectors
    si = torch.clamp(torch.div(y - min_y, slice_h).to(torch.int32), 0,
                     slices - 1)
    dx = x - center[0]
    dz = z - center[1]
    dist = torch.sqrt(dx * dx + dz * dz)
    ang = torch.atan2(dz, dx) + 2.0 * math.pi
    sec = torch.clamp(torch.remainder(div(ang, sector_angle), sectors)
                      .to(torch.int32), 0, sectors - 1)
    cells = slices * sectors
    bucket = torch.where(mask, si * sectors + sec, cells)
    if method == METHOD_MAX:
        d = torch.zeros(cells + 1, dtype=torch.float32, device=dev)
        d.scatter_reduce_(0, bucket.long(), torch.where(mask, dist, 0.0),
                          "amax")
        d = d[:cells]
    else:
        tab = ordered_sums(bucket, torch.stack(
            [torch.where(mask, dist, 0.0), mask.float()], dim=1), cells)
        d = torch.div(tab[:, 0], torch.clamp(tab[:, 1], min=1.0))
    if symmetric and sectors % 2 == 0:
        dg = d.view(slices, sectors)
        half = sectors // 2
        avg = div(dg[:, :half] + dg[:, half:], 2.0)
        d = torch.cat([avg, avg], dim=1).reshape(-1)
    return RadialBoundingVolume(center=center, min_y=min_y,
                                slice_height=slice_h, distances=d,
                                transform=tf, slices=slices, sectors=sectors)


def landmarks(rbv: RadialBoundingVolume, base,
              interpolate_height: bool) -> torch.Tensor:
    """Characteristic points, flat f32[slices*sectors*3] (hull.rs:880-904),
    as [cos*d, sin*d, height] with the height third: the reference's
    landmark text format, not the y-up convention.  ``interpolate_height``
    spreads the layers over 0..1 (Ground/NoCrown volumes, hull.rs:891-898)
    where the others take mid-slice (0.5)."""
    s, k = rbv.slices, rbv.sectors
    dev = rbv.distances.device
    sector_angle = 2.0 * math.pi / k
    si = torch.arange(s, dtype=torch.float32, device=dev).repeat_interleave(k)
    ki = torch.arange(k, dtype=torch.float32, device=dev).repeat(s)
    ang = (ki + 0.5) * sector_angle
    d = rbv.distances
    off = div(si, max(s - 1, 1)) if interpolate_height else 0.5
    yy = base + (si + off) * rbv.slice_height
    return torch.stack([torch.cos(ang) * d, torch.sin(ang) * d, yy],
                       dim=-1).reshape(-1)


def traits(crown: RadialBoundingVolume,
           trunk: RadialBoundingVolume) -> Traits:
    """One tree's traits from its split RBV (hull.rs:926-995 formulas):
    :func:`batched_traits` of one row."""
    def row(r):
        return BatchedRBV(min_y=r.min_y[None],
                          slice_height=r.slice_height[None],
                          distances=r.distances[None], slices=r.slices,
                          sectors=r.sectors)

    tr = batched_traits(row(crown), row(trunk))
    return Traits(**{k: getattr(tr, k)[0] for k in TRAITS})


def split_rbv(pos: torch.Tensor, classification: torch.Tensor,
              mask: torch.Tensor, transform: torch.Tensor | None = None,
              crown_slices: int = 26, crown_sectors: int = 32,
              trunk_slices: int = 5, trunk_sectors: int = 32,
              method: int = METHOD_MAX, symmetric: bool = False,
              ) -> tuple[RadialBoundingVolume, RadialBoundingVolume]:
    """Crown 26x32 + trunk 5x32 split (hull.rs:185-208 defaults); ``method``
    and ``symmetric`` are the reference's RBV widgets (hull.rs:248-285)."""
    crown = build_rbv(pos, mask & (classification == CLASS_CROWN),
                      slices=crown_slices, sectors=crown_sectors,
                      transform=transform, method=method, symmetric=symmetric)
    trunk = build_rbv(pos, mask & (classification == CLASS_TRUNK),
                      slices=trunk_slices, sectors=trunk_sectors,
                      transform=transform, method=method, symmetric=symmetric)
    return crown, trunk


def rbv_lines(rbv: RadialBoundingVolume, arc_detail: int = 4) -> np.ndarray:
    """Wireframe cage endpoints f32[L,2,3] (hull.rs:780-841 geometry), on
    the host.

    Per slice the centre vertical, then per sector the radials at both
    heights, the outer vertical edge, and an ``arc_detail``-segment arc at
    each height, in the JAX package's order; mapped back through the axis
    frame (``transform * p``, hull.rs:784-786).  Built as arrays in f64 and
    rounded to f32 once, where the JAX package loops over the ~10k lines in
    Python and rounds some coordinates to f32 on the way (so the two agree
    to about an f32 ulp of the coordinates).  The grid and its frame come
    to the host in one copy.
    """
    s, k, arcs = rbv.slices, rbv.sectors, arc_detail
    waited("rbv.lines")
    host = torch.cat([rbv.distances.reshape(-1), rbv.center.reshape(-1),
                      rbv.min_y.reshape(1), rbv.slice_height.reshape(1),
                      rbv.transform.reshape(-1)]).cpu().numpy().astype(
                          np.float64)
    d = host[:s * k].reshape(s, k, 1)
    cx, cz, min_y, sh = host[s * k:s * k + 4]
    tf = host[s * k + 4:].reshape(4, 4)
    sector_angle = 2.0 * math.pi / k

    # the sector's arc points p_0 .. p_arcs at angles a0 + angle * j / arcs
    ang = (sector_angle * np.arange(k)[:, None]
           + sector_angle * np.arange(arcs + 1)[None, :] / arcs)
    px = np.broadcast_to(cx + np.cos(ang) * d, (s, k, arcs + 1))
    pz = np.broadcast_to(cz + np.sin(ang) * d, (s, k, arcs + 1))
    y0 = np.broadcast_to((min_y + sh * np.arange(s))[:, None, None],
                         (s, k, arcs + 1))
    y1 = np.broadcast_to((min_y + sh * (np.arange(s) + 1))[:, None, None],
                         (s, k, arcs + 1))

    def at(x, y, z):
        return np.stack(np.broadcast_arrays(x, y, z), axis=-1)

    c0 = at(cx, y0[..., 0], cz)                       # [s,k,3]
    c1 = at(cx, y1[..., 0], cz)
    q0 = at(px, y0, pz)                               # [s,k,arcs+1,3]
    q1 = at(px, y1, pz)
    per_sector = [np.stack([c0, q0[:, :, 0]], axis=2),
                  np.stack([c1, q1[:, :, 0]], axis=2),
                  np.stack([q0[:, :, 0], q1[:, :, 0]], axis=2)]
    for j in range(1, arcs + 1):
        per_sector.append(np.stack([q0[:, :, j - 1], q0[:, :, j]], axis=2))
        per_sector.append(np.stack([q1[:, :, j - 1], q1[:, :, j]], axis=2))
    sectors = np.stack(per_sector, axis=2).reshape(s, -1, 2, 3)
    centre = np.stack([c0[:, 0], c1[:, 0]], axis=1)[:, None]
    lines = np.concatenate([centre, sectors], axis=1).reshape(-1, 2, 3)
    return (lines @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)


def split_landmarks(crown: RadialBoundingVolume,
                    trunk: RadialBoundingVolume) -> np.ndarray:
    """Landmark export of the split RBV: trunk rows, crown rows, then the
    apex (hull.rs:398-402)."""
    lm_t = landmarks(trunk, 0.0, interpolate_height=False).cpu().numpy()
    base = float(crown.min_y - trunk.min_y)
    lm_c = landmarks(crown, base, interpolate_height=False).cpu().numpy()
    top = base + float(crown.slice_height) * crown.slices
    return np.concatenate([lm_t, lm_c, [0.0, 0.0, top]])
