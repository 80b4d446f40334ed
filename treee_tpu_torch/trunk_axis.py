"""Trunk axes, the PyTorch port of ``treee_tpu/trunk_axis.py``
(treee/src/interactive/trunk_axis.rs:108-232): of one focused tree
(``average_direction``, ``low_high_layer``, ``axis_transform``,
``axis_lines``) and of every segment at once (the batched forms below).

- ``batched_average_direction``: split each trunk into ``layers`` horizontal
  layers; origin = mean (x, z) of the points 0.4-0.6 m above the trunk's base
  (else the lowest layer's mean); direction = the normalized sum of the unit
  vectors from the origin to each layer's mean.  Sorted form only: one
  stable sort by segment turns the extents into a segmented cummax (CUDA
  kernel ``segmented_cummax``), the per-point (base, layer height) into a
  run fill, and the band and layer sums into segmented cumsums (CUDA kernel
  ``segmented_cumsum``) read at each run's end.
- ``batched_low_high_layer``: the means of the lowest and highest
  ``layer_width`` bands, connected.  Its sums also go through one sort and
  a segmented cumsum, so they repeat bit for bit on the card.
- ``batched_axis_transform``: each axis's 4x4 frame (trunk_axis.rs:56-70).

The batched forms' float sums take another order than the JAX package's
scatter-adds, so their axes agree with it to float rounding, not bit for
bit.  Each batched form is also a shard program
(``batched_*_shard``) that ``parallel/sharding.py`` runs over point
shards; there the y extents combine by a min and a max, which is exact,
and the sums by one sum in shard order of each shard's own segmented sums.
The single-tree forms reuse the batched tails with one row; their
layer sums are ``ordered_sums`` (row order on the CPU, as XLA's
scatter-add; a fixed order on the card), their other sums reductions.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops import eigen, kernels
from .ops.f32 import div, full
from .ops.sums import ordered_sums, sums_by_key
from .parallel.program import run_alone

INF = 3.0e38


@dataclasses.dataclass
class TrunkAxis:
    origin: torch.Tensor     # f32[S,3]
    direction: torch.Tensor  # f32[S,3] unit, roughly +y
    found: torch.Tensor      # bool[S]; False where a segment has no trunk point


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed in index order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _unit(axis: int, value: float, like: torch.Tensor) -> torch.Tensor:
    """f32[3] with ``value`` at ``axis``, 0 elsewhere, made on ``like``'s
    device by fills: a tensor from a list, or an entry set to a Python
    number, is a copy from the host, which waits for the card."""
    v = torch.zeros(3, dtype=torch.float32, device=like.device)
    v[axis].fill_(value)
    return v


def _up(like: torch.Tensor) -> torch.Tensor:
    return _unit(1, 1.0, like)


def _segment_minmax_y(y, mask, seg_t, n_segments, across: bool):
    """Shard program -> per-segment (lo, hi, found) of the masked y:
    scatter min and max, which take no order, and over shards a min and a
    max."""
    lo = torch.full((n_segments + 1,), INF, dtype=torch.float32,
                    device=y.device)
    hi = torch.full((n_segments + 1,), -INF, dtype=torch.float32,
                    device=y.device)
    lo.scatter_reduce_(0, seg_t.long(), torch.where(mask, y, INF), "amin")
    hi.scatter_reduce_(0, seg_t.long(), torch.where(mask, y, -INF), "amax")
    lo, hi = lo[:n_segments], hi[:n_segments]
    if across:
        lo = yield "min", lo
        hi = yield "max", hi
    found = lo < INF
    return torch.where(found, lo, 0.0), torch.where(found, hi, 0.0), found


def _axis_from_tables(lo, hi, found, layer_h, band_n, band_x, band_z,
                      lsum_x, lsum_z, lcnt, layers):
    """The [S]-level tail of AverageDirection from the per-segment tables."""
    lmean_x = lsum_x / torch.clamp(lcnt, min=1.0)
    lmean_z = lsum_z / torch.clamp(lcnt, min=1.0)
    origin_x = torch.where(band_n > 0, band_x / torch.clamp(band_n, min=1.0),
                           lmean_x[:, 0])
    origin_z = torch.where(band_n > 0, band_z / torch.clamp(band_n, min=1.0),
                           lmean_z[:, 0])
    origin = torch.stack([origin_x, lo, origin_z], dim=-1)
    heights = lo[:, None] + (
        torch.arange(layers, dtype=torch.float32, device=lo.device)[None, :]
        + 0.5) * layer_h[:, None]
    means3 = torch.stack([lmean_x, heights, lmean_z], dim=-1)
    vecs = means3 - origin[:, None, :]
    norms = _norm(vecs)[..., None]
    unit = torch.where((lcnt > 0)[:, :, None],
                       vecs / torch.clamp(norms, min=1e-6), 0.0)
    direction = unit.sum(dim=1)
    direction = direction / torch.clamp(_norm(direction)[:, None], min=1e-6)
    direction = torch.where(found[:, None], direction, _up(lo))
    origin = torch.where(found[:, None], origin, 0.0)
    return TrunkAxis(origin=origin, direction=direction, found=found)


def _run_ends(key_s: torch.Tensor, n_runs: int):
    """(left, right, has, end) of runs 0..n_runs-1 over sorted keys: the
    rows [left, right) hold key r, ``end`` is its last row (clipped)."""
    n = key_s.shape[0]
    q = torch.arange(n_runs + 1, dtype=torch.int32, device=key_s.device)
    bounds = torch.searchsorted(key_s, q, side="left")
    left, right = bounds[:-1], bounds[1:]
    return left, right, right > left, torch.clamp(right - 1, 0, n - 1)


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


def batched_average_direction(pos: torch.Tensor, mask: torch.Tensor,
                              segment: torch.Tensor, n_segments: int,
                              layers: int = 10) -> TrunkAxis:
    """AverageDirection for every segment at once; row i is segment i's axis
    from its masked points (``found`` False where it has none)."""
    return run_alone(batched_average_direction_shard(
        pos, mask, segment, n_segments, layers, across=False))


def batched_average_direction_shard(pos, mask, segment, n_segments: int,
                                    layers: int, across: bool):
    """:func:`batched_average_direction` as a shard program: over shards
    the y extents take a min and a max (exact), the band and layer sums one
    sum in shard order of each shard's own segmented sums."""
    key = torch.where(mask, segment, n_segments).to(torch.int32)
    key_s, order = torch.sort(key, stable=True)
    x_s, y_s, z_s = pos[order, 0], pos[order, 1], pos[order, 2]
    left, right, has, end = _run_ends(key_s, n_segments)

    ext = kernels.segmented_cummax(key_s, torch.stack([-y_s, y_s], dim=1))
    picked = ext[end]
    lo = torch.where(has, -picked[:, 0], INF)
    hi = torch.where(has, picked[:, 1], -INF)
    if across:
        lo = yield "min", lo
        hi = yield "max", hi
    found = lo < INF
    lo = torch.where(found, lo, 0.0)
    hi = torch.where(found, hi, 0.0)
    layer_h = torch.clamp(div(hi - lo, layers), min=1e-6)

    per2 = run_fill(key_s, left, right, torch.stack([lo, layer_h], dim=1))
    lo_p, lh_p = per2[:, 0], per2[:, 1]
    in_seg = key_s < n_segments
    band = in_seg & (y_s >= lo_p + 0.4) & (y_s < lo_p + 0.6)
    bsum = kernels.segmented_cumsum(key_s, torch.stack(
        [band.float(), torch.where(band, x_s, 0.0),
         torch.where(band, z_s, 0.0)], dim=1))
    bp = torch.where(has[:, None], bsum[end], 0.0)

    li = torch.clamp(((y_s - lo_p) / lh_p).to(torch.int32), 0, layers - 1)
    bucket = torch.where(in_seg, key_s * layers + li, n_segments * layers)
    lp = sums_by_key(bucket, torch.stack([torch.ones_like(x_s), x_s, z_s],
                                         dim=1), n_segments * layers)
    if across:
        tab = yield "sum", torch.cat([bp, lp.view(n_segments, 3 * layers)], 1)
        bp, lp = tab[:, :3], tab[:, 3:].reshape(n_segments * layers, 3)
    return _axis_from_tables(
        lo, hi, found, layer_h, bp[:, 0], bp[:, 1], bp[:, 2],
        lp[:, 1].view(n_segments, layers), lp[:, 2].view(n_segments, layers),
        lp[:, 0].view(n_segments, layers), layers)


def batched_low_high_layer(pos: torch.Tensor, mask: torch.Tensor,
                           segment: torch.Tensor, n_segments: int,
                           layer_width: float = 1.0) -> TrunkAxis:
    """LowHighLayer for every segment at once; row i is segment i's axis."""
    return run_alone(batched_low_high_layer_shard(
        pos, mask, segment, n_segments, layer_width, across=False))


def batched_low_high_layer_shard(pos, mask, segment, n_segments: int,
                                 layer_width: float, across: bool):
    """:func:`batched_low_high_layer` as a shard program: over shards the y
    extents take a min and a max, the bands' counts and sums one sum."""
    y = pos[:, 1]
    seg_c = torch.clamp(segment, 0, n_segments - 1).long()
    seg_t = torch.where(mask, segment, n_segments)
    lo, hi, found = yield from _segment_minmax_y(y, mask, seg_t, n_segments,
                                                 across)
    # the layer, floored: a flat trunk (hi == lo) would leave both bands empty
    layer = torch.clamp(torch.minimum(
        full(layer_width, lo), div(hi - lo, 2.0)), min=1e-3)
    lo_p, hi_p, layer_p = lo[seg_c], hi[seg_c], layer[seg_c]
    low = mask & (y - lo_p < layer_p)
    high = mask & (hi_p - y < layer_p)

    # both bands' counts and (x, z) sums in one pass
    cols = []
    for m in (low, high):
        cols += [m.float(), torch.where(m, pos[:, 0], 0.0),
                 torch.where(m, pos[:, 2], 0.0)]
    tab = sums_by_key(seg_t, torch.stack(cols, dim=1), n_segments)
    if across:
        tab = yield "sum", tab
    means = []
    for k in (0, 3):
        cnt = torch.clamp(tab[:, k], min=1.0)
        means.append((tab[:, k + 1] / cnt, tab[:, k + 2] / cnt))
    (lmx, lmz), (hmx, hmz) = means
    origin = torch.stack([lmx, lo, lmz], dim=-1)
    target = torch.stack([hmx, hi, hmz], dim=-1)
    direction = target - origin
    norm = _norm(direction)[:, None]
    up = _up(pos)
    direction = torch.where(norm > 1e-6,
                            direction / torch.clamp(norm, min=1e-6), up)
    direction = torch.where(found[:, None], direction, up)
    origin = torch.where(found[:, None], origin, 0.0)
    return TrunkAxis(origin=origin, direction=direction, found=found)


def batched_axis_transform(axes: TrunkAxis) -> torch.Tensor:
    """[S,4,4] affine frames whose y axis is each trunk's direction, at its
    origin (trunk_axis.rs:56-70)."""
    yv = axes.direction
    s = yv.shape[0]
    ez = torch.zeros_like(yv)
    ez[:, 2].fill_(1.0)     # no copy from the host (see _unit)
    xv = eigen.cross(yv, ez)
    xv = xv / torch.clamp(_norm(xv)[:, None], min=1e-6)
    zv = eigen.cross(xv, yv)
    m = torch.eye(4, dtype=torch.float32, device=yv.device).repeat(s, 1, 1)
    m[:, :3, 0] = xv
    m[:, :3, 1] = yv
    m[:, :3, 2] = zv
    m[:, :3, 3] = axes.origin
    return m


def _masked_minmax_y(pos: torch.Tensor, mask: torch.Tensor):
    """(lo, hi, found) of the masked y, each f32[1] (bool[1])."""
    y = pos[:, 1]
    found = mask.any()[None]
    lo = torch.where(mask, y, INF).amin()[None]
    hi = torch.where(mask, y, -INF).amax()[None]
    return torch.where(found, lo, 0.0), torch.where(found, hi, 0.0), found


def _single(axis: TrunkAxis) -> TrunkAxis:
    return TrunkAxis(origin=axis.origin[0], direction=axis.direction[0],
                     found=axis.found[0])


def average_direction(pos: torch.Tensor, mask: torch.Tensor,
                      layers: int = 10) -> TrunkAxis:
    """AverageDirection of the masked points (trunk_axis.rs:108-178):
    origin[3], direction[3] and found of one tree."""
    lo, hi, found = _masked_minmax_y(pos, mask)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    band = mask & (y >= lo + 0.4) & (y < lo + 0.6)
    band_n = band.float().sum()[None]
    band_x = torch.where(band, x, 0.0).sum()[None]
    band_z = torch.where(band, z, 0.0).sum()[None]
    layer_h = torch.clamp(div(hi - lo, layers), min=1e-6)
    li = torch.clamp(torch.div(y - lo, layer_h).to(torch.int32), 0,
                     layers - 1)
    tgt = torch.where(mask, li, layers)
    sums = ordered_sums(tgt, torch.stack(
        [torch.where(mask, x, 0.0), torch.where(mask, z, 0.0),
         mask.float()], dim=1), layers)
    return _single(_axis_from_tables(
        lo, hi, found, layer_h, band_n, band_x, band_z, sums[None, :, 0],
        sums[None, :, 1], sums[None, :, 2], layers))


def low_high_layer(pos: torch.Tensor, mask: torch.Tensor,
                   layer_width: float = 1.0) -> TrunkAxis:
    """LowHighLayer of the masked points (trunk_axis.rs:181-232): the means
    of the lowest and highest ``layer_width`` bands, connected."""
    lo, hi, found = _masked_minmax_y(pos, mask)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    # the layer, floored: a flat trunk (hi == lo) would leave both bands empty
    layer = torch.clamp(torch.minimum(full(layer_width, lo),
                                      div(hi - lo, 2.0)), min=1e-3)
    low = mask & (y - lo < layer)
    high = mask & (hi - y < layer)

    def mean_xz(m):
        n = torch.clamp(m.float().sum(), min=1.0)
        return (torch.div(torch.where(m, x, 0.0).sum(), n),
                torch.div(torch.where(m, z, 0.0).sum(), n))

    (lmx, lmz), (hmx, hmz) = mean_xz(low), mean_xz(high)
    origin = torch.stack([lmx, lo[0], lmz])
    target = torch.stack([hmx, hi[0], hmz])
    direction = target - origin
    norm = _norm(direction)
    up = _up(pos)
    direction = torch.where(norm > 1e-6,
                            direction / torch.clamp(norm, min=1e-6), up)
    direction = torch.where(found, direction, up)
    origin = torch.where(found, origin, 0.0)
    return TrunkAxis(origin=origin, direction=direction, found=found[0])


def axis_transform(axis: TrunkAxis) -> torch.Tensor:
    """4x4 affine frame with y = the trunk direction at the origin
    (trunk_axis.rs:56-70)."""
    return batched_axis_transform(TrunkAxis(
        origin=axis.origin[None], direction=axis.direction[None],
        found=axis.found[None]))[0]


def axis_lines(axis: TrunkAxis, scale) -> torch.Tensor:
    """Render lines of an axis: the axis and a ground cross, f32[3,2,3]
    endpoints (TrunkAxisRender, trunk_axis.rs:24-43); ``scale``, the axis's
    length, is a number or an f32 0-d tensor on the axis's device."""
    o, d = axis.origin, axis.direction
    ex, ez = _unit(0, 2.5, o), _unit(2, 2.5, o)
    return torch.stack([torch.stack([o, o + d * scale]),
                        torch.stack([o - ex, o + ex]),
                        torch.stack([o - ez, o + ez])])
