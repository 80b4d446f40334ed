"""Per-segment characteristics, the PyTorch port of ``compute_segments`` in
``treee_tpu/characteristics.py``.

All segments at once, scatter-free:

- one unstable sort by a packed ``(segment << qbits) | quantized y`` key makes
  every segment, and every (segment, 0.1 m slice) bucket, a contiguous run;
- run bounds come from one searchsorted; the per-run minimum y and the
  per-bucket support maxima come from segmented cumulative maxima (CUDA
  kernel ``segmented_cummax``) read at each run's end;
- slice areas are the circumscribed polygons of K support half-planes;
- ground/crown separators are first-index searches over the [S, MS] area
  table, and points are classified against 16+16-bit packed separators.

The arithmetic is the reference's as XLA's CPU code runs it (:func:`fma`,
:func:`quot`, :func:`_xla_row_sum`): the shoelace areas cancel products of
coordinates of the scene's size, so a rounding there decides on which side
of a separator's threshold a slice falls, and with it the classes of the
points above it.

``update_separators_from_classes`` re-derives one segment's separators from
its edited classes.  The focused view's per-point properties:

- ``segment_properties``: expansion (each slice's crown diameter against
  the segment's largest) and relative height, from crown-only slice areas
  reduced as above and the table's (min y, height) read through one 16+16-bit
  packed gather, as the JAX package quantizes them;
- ``segment_curvature`` / ``segment_normals``: the k-NN neighbourhood's
  covariance, its eigenvalue ratio or smallest eigenvector
  (``ops/neighbors``, ``ops/eigen``), brute force among a segment's members
  or, for very large segments, through the grid hash.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .cloud import CLASS_CROWN, CLASS_GROUND, CLASS_TRUNK
from .config import CharacteristicsConfig
from .device import DEFAULT_DEVICE
from .ops import eigen, kernels, neighbors
from .ops.f32 import full
from .parallel.program import run_alone
from .utils.profiling import span

INF = 3.0e38


@dataclasses.dataclass
class SegmentTable:
    """Per-segment analytics, indexed by segment id (row 0 = deleted/unused)."""

    present: torch.Tensor       # bool[S]
    count: torch.Tensor         # i32[S]
    lo: torch.Tensor            # f32[S,3]
    hi: torch.Tensor            # f32[S,3]
    areas: torch.Tensor         # f32[S,MS] slice convex areas
    n_slices: torch.Tensor      # i32[S]
    ground_sep: torch.Tensor    # f32[S] absolute y of ground/trunk split
    crown_sep: torch.Tensor     # f32[S] absolute y of trunk/crown split
    trunk_height: torch.Tensor  # f32[S]
    crown_height: torch.Tensor  # f32[S]

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, arrays: dict,
                   device: str | torch.device = DEFAULT_DEVICE,
                   ) -> "SegmentTable":
        return cls(**{f.name: torch.as_tensor(np.asarray(arrays[f.name]),
                                              device=device)
                      for f in dataclasses.fields(cls)})


def _support_directions(k: int, device) -> torch.Tensor:
    """f32[2, K] unit directions at angles 2*pi*i/K.  cos and sin are taken
    in f64 and rounded, which gives the correctly rounded f32 values that
    XLA's f32 cos/sin give; torch's f32 cos/sin differ in the last bit for
    some K."""
    ang = torch.arange(k, dtype=torch.float32, device=device) * (2.0 * math.pi / k)
    a = ang.double()
    return torch.stack([torch.cos(a), torch.sin(a)]).float()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA's CPU backend computes a
    product feeding a sum inside one fused loop (it contracts them into
    an FMA).  The product of two f32 values is exact in f64, so only the
    f64 sum and the final cast round; they differ from one rounding in
    about 2^-29 of cases.  One ``addcmul`` kernel computes it in f64 and
    writes f32.  The reference's y decodes, support scores and slice areas
    are contracted so on the CPU."""
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape, c.shape),
                      dtype=torch.float32, device=c.device)
    return torch.addcmul(c, a.double(), b, out=out)


def quot(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c`` as XLA computes it: the product with
    the f32 reciprocal of ``c`` (its algebraic simplifier rewrites every
    division by a constant so)."""
    return a * full(float(np.float32(1.0) / np.float32(c)), a)


def _xla_row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of f32[B,K] in the order of XLA's CPU reduce loop:
    columns 0..K-2 in 8-lane vectors added chunk by chunk, the lanes folded
    by halves (4, 2, 1), then column K-1 from the scalar tail."""
    k = t.shape[1]
    head = t[:, :k - 1]
    pad = (-(k - 1)) % 8
    if pad:
        head = torch.cat([head, head.new_zeros(head.shape[0], pad)], dim=1)
    chunks = head.view(t.shape[0], -1, 8)
    acc = chunks[:, 0]
    for c in range(1, chunks.shape[1]):
        acc = acc + chunks[:, c]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0] + t[:, k - 1]


def _areas_from_supports(s: torch.Tensor, k_dirs: int) -> torch.Tensor:
    """Convex area from per-direction support values s f32[B,K]: the polygon
    cut by the half-planes {x . u_k <= s_k}, by the shoelace formula.
    Buckets with no points (s = -INF) get 0.

    The arithmetic is the reference's as XLA's CPU backend runs it
    (:func:`fma`, :func:`_xla_row_sum`): each difference of two products
    contracts the second one's rounding away, except for the scalar tail's
    copy of vertex 0, whose ``u_0 = 1`` product folds away and leaves the
    other one to contract.  The shoelace cancels terms of the size of the
    squared coordinates, so these roundings move small areas by far more
    than an ulp and, past a separator's threshold, a point's class."""
    dirs = _support_directions(k_dirs, s.device)
    ux, uz = dirs[0], dirs[1]
    nx_, nz_ = torch.roll(ux, -1), torch.roll(uz, -1)
    s_next = torch.roll(s, -1, dims=1)
    det = fma(ux, nz_, -(uz * nx_))
    vx = torch.div(fma(s, nz_, -(s_next * uz)), det)
    vz = torch.div(fma(s_next, ux, -(s * nx_)), det)
    vz0_tail = torch.div(fma(-nx_[0], s[:, 0], s_next[:, 0]), det[0])
    wx = torch.roll(vx, -1, dims=1)
    wz = torch.roll(vz, -1, dims=1)
    wz[:, -1] = vz0_tail
    area = 0.5 * torch.abs(_xla_row_sum(fma(vx, wz, -(wx * vz))))
    return torch.where(s[:, 0] > -INF, area, 0.0)


def _run_end_index(key_sorted: torch.Tensor, n_buckets: int):
    """(idx, hit): the sorted slot of each bucket's run end, and whether the
    bucket occurs at all."""
    n = key_sorted.shape[0]
    q = torch.arange(n_buckets, dtype=key_sorted.dtype, device=key_sorted.device)
    idx = torch.searchsorted(key_sorted, q, side="right") - 1
    idx = idx.clamp(0, n - 1)
    return idx, key_sorted[idx] == q


def _find_first(cond: torch.Tensor):
    """First True index along axis 1 of [S,MS]; (idx, found)."""
    return (torch.argmax(cond.to(torch.uint8), dim=1).to(torch.int32),
            cond.any(dim=1))


def compute_segments(
    pos: torch.Tensor,
    segment: torch.Tensor,
    valid: torch.Tensor,
    num_segments: int,
    cfg: CharacteristicsConfig = CharacteristicsConfig(),
    full_bbox: bool = True,
) -> tuple[SegmentTable, torch.Tensor]:
    """Characteristics of every segment, and a class per point.

    Args:
      pos: f32[N,3] y-up; segment: i32[N] ids in [0, num_segments);
      valid: bool[N]; id 0 is the deleted bucket and gets no analytics.
      full_bbox: when False, only the y extent is reduced; x/z of lo/hi are 0.
    Returns:
      (SegmentTable with S=num_segments rows, classification i32[N]).
    """
    return run_alone(compute_segments_shard(pos, segment, valid, num_segments,
                                            cfg, full_bbox, across=False))


def compute_segments_shard(pos, segment, valid, num_segments: int,
                           cfg: CharacteristicsConfig, full_bbox: bool,
                           across: bool):
    """:func:`compute_segments` as a shard program (``parallel/sharding``):
    a generator that returns (table, classification).

    With ``across`` (the port's form of the JAX package's ``axis_name``),
    the rows are one shard of a point-sharded cloud, and the program yields
    each value that combines across the shards as ``(op, tensor)`` and
    receives the combined tensor: the y quantisation grid (min, max), each
    segment's count (sum) and y extent (min, max), and the support table
    (max) before the areas.  Each shard then computes the same table and
    its own points' classes.  Without ``across`` it yields nothing.
    """
    with span("characteristics", pos.device):
        return (yield from _segments_program(pos, segment, valid,
                                             num_segments, cfg, full_bbox,
                                             across))


def _segments_program(pos, segment, valid, num_segments: int,
                      cfg: CharacteristicsConfig, full_bbox: bool,
                      across: bool):
    s_cap = num_segments
    ms = cfg.max_slices
    sw = cfg.slice_width
    n = pos.shape[0]
    k_dirs = cfg.hull_directions
    dev = pos.device

    live0 = valid & (segment > 0) & (segment < s_cap)
    seg = torch.where(live0, segment, 0)

    # the packed key must stay a positive int32: (s_cap << qbits) | qmax
    qbits = min(19, 31 - max(s_cap.bit_length(), 1))
    if qbits < 12 or s_cap * ms >= 2**31:
        raise ValueError(
            f"num_segments={num_segments} (max_slices={ms}) exceeds the "
            "packed int32 key space; supported capacity is < 2^19 segments")
    qmax = (1 << qbits) - 1
    y = pos[:, 1]
    any_valid = valid.any()
    ylo = torch.where(valid, y, INF).amin()
    yhi = torch.where(valid, y, -INF).amax()
    if across:
        # one quantisation grid for every shard, so that slice buckets align;
        # a shard of padding gives the identities
        ylo = yield "min", ylo
        yhi = yield "max", yhi
        any_valid = yield "max", any_valid
    ylo = torch.where(any_valid, ylo, 0.0)
    yhi = torch.where(any_valid, yhi, 1.0)
    yext = torch.clamp(yhi - ylo, min=1e-6)
    qy = torch.clamp(((y - ylo) * torch.div(full(qmax, yext), yext))
                     .to(torch.int32), 0, qmax)
    key = (torch.where(live0, segment, s_cap).to(torch.int32) << qbits) | qy
    # unstable: everything below reads run boundaries from the keys and x/z
    # only through per-run maxima, so the order of ties does not matter
    key_s, perm = torch.sort(key, stable=False)
    x_s = pos[:, 0][perm]
    z_s = pos[:, 2][perm]
    seg_s = key_s >> qbits
    y_s = fma((key_s & qmax).float(), quot(yext, qmax), ylo)
    live_s = seg_s < s_cap

    # per-segment count and y extent from one searchsorted of S+1 queries
    qs1 = torch.arange(s_cap + 1, dtype=torch.int32, device=dev) << qbits
    bounds = torch.searchsorted(key_s, qs1, side="left")
    left, right = bounds[:s_cap], bounds[1:]
    count = (right - left).to(torch.int32)
    min_y_raw = torch.where(count > 0, y_s[left.clamp(0, n - 1)], INF)
    max_y_raw = torch.where(count > 0, y_s[(right - 1).clamp(0, n - 1)], -INF)
    if across:
        count = yield "sum", count
        min_y_raw = yield "min", min_y_raw
        max_y_raw = yield "max", max_y_raw
    present = count > 0
    min_y = torch.where(present, min_y_raw, 0.0)
    max_y = torch.where(present, max_y_raw, 0.0)

    # each point's slice above its segment's min y
    if across:
        # the segment's minimum may lie on another shard: read the combined
        # table (the same quantised y as the run start's on one device)
        min_y_pt = torch.cat([min_y, min_y.new_zeros(1)])[
            seg_s.clamp(0, s_cap).long()]
    else:
        # the run-start y filled down the run by a segmented cummax
        is_start = torch.ones_like(live_s)
        is_start[1:] = seg_s[1:] != seg_s[:-1]
        min_y_pt = kernels.segmented_cummax(
            seg_s, torch.where(is_start, y_s, -INF))
    slice_s = torch.clamp(
        torch.floor(quot(y_s - min_y_pt, sw)).to(torch.int32), 0, ms - 1)
    bucket_s = torch.where(live_s, seg_s * ms + slice_s, s_cap * ms)

    # per-bucket support maxima (+ x/z extents with full_bbox)
    dirs = _support_directions(k_dirs, dev)
    cols = [fma(x_s[:, None], dirs[0][None, :],
                z_s[:, None] * dirs[1][None, :])]
    if full_bbox:
        cols.append(torch.stack([x_s, z_s, -x_s, -z_s], dim=1))
    scores = torch.where(live_s[:, None], torch.cat(cols, dim=1), -INF)
    cum = kernels.segmented_cummax(bucket_s, scores)
    idx, hit = _run_end_index(bucket_s, s_cap * ms)
    tab = torch.where(hit[:, None], cum[idx], -INF)
    if across:
        tab = yield "max", tab
    areas = _areas_from_supports(tab[:, :k_dirs], k_dirs).view(s_cap, ms)

    if full_bbox:
        ext = tab[:, k_dirs:].view(s_cap, ms, 4).amax(dim=1)
        lo = torch.stack([-ext[:, 2], min_y, -ext[:, 3]], dim=-1)
        hi = torch.stack([ext[:, 0], max_y, ext[:, 1]], dim=-1)
    else:
        zero = torch.zeros(s_cap, dtype=torch.float32, device=dev)
        lo = torch.stack([zero, min_y, zero], dim=-1)
        hi = torch.stack([zero, max_y, zero], dim=-1)
    lo = torch.where(present[:, None], lo, 0.0)
    hi = torch.where(present[:, None], hi, 0.0)

    height = max_y - min_y
    n_slices = torch.clamp(quot(height, sw).to(torch.int32) + 1, 1, ms)

    # --- separators (calculations.rs:219-259) ---
    sl = torch.arange(ms, dtype=torch.int32, device=dev)[None, :]
    in_range = sl < n_slices[:, None]

    # min_area: min of areas over slices [1m, 11m), floored at 0.5
    lo_i = int(1.0 / sw)
    hi_i = lo_i + int(10.0 / sw)
    m = in_range & (sl >= lo_i) & (sl < hi_i)
    min_area = torch.where(m, areas, INF).amin(dim=1)
    min_area = torch.where(m.any(dim=1), min_area, 0.5)
    min_area = torch.clamp(min_area, min=cfg.min_area_floor)

    thresh = min_area * cfg.ground_min_area_scale
    # ground: first slice below 1m whose area exceeds the threshold
    g_lim = int(cfg.ground_max_search_height / sw)
    ground_idx, ground_found = _find_first(
        in_range & (sl < g_lim) & (areas > thresh[:, None]))
    # ground_sep: first slice after `ground` (within the lower half) whose
    # area drops back below the threshold; 0 if none
    half = n_slices[:, None] // 2
    gs_idx, gs_found = _find_first(
        (sl >= ground_idx[:, None]) & (sl < half) & (areas < thresh[:, None]))
    ground_sep_idx = torch.where(ground_found & gs_found, gs_idx, 0)

    # crown_sep: first slice at/above ground_sep with area > pi*(min_d/2)^2
    min_crown_area = math.pi * (cfg.min_crown_diameter / 2.0) ** 2
    cs_idx, cs_found = _find_first(
        in_range & (sl >= ground_sep_idx[:, None]) & (areas > min_crown_area))
    crown_sep_idx = torch.where(cs_found, cs_idx, 0)

    ground_sep = min_y + ground_sep_idx.float() * sw
    crown_sep = min_y + crown_sep_idx.float() * sw

    table = SegmentTable(
        present=present,
        count=count,
        lo=lo,
        hi=hi,
        areas=areas,
        n_slices=n_slices,
        ground_sep=ground_sep,
        crown_sep=crown_sep,
        trunk_height=torch.where(present, crown_sep - ground_sep, 0.0),
        crown_height=torch.where(present, hi[:, 1] - crown_sep, 0.0),
    )

    # --- classification (calculations.rs:150-163) against the separators
    # quantized to 16 bits each over the scene's y range and packed into
    # one i32 per segment, as the JAX package does ---
    qsc = torch.div(full(65535.0, yext), yext)
    qg = torch.clamp(((ground_sep - ylo) * qsc).to(torch.int32), 0, 65535)
    qc = torch.clamp(((crown_sep - ylo) * qsc).to(torch.int32), 0, 65535)
    packed = ((qg << 16) | qc)[seg.long()]
    # mask after the arithmetic >>: qg >= 32768 makes packed negative
    step = quot(yext, 65535.0)
    gs = fma(((packed >> 16) & 0xFFFF).float(), step, ylo)
    cs = fma((packed & 0xFFFF).float(), step, ylo)
    classification = torch.where(
        y < gs, CLASS_GROUND, torch.where(y < cs, CLASS_TRUNK, CLASS_CROWN))
    classification = torch.where(live0, classification, CLASS_GROUND)
    return table, classification.to(torch.int32)


def update_separators_from_classes(
    pos: torch.Tensor,
    segment: torch.Tensor,
    valid: torch.Tensor,
    classification: torch.Tensor,
    table: SegmentTable,
    segment_id: int,
) -> SegmentTable:
    """One segment's separators re-derived from its EDITED classes.

    After a brush stroke that reclassifies points, the reference takes
    ground_sep from the lowest Trunk point, crown_sep from the lowest Crown
    point, the trunk and crown heights from the class extents, and the y
    box from the members (SegmentData::changed); re-running the area
    profile would undo the user's edit.  Returns a new table; only row
    ``segment_id`` changes.
    """
    member = valid & (segment == segment_id)
    y = pos[:, 1]
    sid = int(segment_id)

    def extent(m):
        has = m.any()
        mn = torch.where(m, y, INF).amin()
        mx = torch.where(m, y, -INF).amax()
        return has, torch.where(has, mn, 0.0), torch.where(has, mx, 0.0)

    has_t, t_min, t_max = extent(member & (classification == CLASS_TRUNK))
    has_c, c_min, c_max = extent(member & (classification == CLASS_CROWN))
    has_m, m_min, m_max = extent(member)
    count = member.sum(dtype=torch.int32)

    def row(col: torch.Tensor, value, index=sid) -> torch.Tensor:
        out = col.clone()
        out[index] = value
        return out

    return dataclasses.replace(
        table,
        ground_sep=row(table.ground_sep,
                       torch.where(has_t, t_min, table.ground_sep[sid])),
        crown_sep=row(table.crown_sep,
                      torch.where(has_c, c_min, table.crown_sep[sid])),
        trunk_height=row(table.trunk_height,
                         torch.where(has_t, t_max - t_min, 0.0)),
        crown_height=row(table.crown_height,
                         torch.where(has_c, c_max - c_min, 0.0)),
        count=row(table.count, count),
        present=row(table.present, count > 0),
        lo=row(table.lo, torch.where(has_m, m_min, table.lo[sid, 1]),
               (sid, 1)),
        hi=row(table.hi, torch.where(has_m, m_max, table.hi[sid, 1]),
               (sid, 1)),
    )


def segment_properties(
    pos: torch.Tensor,
    segment: torch.Tensor,
    valid: torch.Tensor,
    classification: torch.Tensor,
    table: SegmentTable,
    num_segments: int,
    cfg: CharacteristicsConfig = CharacteristicsConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point expansion and relative height (calculations.rs:297-326).

    Expansion: crown-only slice areas -> each slice's diameter against the
    segment's largest crown diameter; each point reads its slice's ratio.
    Height: y normalized to the segment's extent.  Returns (expansion
    f32[N], height f32[N]).  Each point's (min y, height) comes from the
    table quantized to 16 bits each over the table's y range and packed into
    one i32, as the JAX package gathers it; the values are decoded from
    that, so they carry its rounding.
    """
    s_cap = num_segments
    ms = cfg.max_slices
    sw = cfg.slice_width
    k_dirs = cfg.hull_directions

    seg = torch.where(valid & (segment > 0) & (segment < s_cap), segment, 0)
    live = seg > 0
    min_y = table.lo[:, 1]
    height_ext = torch.clamp(table.hi[:, 1] - table.lo[:, 1], min=1e-6)
    ylo_s = min_y.amin()
    yext_s = torch.clamp(table.hi[:, 1].amax() - ylo_s, min=1e-6)
    qsc = torch.div(full(65535.0, yext_s), yext_s)
    qmy = torch.clamp(((min_y - ylo_s) * qsc).to(torch.int32), 0, 65535)
    qh = torch.clamp((height_ext * qsc).to(torch.int32), 1, 65535)
    packed = ((qmy << 16) | qh)[seg.long()]
    step = quot(yext_s, 65535.0)
    # mask after the arithmetic >>: qmy >= 32768 makes packed negative
    min_y_pt = fma(((packed >> 16) & 0xFFFF).float(), step, ylo_s)
    inv_h_pt = torch.div(full(1.0, step), (packed & 0xFFFF).float() * step)
    slice_idx = torch.clamp(
        torch.floor(quot(pos[:, 1] - min_y_pt, sw)).to(torch.int32),
        0, ms - 1)

    # crown-only slice areas: sort by the (segment, slice) bucket, a
    # segmented cummax of the support scores, read at each run's end; other
    # points go to a dump bucket that no table row reads
    crown_only = live & (classification == CLASS_CROWN)
    bucket = torch.where(crown_only, seg * ms + slice_idx, s_cap * ms)
    bucket_s, perm = torch.sort(bucket.to(torch.int32), stable=False)
    x_s, z_s = pos[:, 0][perm], pos[:, 2][perm]
    dirs = _support_directions(k_dirs, pos.device)
    scores = fma(x_s[:, None], dirs[0][None, :],
                 z_s[:, None] * dirs[1][None, :])
    cum = kernels.segmented_cummax(bucket_s, scores)
    idx, hit = _run_end_index(bucket_s, s_cap * ms)
    tab = torch.where(hit[:, None], cum[idx], -INF)
    areas_crown = _areas_from_supports(tab, k_dirs).view(s_cap, ms)

    # crown area: the largest area at or above the crown separator's slice
    # (calculations.rs:301-306)
    crown_sep_idx = torch.clamp(
        quot(table.crown_sep - min_y, sw).to(torch.int32), 0, ms - 1)
    sl = torch.arange(ms, dtype=torch.int32, device=pos.device)[None, :]
    crown_area = torch.where(sl >= crown_sep_idx[:, None], areas_crown,
                             -INF).amax(dim=1)
    crown_area = torch.clamp(crown_area, min=0.0)

    # diameter ratio per slice (approximate_diameter, calculations.rs:460-462)
    # the square roots through f64: torch's f32 sqrt on the CPU misses the
    # correctly rounded value in ~0.7% of cases, XLA's and CUDA's do not
    crown_diam = 2.0 * torch.sqrt(quot(crown_area, math.pi).double()).float()
    slice_diam = 2.0 * torch.sqrt(quot(areas_crown, math.pi).double()).float()
    ratio = torch.div(slice_diam, torch.clamp(crown_diam[:, None], min=1e-6))

    expansion = torch.where(live, ratio[seg.long(), slice_idx.long()], 0.0)
    height = torch.where(
        live, torch.clamp((pos[:, 1] - min_y_pt) * inv_h_pt, 0.0, 1.0), 0.0)
    return expansion, height


def _curv_per_row(idx, dist, nbrs):
    """Per-row reduction of the grid k-NN: the covariance's eigenvalue
    ratio."""
    return (eigen.curvature_from_cov(
        neighbors.neighbor_covariance_from(nbrs, dist < INF)),)


def _normals_per_row(idx, dist, nbrs):
    """Per-row reduction of the grid k-NN: the smallest eigenvector."""
    return (eigen.smallest_eigenvector(
        neighbors.neighbor_covariance_from(nbrs, dist < INF)),)


def _grid_rows(pos, member, k, cell_size, per_row, fill):
    """``per_row`` of the grid k-NN at the member rows, ``fill`` f32[..]
    elsewhere.  Only member rows are queried: the JAX package queries every
    row and masks the others out, which gives the same output."""
    rows = torch.nonzero(member).flatten()
    (vals,) = neighbors.knn_grid_reduce(pos, member, cell_size, per_row, k=k,
                                        rows=rows)
    out = fill.clone()
    out[rows] = vals
    return out


def segment_curvature(pos: torch.Tensor, member: torch.Tensor, k: int = 31,
                      use_grid: bool = False, cell_size: float = 0.5
                      ) -> torch.Tensor:
    """Per-point curvature of one segment's members (calculations.rs:
    328-373): k-NN within the member set, the neighbourhood's covariance,
    then 3*lambda_min/trace.  Non-members get 0.

    ``use_grid`` switches the exact tiled brute force (the reference's
    per-tree sizes) to the grid-hash k-NN for very large member sets, where
    O(N^2) distances would not fit the time or memory.  Members with fewer
    than k neighbours leave the INF-distance padding out of the covariance,
    as the reference's KD-tree returns members only.
    """
    if use_grid:
        return _grid_rows(pos, member, k, cell_size, _curv_per_row,
                          torch.zeros(pos.shape[0], dtype=torch.float32,
                                      device=pos.device))
    idx, dist = neighbors.knn_bruteforce(pos, member, k=k)
    cov = neighbors.neighbor_covariance(pos, idx, dist < INF)
    return torch.where(member, eigen.curvature_from_cov(cov), 0.0)


def segment_normals(pos: torch.Tensor, member: torch.Tensor, k: int = 31,
                    use_grid: bool = False, cell_size: float = 0.5
                    ) -> torch.Tensor:
    """Per-point unit surface normals of one segment's members, f32[N,3]:
    the smallest eigenvector of the same neighbourhood covariance as
    :func:`segment_curvature`, y >= 0; non-members get +y."""
    up = torch.zeros_like(pos)
    up[:, 1] = 1.0
    if use_grid:
        return _grid_rows(pos, member, k, cell_size, _normals_per_row, up)
    idx, dist = neighbors.knn_bruteforce(pos, member, k=k)
    cov = neighbors.neighbor_covariance(pos, idx, dist < INF)
    return torch.where(member[:, None], eigen.smallest_eigenvector(cov), up)
