"""Tree segmentation, the PyTorch port of ``treee_tpu/segmentation.py``.

The same algorithm at the TPU's defaults:

1. *Rasterize*: bin every point into a [bands, G, G] count grid over (x, z)
   cells of size d, with bands hung from an outlier-robust top anchor.
2. *Cluster per band*: connected components of the occupied cells by 3x3
   min-label sweeps (CUDA kernel ``cc_sweep``) and compacted pointer jumps,
   until the labels stop changing; then the biggest clusters per band by one
   stable sort.
3. *Track top-down*: mutual-nearest matching of each band's clusters to the
   tracked centroids within 2d, new slots for the rest (CUDA kernel
   ``match_scan``).
4. *Assign*: each occupied cell takes its band's nearest tracked centroid
   (brute force over the slots, the default: CUDA kernel
   ``nearest_slot``), or every cell takes the slot
   a jump flood from the centroids' cells reaches (CUDA kernel
   ``jump_flood``, or the packed flood in plain torch); every point takes
   its cell's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SegmentationConfig
from .ops import kernels
from .ops.f32 import full
from .ops.kernels.nearest_slot import cell_centers
from .ops.sums import sums_by_key
from .parallel.program import run_alone
from .utils.profiling import span, waited

INF = 3.0e38
IBIG = 0x7FFFFFFF

# strided-subsample histogram of the band anchor (segmentation.py:568-569)
ANCHOR_STRIDE = 64
ANCHOR_BINS = 1024


@dataclasses.dataclass
class SegmentationResult:
    """Output of :func:`segment_points`.

    Attributes:
      segment:           i32[N] per-point segment id (0 = unassigned).
      n_segments:        i32 number of allocated segment ids.
      tracked_pos:       f32[B,T,2] tracked centroid per band per slot.
      tracked_active:    bool[B,T] slot liveness per band.
      occupied_overflow: bool; occupied cells exceeded cc_occupied_cap, so
        cluster counts and centroids were truncated.
    """

    segment: torch.Tensor
    n_segments: torch.Tensor
    tracked_pos: torch.Tensor
    tracked_active: torch.Tensor
    occupied_overflow: torch.Tensor


def _scatter_set(size: int, fill, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``full(size, fill).at[index].set(src, mode="drop")`` for indices in
    [0, size]: index ``size`` is a drop slot."""
    out = torch.full((size + 1,), fill, dtype=src.dtype, device=src.device)
    out[index.long()] = src
    return out[:size]


def _connected_components(occupied: torch.Tensor, occ_cap: int, sweeps: int):
    """8-connected components of each band of bool[B,G,G], to the fixpoint.

    Labels are flat in-band cell indices; empty cells hold IBIG.  Each body
    runs ``sweeps`` min-pool sweeps (kernel ``cc_sweep``), then one pointer
    jump over the first ``occ_cap`` occupied cells; bodies repeat until the
    labels stop changing.  At the fixpoint every component carries its
    minimum cell index.  Returns (labels i32[B,G,G], occ_idx i32[occ_cap]
    global flat indices of occupied cells, zero-padded, occ_valid
    bool[occ_cap]).
    """
    b, g, _ = occupied.shape
    gg = g * g
    dev = occupied.device
    idx = torch.arange(gg, dtype=torch.int32, device=dev).view(1, g, g)
    lbl = torch.where(occupied, idx, IBIG)

    waited("segmentation.cc.nonzero")
    occ = torch.nonzero(occupied.reshape(-1))[:occ_cap, 0].to(torch.int32)
    occ_idx = torch.zeros(occ_cap, dtype=torch.int32, device=dev)
    occ_idx[:occ.numel()] = occ
    occ_valid = torch.arange(occ_cap, device=dev) < occ.numel()
    band_off = occ_idx // gg * gg
    jump_tgt = torch.where(occ_valid, occ_idx, b * gg).long()
    occ_l = occ_idx.long()

    while True:
        new = kernels.cc_sweep(lbl, sweeps)
        # compact pointer jump: occupied cells' labels name occupied cells,
        # so only the padding rows read garbage, and they scatter to the
        # drop slot
        flat = torch.cat([new.reshape(-1), new.new_full((1,), IBIG)])
        l1 = flat[occ_l]
        l2 = flat[(band_off + l1.clamp(0, gg - 1)).long()]
        flat.scatter_reduce_(0, jump_tgt, torch.minimum(l1, l2), "amin")
        new = flat[:-1].view(b, g, g)
        waited("segmentation.cc.fixpoint")
        if torch.equal(new, lbl):
            return new, occ_idx, occ_valid
        lbl = new


def _sums_by_target(tgt: torch.Tensor, val: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Sums of the rows of ``val`` f32[M,C] per target index in [0, size).

    On the CPU, ``index_add_`` adds in row order, as XLA's scatter-add does
    on the CPU, so the port equals the JAX package bit for bit there.  On
    CUDA, ``index_add_`` is float atomics whose order changes from run to
    run, which moved a few segment ids between runs of the 15M scan; there
    :func:`~treee_tpu_torch.ops.sums.sums_by_key` fixes the order instead
    (a run may hold 10^5 cells, the ground band's component, and the
    running total over all runs reaches ~1e10, so neither one thread a run
    nor differences of one global cumsum would do).
    """
    if val.device.type == "cpu":
        out = torch.zeros(size, val.shape[1], dtype=val.dtype)
        return out.index_add_(0, tgt, val)
    return sums_by_key(tgt, val, size)


def _extract_clusters(labels, cnt, lo, s, max_clusters: int, min_points: int,
                      occ_idx, occ_valid):
    """The ``max_clusters`` biggest clusters of each band, by point count.

    Centroids are count-weighted cell centres, summed over the compacted
    occupied cells.  Candidates (cells that received counts) are ordered by
    (band, -count) with a stable sort, so equal counts keep ascending cell
    order, and ranked into [B, C] slots.  Returns (centroids f32[B,C,2],
    mask bool[B,C]).
    """
    b, g, _ = labels.shape
    gg = g * g
    occ_cap = occ_idx.shape[0]
    dev = labels.device
    occ_l = occ_idx.long()
    l_occ = labels.reshape(-1)[occ_l]
    root = occ_idx // gg * gg + l_occ.clamp(0, gg - 1)
    tgt = torch.where(occ_valid & (l_occ != IBIG), root, b * gg).long()
    cnt_occ = cnt.reshape(-1)[occ_l]
    center_x, center_z = cell_centers(occ_idx, lo, s, g)
    w = cnt_occ.float()
    pcount = torch.zeros(b * gg + 1, dtype=torch.int32, device=dev)
    pcount.index_add_(0, tgt, cnt_occ)
    ps = _sums_by_target(tgt, torch.stack([w * center_x, w * center_z], 1),
                         b * gg + 1)
    psx, psz = ps[:, 0], ps[:, 1]

    cnt_self = pcount[occ_l]
    is_cand = occ_valid & (cnt_self >= max(min_points, 1))
    key_band = torch.where(is_cand, occ_idx // gg, b)
    key_cnt = torch.where(is_cand, -cnt_self, IBIG)
    lex = (key_band.long() << 32) | (key_cnt.long() + (1 << 31))
    order = torch.sort(lex, stable=True).indices
    sk_band = key_band[order]
    sk_cnt = key_cnt[order]
    sorted_root = occ_idx[order]
    starts = torch.searchsorted(
        sk_band, torch.arange(b, dtype=torch.int32, device=dev), side="left")
    rank = (torch.arange(occ_cap, device=dev)
            - starts[sk_band.clamp(0, b - 1).long()])
    keep = (sk_band < b) & (rank < max_clusters)
    slot = torch.where(keep, sk_band * max_clusters + rank, b * max_clusters)
    groots = _scatter_set(b * max_clusters, 0, slot, sorted_root)
    top = _scatter_set(b * max_clusters, 0, slot, -sk_cnt)
    groots = groots.view(b, max_clusters).long()
    mask = top.view(b, max_clusters) > 0
    denom = pcount[groots].clamp(min=1).float()
    cents = torch.stack([psx[groots] / denom, psz[groots] / denom], dim=-1)
    return cents, mask


def _seed_grids(tracked_pos_b, active_b, lo, s, g: int):
    """Each band's active tracked centroids as seeds of a jump flood:
    (seed_slot i32[B,G,G], -1 where no seed, seed_pos f32[B,G,G,2]).

    Where several slots fall in one cell the highest slot wins (an integer
    scatter-max), and only the winners write their positions, so the
    position scatter's only duplicates go to the drop slot.
    """
    b, t_cap, _ = tracked_pos_b.shape
    gg = g * g
    dev = tracked_pos_b.device
    tcx = torch.clamp(torch.floor((tracked_pos_b[..., 0] - lo[0]) / s)
                      .to(torch.int32), 0, g - 1)
    tcz = torch.clamp(torch.floor((tracked_pos_b[..., 1] - lo[2]) / s)
                      .to(torch.int32), 0, g - 1)
    band_off = torch.arange(b, dtype=torch.int32, device=dev)[:, None] * gg
    seed_cell = torch.where(active_b, band_off + tcx * g + tcz,
                            b * gg).reshape(-1)
    slot_ids = torch.arange(t_cap, dtype=torch.int32,
                            device=dev).repeat(b)
    seed_slot = torch.full((b * gg + 1,), -1, dtype=torch.int32, device=dev)
    seed_slot.scatter_reduce_(0, seed_cell.long(), slot_ids, "amax")
    won = seed_slot[seed_cell.clamp(0, b * gg - 1).long()] == slot_ids
    pos_tgt = torch.where(won, seed_cell, b * gg)
    seed_pos = torch.zeros((b * gg + 1, 2), dtype=torch.float32, device=dev)
    seed_pos[pos_tgt.long()] = tracked_pos_b.reshape(-1, 2)
    return (seed_slot[:b * gg].view(b, g, g),
            seed_pos[:b * gg].view(b, g, g, 2))


def _cell_center_planes(lo, s, g: int) -> torch.Tensor:
    """f32[G,G,2] (x, z) centres of the grid's cells, as band_scan builds
    them: lo + (index + 0.5) * s."""
    i = torch.arange(g, dtype=torch.float32, device=lo.device)
    cx = lo[0] + (i + 0.5) * s
    cz = lo[2] + (i + 0.5) * s
    return torch.stack([cx[:, None].expand(g, g), cz[None, :].expand(g, g)],
                       dim=-1)


def _jump_flood_packed(seed_slot, seed_pos, cell_center, lo, s):
    """The jump flood of ``kernels.jump_flood_plain``, carrying each seed's
    position as one i32 (two 15-bit coordinates on the s/64 lattice above
    ``lo``, so the grid may have up to 512 cells a side) and its distance
    as a third plane, as ``treee_tpu/segmentation.py::_jump_flood_packed``
    does.  Winners can differ from the unpacked flood's only on near ties."""
    g = seed_slot.shape[-1]
    qs = s / 64.0
    inv_qs = torch.div(full(1.0, qs), qs)
    qmax = g * 64 - 1

    def quant(p, axis_lo):
        return torch.clamp(torch.round((p - axis_lo) * inv_qs).to(torch.int32),
                           0, qmax)

    packed = torch.where(seed_slot >= 0,
                         (quant(seed_pos[..., 0], lo[0]) << 15)
                         | quant(seed_pos[..., 1], lo[2]), -1)
    ccx, ccz = cell_center[..., 0], cell_center[..., 1]

    def unpack_dist(slot, pk):
        ex = lo[0] + (pk >> 15).float() * qs - ccx
        ez = lo[2] + (pk & 0x7FFF).float() * qs - ccz
        return torch.where(slot >= 0, ex * ex + ez * ez, INF)

    slot = seed_slot
    dist = unpack_dist(slot, packed)
    for step in kernels.jump_flood_steps(g):
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cs = torch.roll(slot, (dy, dx), (1, 2))
                cq = torch.roll(packed, (dy, dx), (1, 2))
                cd = unpack_dist(cs, cq)
                better = cd < dist
                slot = torch.where(better, cs, slot)
                packed = torch.where(better, cq, packed)
                dist = torch.where(better, cd, dist)
    return slot


def scene_bounds_raw(pos: torch.Tensor, valid: torch.Tensor):
    """(lo, hi) f32[3] over valid points, +INF / -INF where none is valid.

    The form a cross-shard min / max takes: a shard that holds only padding
    must give the identities, not the unit box of :func:`scene_bounds`,
    which would pull the global box toward the origin."""
    m = valid[:, None]
    return (torch.where(m, pos, INF).amin(dim=0),
            torch.where(m, pos, -INF).amax(dim=0))


def scene_bounds_finalize(lo, hi, any_valid):
    """The unit box where no point anywhere was valid."""
    return torch.where(any_valid, lo, 0.0), torch.where(any_valid, hi, 1.0)


def scene_bounds(pos: torch.Tensor, valid: torch.Tensor):
    """(lo, hi) f32[3] over valid points; the unit box if there are none."""
    lo, hi = scene_bounds_raw(pos, valid)
    return scene_bounds_finalize(lo, hi, valid.any())


def cell_size(lo, hi, d, cfg: SegmentationConfig):
    """CC cell size: d, grown if the scene exceeds the static grid."""
    extent = torch.maximum(hi[0] - lo[0], hi[2] - lo[2])
    return torch.maximum(d, extent / (cfg.grid_size - 1))


def anchor_histogram(pos, valid, lo_y, hi_y):
    """y histogram of every ANCHOR_STRIDE-th valid point -> i64[ANCHOR_BINS]."""
    y = pos[::ANCHOR_STRIDE, 1]
    v = valid[::ANCHOR_STRIDE]
    ext = torch.clamp(hi_y - lo_y, min=1e-6)
    b = torch.clamp(((y - lo_y) * (ANCHOR_BINS / ext)).to(torch.int32),
                    0, ANCHOR_BINS - 1)
    tgt = torch.where(v, b, ANCHOR_BINS).long()
    # on CUDA, bincount reads the input's least and greatest values
    waited("segmentation.bincount", 2)
    return torch.bincount(tgt, minlength=ANCHOR_BINS + 1)[:ANCHOR_BINS]


def band_anchor(hist, lo_y, hi_y, cfg: SegmentationConfig):
    """Top of the band window: the 99.9th percentile y of the subsample plus
    one band, capped at the true max (outliers above the canopy would
    otherwise lift the window off the trees)."""
    c = torch.cumsum(hist, 0)
    total = c[-1]
    idx = torch.argmax((c.float() >= 0.999 * total.float()).to(torch.uint8))
    ext = torch.clamp(hi_y - lo_y, min=1e-6)
    top = lo_y + (idx.float() + 1.0) * (ext / ANCHOR_BINS)
    top = torch.minimum(top + cfg.band_height, hi_y)
    return torch.where(total > 0, top, hi_y)


def point_cells(pos, lo, s, top, cfg: SegmentationConfig):
    """Quantize points to (band, cx, cz); band 0 is the top one."""
    g = cfg.grid_size
    band = torch.clamp(
        torch.floor((top - pos[:, 1]) / cfg.band_height).to(torch.int32),
        0, cfg.max_bands - 1)
    cx = torch.clamp(torch.floor((pos[:, 0] - lo[0]) / s).to(torch.int32), 0, g - 1)
    cz = torch.clamp(torch.floor((pos[:, 2] - lo[2]) / s).to(torch.int32), 0, g - 1)
    return band, cx, cz


def moment_grids(valid, band, cx, cz, cfg: SegmentationConfig):
    """Point counts per (band, cx, cz) cell, i32[B,G,G]."""
    g = cfg.grid_size
    size = cfg.max_bands * g * g
    flat = torch.where(valid, (band * g + cx) * g + cz, size).long()
    cnt = torch.zeros(size + 1, dtype=torch.int32, device=valid.device)
    cnt.index_add_(0, flat, torch.ones_like(band))
    return cnt[:-1].view(cfg.max_bands, g, g)


def band_scan(cnt, lo, s, d: float, cfg: SegmentationConfig):
    """Cluster every band, track top-down, and assign the occupied cells.

    Returns (slot_grids i32[B,G,G], n_alloc, tracked_pos f32[B,T,2],
    tracked_active bool[B,T]).
    """
    g = cfg.grid_size
    dev = cnt.device
    with span("segmentation.cc", dev):
        labels, occ_idx, occ_valid = _connected_components(
            cnt > 0, cfg.cc_occupied_cap, cfg.cc_sweeps)
    with span("segmentation.clusters", dev):
        cents_b, cmask_b = _extract_clusters(
            labels, cnt, lo, s, cfg.max_trees_per_band, cfg.min_points,
            occ_idx, occ_valid)
    # the match radius in f32, as JAX computes it from the f32 distance
    radius = float(np.float32(cfg.match_radius_factor) * np.float32(d))
    with span("segmentation.match", dev):
        tracked_pos_b, active_b, n_alloc = kernels.match_scan(
            cents_b, cmask_b, radius, cfg.match_rounds, cfg.max_segments)
    with span("segmentation.voronoi", dev):
        if cfg.use_bruteforce_voronoi:
            slot_grids = kernels.nearest_slot(
                occ_idx, occ_valid, tracked_pos_b, active_b, lo, s,
                cnt.shape[0], g, cfg.voronoi_chunk)
            return slot_grids, n_alloc, tracked_pos_b, active_b
        seed_slot, seed_pos = _seed_grids(tracked_pos_b, active_b, lo, s, g)
        cell_center = _cell_center_planes(lo, s, g)
        if cfg.use_packed_jfa and g <= 512:  # 15-bit packed coordinates
            slot_grids = _jump_flood_packed(seed_slot, seed_pos, cell_center,
                                            lo, s)
        else:
            slot_grids = kernels.jump_flood(seed_slot, seed_pos, cell_center)
    return slot_grids, n_alloc, tracked_pos_b, active_b


def assign_points(slot_grids, band, cx, cz, valid):
    """Each point takes its cell's Voronoi winner; 0 where there is none."""
    g = slot_grids.shape[-1]
    flat = ((band * g + cx) * g + cz).long()
    slot = slot_grids.reshape(-1)[flat]
    return torch.where(valid & (slot >= 0), slot + 1, 0)


def segment_points(pos: torch.Tensor, valid: torch.Tensor,
                   max_distance: float,
                   cfg: SegmentationConfig = SegmentationConfig(),
                   ) -> SegmentationResult:
    """Segment a point cloud into trees; see the module docstring.

    Args:
      pos: f32[N,3] y-up positions; valid: bool[N], on one device.
      max_distance: minimum separation d between trees, in metres.
    """
    return run_alone(segment_points_shard(pos, valid, max_distance, cfg,
                                          across=False))


def segment_points_shard(pos, valid, max_distance: float,
                         cfg: SegmentationConfig, across: bool):
    """:func:`segment_points` as a shard program: a generator that returns
    the ``SegmentationResult`` (``segment`` the rows' own ids; the rest the
    same on every shard).

    With ``across`` the rows are one shard of a point-sharded cloud, and the
    program yields each value that combines across the shards as ``(op,
    value)`` and receives the combined value: the bounds from identity values
    (a shard of padding must not pull the global box to the unit box), the
    anchor histogram (summed over shards whose rows are multiples of its
    stride, so the subsamples make up the one-device one), the band count
    grids, and ``("once", fn)``, the band scan run once for all shards.
    Without ``across`` it yields nothing.
    """
    dev = pos.device
    with span("segmentation", dev):
        with span("segmentation.grid", dev):
            waited("segmentation.distance")     # a host-to-device copy
            d = torch.tensor(max_distance, dtype=torch.float32, device=dev)
            lo, hi = scene_bounds_raw(pos, valid)
            any_valid = valid.any()
            if across:
                lo = yield "min", lo
                hi = yield "max", hi
                any_valid = yield "max", any_valid
            lo, hi = scene_bounds_finalize(lo, hi, any_valid)
            s = cell_size(lo, hi, d, cfg)
            hist = anchor_histogram(pos, valid, lo[1], hi[1])
            if across:
                hist = yield "sum", hist
            top = band_anchor(hist, lo[1], hi[1], cfg)
            band, cx, cz = point_cells(pos, lo, s, top, cfg)
            cnt = moment_grids(valid, band, cx, cz, cfg)
            if across:
                cnt = yield "sum", cnt

        def scan():
            return band_scan(cnt, lo, s, max_distance, cfg)
        slot_grids, n_alloc, tracked_pos_b, active_b = (
            (yield "once", scan) if across else scan())
        with span("segmentation.assign", dev):
            segment = assign_points(slot_grids, band, cx, cz, valid)
            overflow = (cnt > 0).sum() > cfg.cc_occupied_cap
        return SegmentationResult(
            segment=segment,
            n_segments=n_alloc,
            tracked_pos=tracked_pos_b,
            tracked_active=active_b,
            occupied_overflow=overflow,
        )
