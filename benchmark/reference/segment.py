"""Tree segmentation and the segment table, written from the algorithm's
published steps (``treee/src/segmenting.rs`` and ``calculations.rs``, as
the TPU system states them): the per-point passes in PyTorch on the
device the points are on, the grid and the tracking in NumPy and SciPy on
the host.  Every f32 division is of two tensors (correctly rounded on any
device).

Segmentation, for points ``pos`` f32[N,3] (y up) and a distance ``d``:

1. The scene's box over the valid points; the cell size ``s`` is ``d``,
   grown to ``extent / (G - 1)`` where the scene is wider than the grid.
2. The band window hangs from an anchor: the 99.9th percentile height of
   every 64th row, in 1024 bins over the y range, plus one band, capped at
   the highest point.  Band 0 is the top one.
3. Every valid point falls in a (band, x cell, z cell); a cell is occupied
   where a point falls.
4. The occupied cells of each band form 8-connected components
   (``scipy.ndimage.label``); a component is named by its lowest flat cell
   index, and counts its points and their cell centres.
5. Each band keeps its ``max_trees_per_band`` largest components of at
   least ``min_points`` points (equal counts: the lower index first), at
   their point-weighted centroids.
6. Tracking runs from the top band down: ``match_rounds`` rounds of
   mutual-nearest pairing of the live slots with the band's unmatched
   clusters within ``match_radius_factor * d`` (a matched slot moves onto
   its cluster), then each unmatched cluster, in order, opens the lowest
   free slot.  Each band keeps a snapshot of the slots.
7. Every occupied cell takes the nearest live slot of its band's snapshot
   (squared distance in f32, ties to the lower slot), and every point its
   cell's slot + 1; 0 where there is none.

The table and the classes (``calculations.rs``) follow in
:func:`segment_table`.  Nothing here is the port's code: the CC is SciPy's
labelling, the nearest slot a k-d tree query, the slice areas the exact
polygon of the support half-planes in f64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage, spatial

F = np.float32
INF = F(3.0e38)
ANCHOR_STRIDE = 64
ANCHOR_BINS = 1024


def _c(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``like``'s device."""
    return torch.tensor(v, dtype=dtype, device=like.device)


def box(pos: torch.Tensor, valid: torch.Tensor):
    """(lo, hi) f32[3] over the valid points on the host; the unit box if
    none is."""
    if not bool(valid.any()):
        return np.zeros(3, F), np.ones(3, F)
    p = pos[valid]
    return p.amin(dim=0).cpu().numpy(), p.amax(dim=0).cpu().numpy()


def anchor_top(y: torch.Tensor, valid: torch.Tensor, lo_y, hi_y,
               band_height: float):
    """The top of the band window (step 2), an f32 on the host."""
    sub, v = y[::ANCHOR_STRIDE], valid[::ANCHOR_STRIDE]
    ext = max(F(hi_y - lo_y), F(1e-6))
    b = ((sub[v] - _c(lo_y, y)) * _c(F(ANCHOR_BINS) / ext, y)).long()
    hist = torch.bincount(b.clamp(0, ANCHOR_BINS - 1),
                          minlength=ANCHOR_BINS).cpu().numpy()
    c = np.cumsum(hist)
    total = c[-1]
    if total == 0:
        return F(hi_y)
    idx = int(np.argmax(c.astype(F) >= F(0.999) * F(total)))
    top = F(lo_y + F(F(idx) + F(1.0)) * F(ext / F(ANCHOR_BINS)))
    return min(F(top + F(band_height)), F(hi_y))


def cells_of(pos: torch.Tensor, valid: torch.Tensor, d: float, cfg: dict):
    """Each point's flat (band, x cell, z cell) index, i64[N] on the
    device, and the grid's (lo, s) on the host."""
    g, nb = cfg["grid_size"], cfg["max_bands"]
    lo, hi = box(pos, valid)
    ext = max(F(hi[0] - lo[0]), F(hi[2] - lo[2]))
    s = max(F(d), F(ext / F(g - 1)))
    top = anchor_top(pos[:, 1], valid, lo[1], hi[1], cfg["band_height"])

    def index(v, origin, size, n):
        return torch.floor((v - _c(origin, v)) / _c(size, v)).clamp(
            0, n - 1).long()
    band = torch.floor((_c(top, pos) - pos[:, 1])
                       / _c(cfg["band_height"], pos)).clamp(0, nb - 1).long()
    cx = index(pos[:, 0], lo[0], s, g)
    cz = index(pos[:, 2], lo[2], s, g)
    return (band * g + cx) * g + cz, lo, s


def clusters(count: np.ndarray, occ: np.ndarray, lo, s, cfg: dict):
    """Steps 4-5: per band, the kept clusters' centroids f32[B,C,2] and
    mask bool[B,C], from the point counts i32[B,G,G] of the occupied cells
    ``occ`` (flat indices, ascending, at most ``cc_occupied_cap``)."""
    nb, g, _ = count.shape
    gg = g * g
    c_cap = cfg["max_trees_per_band"]
    # 8-connected within a band, never across bands
    structure = np.zeros((3, 3, 3), bool)
    structure[1] = True
    labels, _ = ndimage.label(count > 0, structure=structure)
    comp = labels.reshape(-1)[occ]
    # a component's name: its lowest cell (occ is ascending)
    first = np.unique(comp, return_index=True)
    root_of = np.zeros(comp.max() + 1 if comp.size else 1, np.int64)
    root_of[first[0]] = occ[first[1]]
    root = root_of[comp]
    w = count.reshape(-1)[occ].astype(np.int64)
    cell = occ % gg
    ccx = F(lo[0]) + ((cell // g).astype(F) + F(0.5)) * s
    ccz = F(lo[2]) + ((cell % g).astype(F) + F(0.5)) * s
    roots, inv = np.unique(root, return_inverse=True)
    n = np.bincount(inv, weights=w).astype(np.int64)
    sx = np.bincount(inv, weights=w * ccx.astype(np.float64))
    sz = np.bincount(inv, weights=w * ccz.astype(np.float64))
    band = roots // gg
    keep = n >= max(cfg["min_points"], 1)
    order = np.lexsort((roots, -n, band))
    order = order[keep[order]]
    cents = np.zeros((nb, c_cap, 2), F)
    mask = np.zeros((nb, c_cap), bool)
    start = np.searchsorted(band[order], np.arange(nb))
    rank = np.arange(order.size) - start[band[order]]
    ok = rank < c_cap
    o, r = order[ok], rank[ok]
    cnt = n[o].astype(F)
    cents[band[o], r, 0] = sx[o].astype(F) / cnt
    cents[band[o], r, 1] = sz[o].astype(F) / cnt
    mask[band[o], r] = True
    return cents, mask


def track(cents: np.ndarray, mask: np.ndarray, radius, rounds: int,
          t_cap: int):
    """Step 6: per band the slots' positions f32[B,T,2] and liveness
    bool[B,T] after that band."""
    nb = cents.shape[0]
    pos = np.zeros((t_cap, 2), F)
    live = np.zeros(t_cap, bool)
    out_pos = np.zeros((nb, t_cap, 2), F)
    out_live = np.zeros((nb, t_cap), bool)
    for b in range(nb):
        c = cents[b]
        free_c = mask[b].copy()
        for _ in range(rounds):
            ts = np.flatnonzero(live)
            cs = np.flatnonzero(free_c)
            if ts.size == 0 or cs.size == 0:
                break
            dx = pos[ts, None, 0] - c[None, cs, 0]
            dz = pos[ts, None, 1] - c[None, cs, 1]
            dist = np.sqrt(dx * dx + dz * dz)
            near_c = np.argmin(dist, axis=1)        # each slot's cluster
            near_t = np.argmin(dist, axis=0)        # each cluster's slot
            rows = np.arange(ts.size)
            mutual = ((near_t[near_c] == rows)
                      & (dist[rows, near_c] <= radius))
            pos[ts[mutual]] = c[cs[near_c[mutual]]]
            free_c[cs[near_c[mutual]]] = False
        new = np.flatnonzero(free_c)
        slots = np.flatnonzero(~live)[:new.size]
        pos[slots] = c[new[:slots.size]]
        live[slots] = True
        out_pos[b], out_live[b] = pos, live
    return out_pos, out_live


def nearest_slot(occ: np.ndarray, g: int, lo, s, slot_pos: np.ndarray,
                 slot_live: np.ndarray) -> np.ndarray:
    """Step 7: the nearest live slot of each occupied cell's band, -1 where
    the band has none.  A k-d tree gives each cell's four nearest slots;
    the f32 squared distances decide among them, ties to the lower slot."""
    gg = g * g
    band = occ // gg
    cell = occ % gg
    cx = F(lo[0]) + ((cell // g).astype(F) + F(0.5)) * s
    cz = F(lo[2]) + ((cell % g).astype(F) + F(0.5)) * s
    out = np.full(occ.size, -1, np.int64)
    for b in np.unique(band):
        at = np.flatnonzero(band == b)
        slots = np.flatnonzero(slot_live[b])
        if slots.size == 0:
            continue
        sp = slot_pos[b, slots]
        k = min(4, slots.size)
        _, cand = spatial.cKDTree(sp.astype(np.float64)).query(
            np.stack([cx[at], cz[at]], 1).astype(np.float64), k=k)
        cand = cand.reshape(at.size, k)
        ex = cx[at, None] - sp[cand, 0]
        ez = cz[at, None] - sp[cand, 1]
        dist = ex * ex + ez * ez
        # ties: the lower slot (slots ascend, so the lower candidate index
        # after sorting each row's candidates)
        srt = np.argsort(cand, axis=1)
        cand = np.take_along_axis(cand, srt, 1)
        dist = np.take_along_axis(dist, srt, 1)
        out[at] = slots[cand[np.arange(at.size), np.argmin(dist, axis=1)]]
    return out


def segment(pos: torch.Tensor, valid: torch.Tensor, d: float,
            cfg: dict) -> torch.Tensor:
    """Each point's segment id, i32[N] (0: none), by steps 1-7."""
    g, nb = cfg["grid_size"], cfg["max_bands"]
    flat, lo, s = cells_of(pos, valid, d, cfg)
    count = torch.bincount(flat[valid], minlength=nb * g * g).cpu().numpy()
    count = count.reshape(nb, g, g)
    occ = np.flatnonzero(count.reshape(-1))[:cfg["cc_occupied_cap"]]
    cents, mask = clusters(count, occ, lo, s, cfg)
    radius = F(F(cfg["match_radius_factor"]) * F(d))
    slot_pos, slot_live = track(cents, mask, radius, cfg["match_rounds"],
                                cfg["max_segments"])
    slot = np.full(nb * g * g, -1, np.int64)
    slot[occ] = nearest_slot(occ, g, lo, s, slot_pos, slot_live)
    got = torch.from_numpy(slot).to(pos.device)[flat]
    return torch.where(valid & (got >= 0), got + 1, 0).to(torch.int32)


# ---- the segment table and the classes (calculations.rs) ---------------

def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once from f64 (the product of two f32 is
    exact there), as the TPU system contracts a product into a sum."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64,
                                         device=a.device)
            + torch.as_tensor(c, dtype=torch.float64,
                              device=a.device)).float()


def _recip(c: float) -> np.float32:
    """The f32 reciprocal of the constant ``c``: a division by a constant
    is the product with it."""
    return F(F(1.0) / F(c))


def _directions(k: int) -> np.ndarray:
    """f32[2,K] unit vectors at angles 2 pi i / K, correctly rounded."""
    a = (np.arange(k, dtype=F) * F(2.0 * math.pi / k)).astype(np.float64)
    return np.stack([np.cos(a), np.sin(a)]).astype(F)


def polygon_area(sup: np.ndarray, k: int) -> np.ndarray:
    """Area of the convex polygon {p : p . u_i <= sup_i} for the K support
    values of each row (f64 arithmetic); 0 for rows without points."""
    u = _directions(k).astype(np.float64)
    s = sup.astype(np.float64)
    s1 = np.roll(s, -1, axis=1)
    ux, uz = u[0], u[1]
    nx, nz = np.roll(ux, -1), np.roll(uz, -1)
    det = ux * nz - uz * nx
    vx = (s * nz - s1 * uz) / det
    vz = (s1 * ux - s * nx) / det
    wx, wz = np.roll(vx, -1, axis=1), np.roll(vz, -1, axis=1)
    area = 0.5 * np.abs((vx * wz - wx * vz).sum(axis=1))
    return np.where(sup[:, 0] > -INF, area, 0.0).astype(F)


def _first(cond: np.ndarray):
    return cond.argmax(axis=1), cond.any(axis=1)


def separators(areas: np.ndarray, min_y: np.ndarray, n_slices: np.ndarray,
               cfg: dict):
    """(ground_sep, crown_sep) f32[S] from the slices' areas: see
    :func:`segment_table`."""
    ms, sw = cfg["max_slices"], cfg["slice_width"]
    idx = np.arange(ms)[None, :]
    in_range = idx < n_slices[:, None]
    lo_i = int(1.0 / sw)
    hi_i = lo_i + int(10.0 / sw)
    m = in_range & (idx >= lo_i) & (idx < hi_i)
    min_area = np.where(m, areas, INF).min(axis=1)
    min_area = np.where(m.any(axis=1), min_area, F(0.5))
    min_area = np.maximum(min_area, F(cfg["min_area_floor"])).astype(F)
    thresh = (min_area * F(cfg["ground_min_area_scale"]))[:, None]
    g_lim = int(cfg["ground_max_search_height"] / sw)
    g_idx, g_found = _first(in_range & (idx < g_lim) & (areas > thresh))
    half = (n_slices // 2)[:, None]
    s_idx, s_found = _first((idx >= g_idx[:, None]) & (idx < half)
                            & (areas < thresh))
    ground_i = np.where(g_found & s_found, s_idx, 0)
    crown_area = F(math.pi * (cfg["min_crown_diameter"] / 2.0) ** 2)
    c_idx, c_found = _first(in_range & (idx >= ground_i[:, None])
                            & (areas > crown_area))
    crown_i = np.where(c_found, c_idx, 0)
    return ((min_y + ground_i.astype(F) * F(sw)).astype(F),
            (min_y + crown_i.astype(F) * F(sw)).astype(F))


def segment_table(pos: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                  n_seg: int, cfg: dict):
    """The segment table (a dict of host arrays with S = ``n_seg`` rows,
    row 0 unused) and each point's class (0 ground, 1 trunk, 2 crown),
    i32[N] on the points' device.

    Heights are read on a grid of 2^q levels over the scene's y range; each
    segment's points fall into 0.1 m slices above its lowest point; a
    slice's area is that of its 8-direction support polygon.  ``min_area``
    is the least area in slices 1-11 m up (at least 0.5 m^2); the ground
    is the first slice below 1 m wider than 1.5 ``min_area``, the
    ground/trunk split the first slice after it, in the lower half, that is
    narrower; the trunk/crown split the first slice above that with more
    than pi (min_crown_diameter / 2)^2.  A point is ground below its
    segment's first split, trunk below the second, crown above; the splits
    are read on a 16-bit grid over the scene's y range.
    """
    ms, sw, kd = cfg["max_slices"], cfg["slice_width"], cfg["hull_directions"]
    dev = pos.device
    y = pos[:, 1]
    live = valid & (seg > 0) & (seg < n_seg)
    if bool(valid.any()):
        ylo, yhi = F(y[valid].amin().item()), F(y[valid].amax().item())
    else:
        ylo, yhi = F(0.0), F(1.0)
    yext = max(F(yhi - ylo), F(1e-6))
    qbits = min(19, 31 - max(n_seg.bit_length(), 1))
    qmax = (1 << qbits) - 1

    def level(v, scale, top):
        return ((v - _c(ylo, v)) * _c(F(scale) / yext, v)).long().clamp(
            0, top)
    s_ = seg[live].long()
    yq = _fma(level(y[live], qmax, qmax).float(), F(yext * _recip(qmax)),
              ylo)
    count = torch.bincount(s_, minlength=n_seg)
    present = count > 0
    min_y = torch.full((n_seg,), float(INF), device=dev).scatter_reduce(
        0, s_, yq, "amin")
    max_y = torch.full((n_seg,), -float(INF), device=dev).scatter_reduce(
        0, s_, yq, "amax")
    min_y = torch.where(present, min_y, 0.0)
    max_y = torch.where(present, max_y, 0.0)

    sl = torch.floor((yq - min_y[s_]) * _c(_recip(sw), yq)).clamp(
        0, ms - 1).long()
    u = torch.from_numpy(_directions(kd)).to(dev)
    p = pos[live]
    score = _fma(p[:, 0:1], u[0][None, :], p[:, 2:3] * u[1][None, :])
    sup = torch.full((n_seg * ms, kd), -float(INF), device=dev)
    sup.scatter_reduce_(0, (s_ * ms + sl)[:, None].expand(-1, kd), score,
                        "amax")
    areas = polygon_area(sup.cpu().numpy(), kd).reshape(n_seg, ms)
    min_y, max_y = min_y.cpu().numpy(), max_y.cpu().numpy()
    present = present.cpu().numpy()
    n_slices = np.clip(((max_y - min_y) * _recip(sw)).astype(np.int64) + 1,
                       1, ms)
    ground_sep, crown_sep = separators(areas, min_y, n_slices, cfg)
    zero = np.zeros(n_seg, F)
    table = {
        "present": present,
        "count": count.to(torch.int32).cpu().numpy(),
        "lo": np.stack([zero, min_y, zero], -1),
        "hi": np.stack([zero, max_y, zero], -1),
        "areas": areas,
        "n_slices": n_slices.astype(np.int32),
        "ground_sep": ground_sep,
        "crown_sep": crown_sep,
        "trunk_height": np.where(present, crown_sep - ground_sep,
                                 0.0).astype(F),
        "crown_height": np.where(present, max_y - crown_sep, 0.0).astype(F),
    }

    step = F(yext * _recip(65535.0))
    seps = torch.from_numpy(np.stack([ground_sep, crown_sep])).to(dev)
    gs, cs = _fma(level(seps, 65535.0, 65535).float(), step, ylo)
    yl = y[live]
    cls_ = torch.zeros_like(seg)
    cls_[live] = torch.where(yl < gs[s_], 0, torch.where(yl < cs[s_], 1,
                                                           2)).to(seg.dtype)
    return table, cls_
