"""The focused single-tree view (the upstream's View mode,
``interactive/mod.rs:770-800``), written from its published steps as the
TPU system states them: one segment's points coloured by their curvature,
with the crown hull, the radial bounding volumes (RBVs) and the trunk axis
drawn over them.  NumPy and SciPy on the host for the tree's geometry,
PyTorch on the points' device for the frame.  Nothing here is the port's
code.

For the points ``pos`` f32[N,3] of one segment (its ids and classes from
``segment.py``) and a camera:

1. **Curvature** (``calculations.rs:328-373``): each member's 31 nearest
   members, itself included (a k-d tree, ``scipy.spatial.cKDTree``, exact
   distances in f64); their covariance, the outer products of the
   differences from their mean summed and divided by their count; then
   ``3 lambda_min / trace`` of its eigenvalues (``numpy.linalg.eigvalsh``),
   0 where the trace is not above 1e-20.  All in f64.
2. **Crown hull** (``hull.rs:15-67, 447-580``): the convex hull of every
   crown member (qhull, f64); none below 10 points or for a flat set.  Its
   edges are those of its triangles.
3. **Trunk axis**, the average direction (``trunk_axis.rs:108-178``): over
   the trunk members, ``lo`` and ``hi`` their least and largest height; the
   origin is (the mean x and z of the points 0.4-0.6 m above ``lo``, else
   of the lowest layer; ``lo``); ten layers of height ``(hi - lo) / 10``
   (at least 1e-6); the direction is the sum, normalised, of the unit
   vectors from the origin to each non-empty layer's (mean x, mid-height,
   mean z).  With no trunk point the axis is +y at the origin and is not
   drawn.  Its frame (``trunk_axis.rs:56-70``): y the direction, x the
   normalised ``y x (0, 0, 1)``, z = ``x x y``.  Its lines
   (``trunk_axis.rs:24-43``): origin to origin + direction times the
   members' height extent, and a cross of 2.5 m arms in x and z.
4. **RBVs**, the max method (``hull.rs:185-208, 631-858``): the crown's
   members in 26 slices x 32 sectors and the trunk's in 5 x 32, in the
   axis frame: slices of ``(max - min) / slices`` (at least 1e-6) above
   the least height, sectors of ``2 pi / 32`` counted from ``atan2(z, x)
   + 2 pi``; each cell holds the largest distance from the axis of its
   points, 0 where it has none.  The cage (``hull.rs:780-841``): per slice
   the axis from its bottom to its top; per sector the radials at both
   heights, the outer vertical and a 4-piece arc at each height, each
   point at its cell's distance, mapped back through the axis frame.
5. **Frame**: ``frame.py``'s z-buffer, splat growth and eye-dome over the
   members, each point's colour the palette entry ``floor(256 c)``
   (clamped to 0-255) of its curvature c; every line of steps 2-4 is drawn
   black where it is in front of the grown splats.

Departures from the upstream, and what the TPU system states instead:

- the upstream draws lines as GPU line primitives; here, as the TPU
  system states its overlay, each line is 32 points at ``t = i / 31``
  (``f32(1/31)`` times i, the last exactly 1) projected like the splats'
  centres, and a point paints its pixel where its depth is at most the
  pixel's grown splat depth plus 2e-4;
- the axis's layer height, layers and band (step 3) are bounded in f32,
  as the upstream's ``f32`` points are, and its sums taken in f64 and
  rounded once to f32; everything else is in f64;
- the RBVs are centred on the trunk axis, as the focused view draws them
  (the upstream's untilted RBV centres on a Ritter sphere instead).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import spatial

from . import frame

F = np.float32
K_NEIGHBOURS = 31
CROWN, TRUNK = 2, 1
AXIS_LAYERS = 10
RBV_GRIDS = ((CROWN, 26, 32), (TRUNK, 5, 32))
ARC_DETAIL = 4
LINE_SAMPLES = 32
DEPTH_BIAS = 2e-4
# the inverse of the colour hash's multiplier modulo 2^32: the id whose
# hash has the palette entry e in its top 8 bits is (e << 24) * INV
INV_HASH = pow(2654435761, -1, 1 << 32)


def curvature(p: np.ndarray, k: int = K_NEIGHBOURS) -> np.ndarray:
    """Step 1: f64[M] of the members' positions f32[M,3]."""
    if len(p) == 0:
        return np.zeros(0)
    q = p.astype(np.float64)
    _, nb = spatial.cKDTree(q).query(q, k=min(k, len(q)))
    nbrs = q[nb.reshape(len(q), -1)]
    d = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", d, d) / nbrs.shape[1]
    ev = np.linalg.eigvalsh(cov)
    tr = ev.sum(axis=1)
    return np.where(tr > 1e-20, 3.0 * ev[:, 0] / np.where(tr > 0, tr, 1.0),
                    0.0)


def hull_lines(p: np.ndarray) -> np.ndarray:
    """Step 2: the crown hull's edges f32[L,2,3]."""
    if len(p) < 10:
        return np.zeros((0, 2, 3), F)
    try:
        q = spatial.ConvexHull(p.astype(np.float64))
    except spatial.QhullError:
        return np.zeros((0, 2, 3), F)
    s = q.simplices
    e = np.sort(np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]]),
                axis=1)
    return p[np.unique(e, axis=0)].astype(F)


def trunk_axis(p: np.ndarray):
    """Step 3: (origin f64[3], direction f64[3], found) of the trunk's
    points f32[T,3]."""
    if len(p) == 0:
        return np.zeros(3), np.array([0.0, 1.0, 0.0]), False
    y = p[:, 1]
    lo, hi = y.min(), y.max()
    layer_h = max(F(F(hi - lo) / F(AXIS_LAYERS)), F(1e-6))
    layer = np.clip(((y - lo) / layer_h).astype(np.int64), 0,
                    AXIS_LAYERS - 1)
    band = (y >= lo + F(0.4)) & (y < lo + F(0.6))
    xz = p[:, [0, 2]].astype(np.float64)
    n = np.bincount(layer, minlength=AXIS_LAYERS).astype(np.float64)
    sums = np.stack([np.bincount(layer, xz[:, c], AXIS_LAYERS)
                     for c in (0, 1)], 1)
    means = (sums.astype(F) / np.maximum(n, 1.0).astype(F)[:, None])
    if band.any():
        ox, oz = (xz[band].sum(0).astype(F) / F(band.sum()))
    else:
        ox, oz = means[0]
    origin = np.array([ox, lo, oz], np.float64)
    heights = lo + (np.arange(AXIS_LAYERS) + 0.5) * np.float64(layer_h)
    vec = np.stack([means[:, 0], heights, means[:, 1]], 1) - origin
    unit = vec / np.maximum(np.linalg.norm(vec, axis=1), 1e-6)[:, None]
    direction = unit[n > 0].sum(0)
    return origin, direction / max(np.linalg.norm(direction), 1e-6), True


def axis_frame(origin: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """The 4x4 frame of step 3: columns x, y, z and the origin."""
    y = direction
    x = np.cross(y, [0.0, 0.0, 1.0])
    x /= max(np.linalg.norm(x), 1e-6)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2], t[:3, 3] = x, y, np.cross(x, y), origin
    return t


def rbv_grid(p: np.ndarray, tf: np.ndarray, slices: int, sectors: int):
    """Step 4's grid of the points f32[M,3] in the frame ``tf``: (the least
    height, the slice height, f64[slices, sectors] distances)."""
    local = (p.astype(np.float64) - tf[:3, 3]) @ tf[:3, :3]
    x, y, z = local[:, 0], local[:, 1], local[:, 2]
    lo = y.min() if len(p) else 0.0
    hi = y.max() if len(p) else 1.0
    sh = max((hi - lo) / slices, 1e-6)
    si = np.clip(((y - lo) / sh).astype(np.int64), 0, slices - 1)
    width = 2.0 * math.pi / sectors
    sec = np.clip((((np.arctan2(z, x) + 2.0 * math.pi) / width) % sectors)
                  .astype(np.int64), 0, sectors - 1)
    d = np.zeros(slices * sectors)
    np.maximum.at(d, si * sectors + sec, np.sqrt(x * x + z * z))
    return lo, sh, d.reshape(slices, sectors)


def rbv_lines(lo: float, sh: float, d: np.ndarray,
              tf: np.ndarray) -> np.ndarray:
    """Step 4's cage f32[L,2,3] of the grid ``d`` f64[slices, sectors]
    above ``lo`` in slices of ``sh``, in the frame ``tf``."""
    slices, sectors = d.shape
    width = 2.0 * math.pi / sectors
    ang = width * (np.arange(sectors)[:, None]
                   + np.arange(ARC_DETAIL + 1)[None, :] / ARC_DETAIL)
    cx, cz = np.cos(ang) * d[..., None], np.sin(ang) * d[..., None]
    out = []
    for i in range(slices):
        y0, y1 = lo + sh * i, lo + sh * (i + 1)
        out.append([[0.0, y0, 0.0], [0.0, y1, 0.0]])
        for j in range(sectors):
            q0 = np.stack([cx[i, j], np.full(ARC_DETAIL + 1, y0), cz[i, j]], 1)
            q1 = np.stack([cx[i, j], np.full(ARC_DETAIL + 1, y1), cz[i, j]], 1)
            out += [[[0.0, y0, 0.0], q0[0]], [[0.0, y1, 0.0], q1[0]],
                    [q0[0], q1[0]]]
            for a in range(1, ARC_DETAIL + 1):
                out += [[q0[a - 1], q0[a]], [q1[a - 1], q1[a]]]
    lines = np.asarray(out, np.float64)
    return (lines @ tf[:3, :3].T + tf[:3, 3]).astype(F)


def overlay_lines(p: np.ndarray, cls_: np.ndarray) -> np.ndarray:
    """Steps 2-4: every line f32[L,2,3] over the members ``p`` of
    classes ``cls_``."""
    trunk = p[cls_ == TRUNK]
    origin, direction, found = trunk_axis(trunk)
    tf = axis_frame(origin, direction)
    parts = [hull_lines(p[cls_ == CROWN])]
    for c, slices, sectors in RBV_GRIDS:
        parts.append(rbv_lines(*rbv_grid(p[cls_ == c], tf, slices, sectors),
                               tf))
    if found:
        o, d = origin.astype(F), direction.astype(F)
        extent = F(p[:, 1].max() - p[:, 1].min())
        arm = [np.array([2.5, 0, 0], F), np.array([0, 0, 2.5], F)]
        parts.append(np.array([[o, o + d * extent], [o - arm[0], o + arm[0]],
                               [o - arm[1], o + arm[1]]], F))
    return np.concatenate(parts)


def project(pts: torch.Tensor, transform: np.ndarray, cfg: dict):
    """(pixel x i64, pixel y i64, view depth, NDC depth) of points, as
    ``frame.z_buffer`` projects the splats' centres."""
    w, h = cfg["width"], cfg["height"]
    t = np.asarray(transform, np.float64)
    rot = t[:3, :3].T
    view = np.concatenate([rot, -(rot @ t[:3, 3])[:, None]], 1).astype(F)
    view = torch.from_numpy(view).to(pts.device)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def row(i):
        return (((x * view[i, 0] + y * view[i, 1]) + z * view[i, 2])
                + view[i, 3])

    vx, vy, vz = row(0), row(1), row(2)
    depth = -vz
    p00, p11, p22, p23 = (frame._c(v, x) for v in frame.projection(cfg))
    wc = torch.clamp(depth, min=F(1e-6))
    half = frame._c(0.5, x)
    fx = ((p00 * vx) / wc * half + half) * frame._c(w, x)
    fy = (frame._c(1.0, x) - ((p11 * vy) / wc * half + half)) * frame._c(h, x)
    z01 = (p22 * vz + p23) / wc
    return (torch.floor(fx.clamp(-1, w)).long(),
            torch.floor(fy.clamp(-1, h)).long(), depth, z01)


def painted(lines: np.ndarray, k: torch.Tensor, transform: np.ndarray,
            cfg: dict) -> torch.Tensor:
    """bool[H,W]: the pixels the lines f32[L,2,3] paint over the grown key
    image ``k``."""
    h, w = k.shape
    out = torch.zeros(h * w + 1, dtype=torch.bool, device=k.device)
    if len(lines):
        t = np.arange(LINE_SAMPLES, dtype=F) * F(1.0 / (LINE_SAMPLES - 1))
        t[-1] = 1.0
        ab = torch.from_numpy(lines).to(k.device)
        tt = torch.from_numpy(t).to(k.device)[None, :, None]
        s = (ab[:, 0:1] + (ab[:, 1:2] - ab[:, 0:1]) * tt).reshape(-1, 3)
        ix, iy, depth, z01 = project(s, transform, cfg)
        ok = ((depth > frame._c(cfg["near"], z01))
              & (depth < frame._c(cfg["far"], z01))
              & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h))
        pix = torch.where(ok, iy * w + ix, h * w)
        zk = torch.where(k != frame.IBIG, (k >> 8).float()
                         * frame._c(frame.ZSCALE, z01), 1.0).reshape(-1)
        ref = zk[pix.clamp(0, h * w - 1)]
        seen = ok & (z01 <= ref + frame._c(DEPTH_BIAS, z01))
        out[torch.where(seen, pix, h * w)] = True
    return out[:h * w].view(h, w)


def shade(k: torch.Tensor, lines_px: torch.Tensor, cfg: dict) -> np.ndarray:
    """``frame.shade`` with the lines' pixels painted black before the
    eye-dome: u8[H,W,3] on the host."""
    hit = k != frame.IBIG
    pal = torch.from_numpy(frame.turbo()).to(k.device)
    bg = torch.tensor(cfg["background"], dtype=torch.float32,
                      device=k.device)
    colour = torch.where(hit[..., None], pal[k & 255], bg)
    colour = torch.where(lines_px[..., None], 0.0, colour)
    z01 = torch.where(hit, (k >> 8).float() * frame._c(frame.ZSCALE, k), 1.0)
    n, fr = cfg["near"], cfg["far"]
    n2, fpn = frame._c(2.0 * n, z01), frame._c(fr + n, z01)
    fmn = frame._c(fr - n, z01)
    s = frame._c(max(1.0 - cfg["eye_dome_strength"], 0.1) ** 6, z01)
    lin = torch.where(z01 >= 1, 1.0, n2 / (fpn - z01 * fmn))
    e = torch.nn.functional.pad(lin[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    m = torch.maximum(torch.maximum(e[:-2, 1:-1], e[2:, 1:-1]),
                      torch.maximum(e[1:-1, :-2], e[1:-1, 2:]))
    m = torch.minimum(torch.maximum(m, lin), lin + s)
    alpha = torch.where(z01 < 1, (m - lin) / s, 0.0)[..., None]
    ed = torch.tensor(cfg["eye_dome_color"], dtype=torch.float32,
                      device=k.device)
    out = colour * (1.0 - alpha) + ed * alpha
    return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu(
        ).numpy()


def focus(pos: torch.Tensor, valid: torch.Tensor, ids: torch.Tensor,
          classes: torch.Tensor, sid: int, transform: np.ndarray,
          cfg: dict) -> dict:
    """The focused view of segment ``sid`` from the camera ``transform``
    (camera-to-world, -z forward): ``members`` i64[M] (its rows, ascending),
    ``curvature`` f64[M] and ``frame`` u8[H,W,3]."""
    member = valid & (ids == sid) if sid > 0 else torch.zeros_like(valid)
    rows = torch.nonzero(member).flatten()
    p = pos[rows].cpu().numpy()
    c = curvature(p)
    entry = np.clip((c.astype(F) * F(256.0)).astype(np.int64), 0, 255)
    fake = torch.zeros(len(pos), dtype=torch.int64, device=pos.device)
    fake[rows] = torch.from_numpy(((entry << 24) * INV_HASH)
                                  & 0xFFFFFFFF).to(pos.device)
    k = frame.grow(frame.z_buffer(pos, member, fake, transform, cfg), cfg)
    lines = overlay_lines(p, classes[rows].cpu().numpy())
    return {"members": rows.cpu().numpy(), "curvature": c,
            "frame": shade(k, painted(lines, k, transform, cfg), cfg)}
