"""3-D convex hull of a focused segment (the crown hull); the port of
``treee_tpu/hull3d.py``.

The reference gift-wraps the filtered points (treee/src/interactive/
hull.rs:447-580), a sequential edge queue, and so draws the exact hull of
every crown point.  Here the work splits in three:

1. On the device, the candidate set shrinks to the support points of K
   directions on a Fibonacci sphere: each direction's highest score
   ``p . u`` (f32 products and adds, no matrix multiply), lowest index on
   ties, directions in chunks so the live score buffer stays [N, chunk].
   Every hull vertex of the candidates is an extreme point of the cloud.
2. On the host, qhull (``scipy.spatial.ConvexHull``, f64) over the <= K
   candidates gives their hull's face planes.  Back on the device, every
   masked point strictly inside all of those planes, by more than a bound
   on the f32 rounding of its test, is dropped (Akl and Toussaint's
   interior discard): it lies inside the candidates' hull, so it is no
   vertex of the whole hull.  A point within the bound of a plane stays.
3. On the host, qhull over the candidates and the points that stayed:
   its vertices are those of qhull over every masked point.

Only the candidate rows and the rows that stayed cross to the host: for a
crown of tens of thousands of points, a few thousand.  ``exact=True`` skips
steps 1-2 (qhull over every masked point).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve
from .utils.profiling import waited

INF = 3.0e38
# directions scored at once: the live score buffer is [N, SUPPORT_CHUNK]
SUPPORT_CHUNK = 16
# face planes tested at once by the interior discard: [N, PLANE_CHUNK]
PLANE_CHUNK = 64
# the interior discard's margin, in units of f32's epsilon times the
# points' and planes' scale: the test's rounding (the centred coordinates,
# the planes rounded to f32, three products and three adds) stays below
# ~8 such units, so a point the test drops lies inside every plane
MARGIN_EPS = 64


@dataclasses.dataclass
class HullResult:
    vertices: np.ndarray   # f32[V,3] hull vertex positions
    faces: np.ndarray      # i32[F,3] indices into ``vertices``
    point_ids: np.ndarray  # i32[V] original point indices (for exports)
    area: float
    volume: float


def _fibonacci_sphere(k: int) -> np.ndarray:
    i = np.arange(k) + 0.5
    phi = np.arccos(1 - 2 * i / k)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    ).astype(np.float32)


def support_candidates(pos: torch.Tensor, mask: torch.Tensor,
                       dirs: torch.Tensor) -> torch.Tensor:
    """i32[K]: the index of the support point of each direction of
    ``dirs`` f32[K,3] among the masked rows of ``pos``, the lowest index on
    ties; -1 everywhere when no row is masked."""
    k = dirs.shape[0]
    out = torch.empty(k, dtype=torch.int32, device=pos.device)
    x, y, z = pos[:, 0:1], pos[:, 1:2], pos[:, 2:3]
    for c0 in range(0, k, SUPPORT_CHUNK):
        d = dirs[c0:c0 + SUPPORT_CHUNK]
        scores = (x * d[:, 0] + y * d[:, 1]) + z * d[:, 2]
        scores = torch.where(mask[:, None], scores, -INF)
        out[c0:c0 + SUPPORT_CHUNK] = torch.argmax(scores, dim=0).to(torch.int32)
    return torch.where(mask.any(), out, -1)


def _outside_planes(pos: torch.Tensor, mask: torch.Tensor,
                   planes: torch.Tensor, margin: float) -> torch.Tensor:
    """bool[N]: the masked rows of ``pos`` that do not lie strictly inside
    every plane by more than ``margin``: the rows the interior discard
    keeps.  ``planes`` f32[F+1,4] holds F planes (outward unit normal,
    offset: x is inside where ``n . (x - c) + offset < 0``) and then the
    centre c in its first three columns."""
    p = pos - planes[-1, :3]
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    worst = torch.full((pos.shape[0],), -INF, dtype=torch.float32,
                       device=pos.device)
    for c0 in range(0, planes.shape[0] - 1, PLANE_CHUNK):
        e = planes[c0:min(c0 + PLANE_CHUNK, planes.shape[0] - 1)]
        d = ((x * e[:, 0] + y * e[:, 1]) + z * e[:, 2]) + e[:, 3]
        worst = torch.maximum(worst, d.amax(dim=1))
    return mask & (worst >= -margin)


def _interior_discard(pos: torch.Tensor, mask: torch.Tensor,
                      cand: np.ndarray, q) -> torch.Tensor:
    """i64 indices of the masked rows that stay after the discard by the
    candidates' hull ``q`` (qhull over ``cand``)."""
    center = cand.mean(axis=0).astype(np.float32)
    planes = np.concatenate([q.equations, [[*center, 0.0]]])   # f64[F+1,4]
    # the offsets for the centred coordinates
    planes[:-1, 3] += planes[:-1, :3] @ center.astype(np.float64)
    scale = float(np.abs(cand - center).max()) + float(
        np.abs(planes[:-1, 3]).max()) + 1.0
    margin = MARGIN_EPS * float(np.finfo(np.float32).eps) * scale
    waited("hull.planes")       # a copy to the device
    keep = _outside_planes(
        pos, mask, torch.from_numpy(planes.astype(np.float32)).to(pos.device),
        margin)
    waited("hull.survivors")
    return torch.nonzero(keep).flatten()


def _rows_to_host(pos: torch.Tensor, rows: torch.Tensor):
    """(ids i32[R], positions f32[R,3]) of ``rows`` on the host."""
    waited("hull.copy", 2)
    return (rows.to(torch.int32).cpu().numpy(),
            pos[rows.long()].cpu().numpy())


def convex_hull(pos, mask, k_dirs: int = 512, exact: bool = False,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> HullResult | None:
    """The exact hull of the masked points; None when degenerate (fewer
    than 10 points, like hull.rs:483-489, or a flat set qhull refuses).
    Tensors stay on their device, numpy inputs go to ``device``; only the
    rows of steps 1-2 (module docstring) leave the device, or every masked
    row where ``exact`` or where they number at most ``k_dirs``."""
    from scipy.spatial import ConvexHull as _QHull
    from scipy.spatial import QhullError

    if not torch.is_tensor(pos):
        pos = torch.as_tensor(np.asarray(pos, np.float32),
                              device=resolve(device))
    mask = torch.as_tensor(mask, device=pos.device)
    waited("hull.count")
    n_masked = int(mask.sum())
    if n_masked < 10:
        return None
    try:
        if exact or n_masked <= k_dirs:
            waited("hull.rows")
            ids, pts = _rows_to_host(pos, torch.nonzero(mask).flatten())
        else:
            waited("hull.directions")       # a copy to the device
            dirs = torch.from_numpy(_fibonacci_sphere(k_dirs)).to(pos.device)
            ids, pts = _rows_to_host(pos, support_candidates(pos, mask, dirs))
            ids, first = np.unique(ids, return_index=True)
            pts = pts[first]
            r_ids, r_pts = _rows_to_host(pos, _interior_discard(
                pos, mask, pts, _QHull(pts.astype(np.float64))))
            ids, first = np.unique(np.concatenate([ids, r_ids]),
                                   return_index=True)
            pts = np.concatenate([pts, r_pts])[first]
        q = _QHull(pts.astype(np.float64))
    except QhullError:
        return None
    vert_local = q.vertices  # indices into pts that are hull vertices
    remap = -np.ones(len(pts), np.int64)
    remap[vert_local] = np.arange(len(vert_local))
    faces = remap[q.simplices].astype(np.int32)
    return HullResult(
        vertices=pts[vert_local].astype(np.float32),
        faces=faces,
        point_ids=ids[vert_local],
        area=float(q.area),
        volume=float(q.volume),
    )


def hull_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges for line rendering (hull.rs indices buffer),
    (lower, higher) vertex pairs in ascending order; unique as one i64 key
    a pair (``np.unique`` over rows sorts them as records, ~10x slower)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1).astype(np.int64)
    n = int(e.max(initial=0)) + 1
    key = np.unique(e[:, 0] * n + e[:, 1])
    return np.stack([key // n, key % n], axis=1).astype(faces.dtype)
