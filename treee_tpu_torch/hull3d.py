"""3-D convex hull of a focused segment (the crown hull); the port of
``treee_tpu/hull3d.py``.

The reference gift-wraps the filtered points (treee/src/interactive/
hull.rs:447-580), a sequential edge queue.  Here the work splits in two:

1. On the device, the candidate set shrinks to the support points of K
   directions on a Fibonacci sphere: each direction's highest score
   ``p . u`` (f32 products and adds, no matrix multiply), lowest index on
   ties, directions in chunks so the live score buffer stays [N, chunk].
   Every hull vertex of the candidates is an extreme point of the cloud.
2. On the host, qhull (``scipy.spatial.ConvexHull``) over the <= K
   candidate rows, which are all that cross to the host.

``exact=True`` skips step 1 (the hull of every masked point).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve

INF = 3.0e38
# directions scored at once: the live score buffer is [N, SUPPORT_CHUNK]
SUPPORT_CHUNK = 16


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


def convex_hull(pos, mask, k_dirs: int = 512, exact: bool = False,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> HullResult | None:
    """The hull of the masked points; None when degenerate (fewer than 10
    points, like hull.rs:483-489, or a flat set qhull refuses).  Tensors
    stay on their device, numpy inputs go to ``device``; only the candidate
    rows leave the device."""
    from scipy.spatial import ConvexHull as _QHull
    from scipy.spatial import QhullError

    if not torch.is_tensor(pos):
        pos = torch.as_tensor(np.asarray(pos, np.float32),
                              device=resolve(device))
    mask = torch.as_tensor(mask, device=pos.device)
    n_masked = int(mask.sum())
    if n_masked < 10:
        return None
    if exact or n_masked <= k_dirs:
        sel = torch.nonzero(mask).flatten()
    else:
        dirs = torch.from_numpy(_fibonacci_sphere(k_dirs)).to(pos.device)
        idx = support_candidates(pos, mask, dirs)
        sel = torch.unique(idx[idx >= 0])
    ids = sel.to(torch.int32).cpu().numpy()
    cand = pos[sel].cpu().numpy()   # only the candidate rows leave the device
    try:
        q = _QHull(cand.astype(np.float64))
    except QhullError:
        return None
    vert_local = q.vertices  # indices into cand that are hull vertices
    remap = -np.ones(len(cand), np.int64)
    remap[vert_local] = np.arange(len(vert_local))
    faces = remap[q.simplices].astype(np.int32)
    return HullResult(
        vertices=cand[vert_local].astype(np.float32),
        faces=faces,
        point_ids=ids[vert_local],
        area=float(q.area),
        volume=float(q.volume),
    )


def hull_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges for line rendering (hull.rs indices buffer)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)
