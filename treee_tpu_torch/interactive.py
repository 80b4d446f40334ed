"""Interactive edits, the port of ``treee_tpu/interactive.py``.

Sphere-brush removal and reassignment, restoring deleted points,
reclassification, segment combine, spawning a new segment, and ray picking.
Every edit is a masked elementwise update of the fixed SoA arrays on the
cloud's device that returns a new ``PointCloud``; moving a point between
segments is writing one i32.  So an edit of a point-sharded cloud is the
same edit of each shard (``ShardedCloud.map``); picking is a shard program.

The JAX package jits these functions, so its sphere radius is traced and
squared in f32; here the radius is made an f32 tensor and squared the same
way.  Distances are summed as ``(a + b) + c``.
"""

from __future__ import annotations

import torch

from .cloud import DELETED_SEGMENT, PointCloud
from .parallel.program import run_alone

INF = 3.0e38
# sentinels of a sharded pick's row and segment mins
ROW_MAX = torch.iinfo(torch.int64).max
SEGMENT_MAX = torch.iinfo(torch.int32).max


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def _in_sphere(cloud: PointCloud, center, radius) -> torch.Tensor:
    d = cloud.pos - _f32(center, cloud.pos)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    r = _f32(radius, cloud.pos)
    return cloud.valid & ((dx * dx + dy * dy) + dz * dz <= r * r)


def _set_segment(cloud: PointCloud, hit: torch.Tensor, target) -> PointCloud:
    return cloud.replace(segment=torch.where(
        hit, torch.as_tensor(target, dtype=torch.int32).to(hit.device),
        cloud.segment))


def remove_points(cloud: PointCloud, center, radius,
                  target: int = DELETED_SEGMENT,
                  source: int = -1) -> PointCloud:
    """Move every in-sphere point to ``target``.

    ``source`` >= 0 restricts the edit to one segment (the focused view's
    delete); -1 edits every segment but the deleted one (the whole-forest
    Delete and Draw modes).
    """
    hit = _in_sphere(cloud, center, radius)
    src_ok = (cloud.segment == source if source >= 0
              else cloud.segment != DELETED_SEGMENT)
    return _set_segment(cloud, hit & src_ok, target)


def restore_deleted(cloud: PointCloud, center, radius,
                    target: int) -> PointCloud:
    """Pull the deleted points inside the brush into ``target``."""
    hit = (_in_sphere(cloud, center, radius)
           & (cloud.segment == DELETED_SEGMENT))
    return _set_segment(cloud, hit, target)


def change_classification(cloud: PointCloud, center, radius,
                          classification: int, segment: int) -> PointCloud:
    """Reclassify the in-sphere points of one segment."""
    hit = _in_sphere(cloud, center, radius) & (cloud.segment == segment)
    return cloud.replace(classification=torch.where(
        hit, torch.as_tensor(classification, dtype=torch.int32).to(hit.device),
        cloud.classification))


def combine_segments(cloud: PointCloud, a: int, b: int) -> PointCloud:
    """Merge segment ``a`` into ``b``."""
    return _set_segment(cloud, cloud.segment == a, b)


def spawn_segment(cloud: PointCloud, center, radius,
                  new_id: int) -> PointCloud:
    """Carve a new segment out of every alive point in the sphere."""
    hit = (_in_sphere(cloud, center, radius)
           & (cloud.segment != DELETED_SEGMENT))
    return _set_segment(cloud, hit, new_id)


def pick(cloud: PointCloud, origin: torch.Tensor, direction: torch.Tensor,
         point_scale, include_deleted: bool = False):
    """The first point a ray hits -> (segment id i32[], along-ray distance
    f32[], hit bool[]), on the cloud's device.

    A point is hit when its distance from the ray is within the splat radius
    ``point_scale`` and it lies ahead of ``origin``; the nearest along the
    ray wins, the lowest row among equals (``argmin``).  The products are
    f32 multiplies and sums, never a matrix product, so that TF32 cannot
    lower their precision (the JAX package runs its dot at HIGHEST).
    """
    return run_alone(pick_shard(cloud, origin, direction, point_scale,
                                include_deleted, across=False))


def pick_shard(cloud: PointCloud, origin, direction, point_scale,
               include_deleted: bool, across: bool, index: int = 0):
    """:func:`pick` as a shard program of shard ``index`` (rows
    ``index * capacity`` on): each shard's nearest hit, then three mins over
    the shards (the distance, the lowest global row at it, that row's
    segment), so the winner is the one-device winner."""
    eligible = cloud.valid
    if not include_deleted:
        eligible = eligible & (cloud.segment != DELETED_SEGMENT)
    diff = cloud.pos - _f32(origin, cloud.pos)
    u = _f32(direction, cloud.pos)
    dx, dy, dz = diff[:, 0], diff[:, 1], diff[:, 2]
    along = (dx * u[0] + dy * u[1]) + dz * u[2]
    perp2 = ((dx * dx + dy * dy) + dz * dz) - along * along
    ps = _f32(point_scale, cloud.pos)
    ok = eligible & (along >= 0.0) & (perp2 <= ps * ps)
    dist = torch.where(ok, along, INF)
    best = torch.argmin(dist)
    best_dist, seg = dist[best], cloud.segment[best]
    if across:
        row = best + index * cloud.capacity
        gmin = yield "min", best_dist
        win = yield "min", torch.where(best_dist == gmin, row, ROW_MAX)
        seg = yield "min", torch.where(row == win, seg, SEGMENT_MAX)
        best_dist = gmin
    found = best_dist < INF
    return torch.where(found, seg, -1), best_dist, found


def segment_exists(cloud: PointCloud, seg: int) -> torch.Tensor:
    """bool[]: whether any valid point carries segment ``seg``."""
    return (cloud.valid & (cloud.segment == seg)).any()
