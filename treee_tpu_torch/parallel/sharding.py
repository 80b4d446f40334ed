"""Point-sharded steps over a list of devices, and one ``Session`` over
them: the PyTorch port of ``treee_tpu/parallel/sharding.py``.

The JAX package runs its mesh mode under one controller: ``shard_map`` over
a ``Mesh``, with ``psum`` / ``pmin`` / ``pmax`` / ``all_gather`` between the
shards.  The port keeps that shape in one process:

- a :class:`Mesh` is a tuple of ``torch.device``s.  A device may appear
  more than once: ``make_mesh(["cuda:0"] * 4)`` runs the whole shard logic
  on one card, ``make_mesh(["cpu"] * 4)`` on the CPU;
- a sharded array is a list of per-shard tensors with equal rows, each on
  its shard's device (:func:`split`, :func:`shard_points`); a
  :class:`ShardedCloud` holds one ``PointCloud`` a shard;
- a shard's step is a *shard program* (``parallel/program.py``): a
  generator that yields each value to combine across the shards as ``(op,
  value)`` and receives the combined value.  :func:`run` drives one program
  per shard in lockstep.  ``"min"``, ``"max"`` and ``"sum"`` gather the
  shards' tensors to the first shard's device, reduce them in shard order
  and copy the result back to each shard's device (:func:`all_min`,
  :func:`all_max`, :func:`all_sum`); ``"gather"`` stacks them ``[D, ...]``
  (:func:`all_gather`: the octree's carries, the previous and next shards'
  scalars); ``"once"`` runs the first shard's callable on its device and
  copies what it returns to the others (the replicated band scan, the DTM's
  flood: one run instead of one a shard, the same result).

Segmentation couples the shards through the global bounds, the anchor
histogram and the band count grids; the table through the y grid, the
segments' counts and y extents and the support table.  Each is an integer
sum or an f32 min or max, which do not depend on the order of the shards,
so a sharded step equals the one-device step bit for bit.

The interactive half needs a Morton-ordered cloud (the ``Session``'s mesh
mode orders its rows once, at ingest, and splits them contiguously): each
shard is then a run of ascending keys, and the shard-local octree sorts
concatenate to the global sort of the real keys.  The LOD and adaptive
masks continue their scans across shards through gathered carries
(``ops/octree.py``'s shard programs), pick takes three mins, the frame one
min of the shards' i32 key images before one dilation and eye-dome, and the
inventory min / max extents and grids (exact) and sums of its float tables
(each shard's own segmented sums, added in shard order, so within float
rounding of one device's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import characteristics as ch
from .. import interactive as edit
from .. import rasters as rs
from .. import rbv
from .. import segmentation as seg
from ..cloud import CLASS_GROUND, PointCloud
from ..config import Config, DEFAULT_CONFIG
from ..device import resolve
from ..ops import morton, octree
from ..ops.f32 import full, order, unorder
from ..render import splat
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a point-sharded cloud, one a shard, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``s), by default
    every CUDA card that torch sees; raises where it sees none."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("torch sees no CUDA card; pass devices=, "
                               "e.g. ['cpu'] * 4")
        devices = [f"cuda:{i}" for i in range(count)]
    out = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(out))


def auto_mesh(device) -> Mesh | None:
    """``mesh="auto"`` (the CLI's ``--mesh auto``): a mesh over every CUDA
    card when ``device`` is a card and torch sees several, else None, one
    device (treee_tpu/pipeline.py:161-168)."""
    if resolve(device).type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


# --- collectives over the shards' tensors ----------------------------------

def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min; floats in the total order of
    ``f32.order`` (-0.0 below +0.0), as the rasters' integer
    scatter takes it, so that no grouping changes a bit."""
    if a.dtype == torch.float32:
        return unorder(torch.minimum(order(a), order(b)))
    return torch.minimum(a, b)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max, floats as in :func:`minimum`."""
    if a.dtype == torch.float32:
        return unorder(torch.maximum(order(a), order(b)))
    return torch.maximum(a, b)


def _fold(xs: list, fn) -> torch.Tensor:
    """``fn`` over the shards' tensors in shard order, on the first one's
    device."""
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x.to(out.device))
    return out


def _to_each(value, xs: list) -> list:
    return [_to(value, x.device) for x in xs]


def all_min(xs: list) -> list:
    """The elementwise min of the shards' tensors, one copy a shard on its
    device."""
    return _to_each(_fold(xs, minimum), xs)


def all_max(xs: list) -> list:
    return _to_each(_fold(xs, maximum), xs)


def all_sum(xs: list) -> list:
    return _to_each(_fold(xs, torch.add), xs)


def all_gather(xs: list) -> list:
    """The shards' tensors stacked ``[D, ...]`` in shard order, one copy a
    shard on its device."""
    return _to_each(torch.stack([x.to(xs[0].device) for x in xs]), xs)


REDUCTIONS = {"min": all_min, "max": all_max, "sum": all_sum,
              "gather": all_gather}


def _to(value, device: torch.device):
    """``value`` (a tensor, or tuples / lists / dataclasses of them) on
    ``device``."""
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, (tuple, list)):
        return type(value)(_to(v, device) for v in value)
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, **{
            f.name: _to(getattr(value, f.name), device)
            for f in dataclasses.fields(value)})
    return value


def run(mesh: Mesh, programs: list) -> list:
    """Drive one shard program a shard in lockstep; returns what each
    returned.  Every program must make the same requests in the same order.
    """
    if len(programs) != mesh.size:
        raise ValueError(f"{len(programs)} programs for {mesh.size} shards")
    replies = [None] * len(programs)
    # each program nests its spans in a stack of its own
    stacks = [profiling.fork() for _ in programs]
    while True:
        requests, returned = [], []
        for program, reply, spans in zip(programs, replies, stacks):
            try:
                with profiling.on_stack(spans):
                    requests.append(program.send(reply))
            except StopIteration as done:
                returned.append(done.value)
        if returned:
            if requests:
                raise RuntimeError("shard programs ended at different steps")
            return returned
        ops = {op for op, _ in requests}
        if len(ops) != 1:
            raise RuntimeError(f"shard programs asked for {sorted(ops)} at "
                               "one step")
        op = ops.pop()
        values = [v for _, v in requests]
        if op == "once":
            # inside the spans of the shard that asked for it
            with profiling.on_stack(stacks[0]):
                result = values[0]()
            replies = [_to(result, d) for d in mesh.devices]
        else:
            replies = REDUCTIONS[op](values)


# --- shard layouts ---------------------------------------------------------

def split(mesh: Mesh, x) -> list:
    """``x`` (a tensor or numpy array) as a sharded array: one equal row
    range a shard, in order, each on its shard's device."""
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split into {mesh.size} "
                         "equal shards")
    rows = x.shape[0] // mesh.size
    return [x[i * rows:(i + 1) * rows].to(d)
            for i, d in enumerate(mesh.devices)]


def gather(xs: list) -> torch.Tensor:
    """A sharded array as one tensor on the first shard's device."""
    return torch.cat([x.to(xs[0].device) for x in xs])


def shard_points(mesh: Mesh, pos, valid):
    """Split padded point arrays (tensors or numpy, f32[N,3] and bool[N])
    into one row range a shard, in the order given.

    Each shard's rows must be a multiple of the anchor histogram's stride
    (``segmentation.ANCHOR_STRIDE``): only then do the shards' strided
    subsamples make up the one-device subsample.  A capacity that is a
    multiple of 1024 * D always is."""
    pos_s, valid_s = split(mesh, pos), split(mesh, valid)
    if pos_s[0].shape[0] % seg.ANCHOR_STRIDE:
        raise ValueError(f"shards of {pos_s[0].shape[0]} rows: each must be a "
                         f"multiple of {seg.ANCHOR_STRIDE}")
    return pos_s, valid_s


def morton_order(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """i64[N] rows in Morton order over the valid points' box, padding
    rows last; a stable sort, so equal keys keep their row order."""
    lo, hi = seg.scene_bounds_raw(pos, valid)
    keys = morton.encode_positions(pos, lo, hi)
    keys = torch.where(valid, keys, torch.iinfo(torch.int32).max)
    return torch.sort(keys, stable=True).indices


def shard_points_morton(mesh: Mesh, pos, valid):
    """Morton-range shards: the points sorted by :func:`morton_order` on
    the host, then split into contiguous shards, each a spatially compact
    run of Z-order cells.  Padding rows sort to the end.

    Returns (pos shards, valid shards, order i64[N]): ``order`` maps a
    shard row (shards concatenated) to the input row.  A one-device run
    equal to these shards' runs takes the reordered rows (``pos[order]``):
    the anchor histogram's stride subsample follows the row order.  The
    ``Session``'s mesh mode orders its rows so at ingest, once, and its
    one-device twin is fed the same rows."""
    pos = torch.as_tensor(pos, dtype=torch.float32).cpu()
    valid = torch.as_tensor(valid, dtype=torch.bool).cpu()
    order = morton_order(pos, valid)
    pos_s, valid_s = shard_points(mesh, pos[order], valid[order])
    return pos_s, valid_s, order.numpy()


def take(xs: list, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (rows of the shards concatenated, on the first shard's
    device) of a sharded array, on the first shard's device: each shard's
    gather of every index, kept where the row is that shard's, so the
    result is the one-device gather bit for bit."""
    dev, rows = xs[0].device, xs[0].shape[0]
    idx = idx.long()
    shard = torch.div(idx, rows, rounding_mode="floor")
    local = idx - shard * rows
    out = None
    for k, x in enumerate(xs):
        got = x[local.to(x.device)].to(dev)
        if out is None:
            out = got
        else:
            at = (shard == k).view((-1,) + (1,) * (got.dim() - 1))
            out = torch.where(at, got, out)
    return out


def put(fill: list, idx: torch.Tensor, keep: torch.Tensor,
        values: torch.Tensor) -> list:
    """A copy of the sharded array ``fill`` with ``values`` written at the
    rows ``idx`` where ``keep`` (all on the first shard's device)."""
    rows = fill[0].shape[0]
    idx = idx.long()
    out = []
    for k, f in enumerate(fill):
        dev = f.device
        local = torch.where(keep & (torch.div(idx, rows, rounding_mode="floor")
                                    == k), idx - k * rows, rows).to(dev)
        o = torch.cat([f, f[:1]])
        o[local] = values.to(dev)
        out.append(o[:rows])
    return out


def compact_indices(masks: list, capacity: int):
    """``ops/octree.compact_indices`` of a sharded mask -> (count, idx
    i32[capacity]) on the first shard's device: each shard's masked rows
    compacted with its row offset, in shard order, so the indices are the
    one-device compaction's.  One sync of the shards' counts."""
    dev, rows = masks[0].device, masks[0].shape[0]
    counts = torch.stack([m.sum(dtype=torch.int32).to(dev)
                          for m in masks]).tolist()
    parts, left = [], capacity
    for k, (m, c) in enumerate(zip(masks, counts)):
        c = min(c, left)
        if c > 0:
            _, idx = octree.compact_indices(m, c)
            parts.append(idx.to(dev) + k * rows)
            left -= c
    idx = torch.zeros(capacity, dtype=torch.int32, device=dev)
    if parts:
        head = torch.cat(parts)
        idx[:head.shape[0]] = head
    return (torch.tensor(capacity - left, dtype=torch.int32, device=dev),
            idx)


@dataclasses.dataclass(frozen=True)
class ShardedCloud:
    """A point cloud over a mesh: one ``PointCloud`` a shard, each of the
    same capacity (a multiple of 1024), on its shard's device, in row order
    (shard k holds rows ``k * rows`` on).  A column of it is a sharded
    array (:meth:`column`)."""

    mesh: Mesh
    shards: tuple[PointCloud, ...]

    @classmethod
    def from_numpy(cls, mesh: Mesh, pos: np.ndarray, capacity: int,
                   segment=None, classification=None) -> "ShardedCloud":
        """Host rows padded to ``capacity`` (a multiple of 1024 x D) and
        split into contiguous shards."""
        if capacity % (1024 * mesh.size):
            raise ValueError(f"capacity {capacity} is not a multiple of "
                             f"1024 x {mesh.size}")
        whole = PointCloud.from_numpy(pos, capacity=capacity, segment=segment,
                                      classification=classification,
                                      device="cpu")
        cols = {f.name: split(mesh, getattr(whole, f.name))
                for f in dataclasses.fields(PointCloud)}
        return cls(mesh, tuple(PointCloud(**{k: v[i] for k, v in cols.items()})
                               for i in range(mesh.size)))

    @property
    def rows(self) -> int:
        """Rows a shard."""
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.rows * len(self.shards)

    @property
    def count(self) -> int:
        """Number of valid points (as ``PointCloud.count``)."""
        return sum(s.count for s in self.shards)

    def column(self, name: str) -> list:
        """The sharded array of one field (``pos``, ``segment``, ...)."""
        return [getattr(s, name) for s in self.shards]

    @property
    def alive(self) -> list:
        return [s.alive for s in self.shards]

    def map(self, fn, *args, **kw) -> "ShardedCloud":
        """``fn(shard, *args, **kw)`` of each shard, an elementwise edit of
        ``interactive`` (no value crosses the shards)."""
        return dataclasses.replace(self, shards=tuple(
            fn(s, *args, **kw) for s in self.shards))

    def replace(self, **cols) -> "ShardedCloud":
        """Fields replaced by sharded arrays."""
        return dataclasses.replace(self, shards=tuple(
            s.replace(**{k: v[i] for k, v in cols.items()})
            for i, s in enumerate(self.shards)))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Valid rows on the host, in row order (``PointCloud.to_numpy``)."""
        parts = [s.to_numpy() for s in self.shards]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def gather(self) -> PointCloud:
        """The cloud on the first shard's device, every row."""
        return PointCloud(**{f.name: gather(self.column(f.name))
                             for f in dataclasses.fields(PointCloud)})


# --- shard programs and the steps built from them --------------------------

def _session_local(pos, valid, d: float, cfg: Config):
    res = yield from seg.segment_points_shard(pos, valid, d, cfg.segmentation,
                                              across=True)
    table, classification = yield from ch.compute_segments_shard(
        pos, res.segment, valid, cfg.segmentation.max_segments + 1,
        cfg.characteristics, full_bbox=False, across=True)
    return res, table, classification


def sharded_segment(mesh: Mesh, cfg: Config = DEFAULT_CONFIG):
    """The sharded segmentation step: ``(pos shards, valid shards, d) ->
    (segment shards, n_alloc)``."""
    def step(pos_s, valid_s, d):
        out = run(mesh, [seg.segment_points_shard(p, v, float(d),
                                                  cfg.segmentation, across=True)
                         for p, v in zip(pos_s, valid_s)])
        return [r.segment for r in out], out[0].n_segments
    return step


def sharded_session_step(mesh: Mesh, cfg: Config = DEFAULT_CONFIG):
    """Segmentation, the ``full_bbox=False`` table and each point's class
    over point shards, as ``pipeline.full_pipeline`` computes them on one
    device: ``(pos shards, valid shards, d) -> (segment shards,
    classification shards, SegmentTable, SegmentationResult)``.  The table
    and the result's band-scan fields are the first shard's (every shard
    holds the same); the result's ``segment`` is the shards' list."""
    def step(pos_s, valid_s, d):
        out = run(mesh, [_session_local(p, v, float(d), cfg)
                         for p, v in zip(pos_s, valid_s)])
        segment = [r.segment for r, _, _ in out]
        res = dataclasses.replace(out[0][0], segment=segment)
        return segment, [c for _, _, c in out], out[0][1], res
    return step


def sharded_pipeline_step(mesh: Mesh, cfg: Config = DEFAULT_CONFIG):
    """:func:`sharded_session_step` without the result's extras:
    ``(pos shards, valid shards, d) -> (segment shards, classification
    shards, n_alloc, SegmentTable)``."""
    session_step = sharded_session_step(mesh, cfg)

    def step(pos_s, valid_s, d):
        segment, classification, table, res = session_step(pos_s, valid_s, d)
        return segment, classification, res.n_segments, table
    return step


def sharded_characteristics(mesh: Mesh, cfg: Config = DEFAULT_CONFIG,
                            full_bbox: bool = True):
    """The table over existing segment ids: ``(pos shards, segment shards,
    valid shards) -> (SegmentTable on the first device, classification
    shards)``."""
    def step(pos_s, segment_s, valid_s):
        out = run(mesh, [ch.compute_segments_shard(
            p, s, v, cfg.segmentation.max_segments + 1, cfg.characteristics,
            full_bbox, across=True) for p, s, v in zip(pos_s, segment_s,
                                                        valid_s)])
        return out[0][0], [c for _, c in out]
    return step


def sharded_rasters(mesh: Mesh, pos_s, classification_s, live_s, lo, hi,
                    cell: float, cap: int = 4096, y_offset: float = 0.0):
    """DTM / DSM / CHM over a point-sharded cloud, bit-equal to
    ``rasters.compute_rasters`` on the same points: each shard's height
    grids, composited by one min (ground) and one max (surface) over the
    shards on the first device, then one ``finalize_rasters`` there.
    Returns (grids dict, (rows, cols), cell) like ``compute_rasters``."""
    if len(pos_s) != mesh.size:
        raise ValueError(f"{len(pos_s)} shards for a mesh of {mesh.size}")
    (rows, cols), (ph, pw), cell = rs.grid_dims(lo, hi, cell, cap=cap)
    dtm, dsm = [], []
    for p, c, live in zip(pos_s, classification_s, live_s):
        d, s = rs.height_grids(
            p, live & (c == CLASS_GROUND), live, full(lo[0], p),
            full(lo[2], p), full(1.0 / cell, p), (ph, pw), (rows, cols))
        dtm.append(d)
        dsm.append(s)
    return (rs.finalize_rasters(_fold(dtm, minimum), _fold(dsm, maximum),
                                rows, cols, y_offset=y_offset),
            (rows, cols), cell)


# --- the interactive half: octree, LOD and adaptive cuts, pick, frame,
# inventory, height above ground -----------------------------------------
#
# Every function takes the shards of a Morton-ordered cloud (rows split
# contiguously after one Morton sort): the octree cuts need each shard to
# hold a run of ascending keys.

def sharded_octree(mesh: Mesh):
    """The shard-local octrees, built once: ``(pos shards, valid shards) ->
    [Octree]`` (sorted keys and order per shard, the box of every shard's
    valid points; no rank, no inverse).  Positions never move under an
    edit, so a ``Session`` keeps them across strokes."""
    def step(pos_s, valid_s):
        return run(mesh, [octree.build_shard(p, v, across=True)
                          for p, v in zip(pos_s, valid_s)])
    return step


def sharded_lod_mask(mesh: Mesh, level: int, points_per_node: int = 1):
    """``ops/octree.lod_mask`` over the shards: ``(trees, live shards,
    frustum=None) -> keep shards``, bit-equal to the one-device mask of the
    concatenated rows."""
    def step(trees, live_s, frustum=None):
        return run(mesh, [octree.lod_mask_shard(
            t, level, points_per_node, live, frustum, across=True, index=i)
            for i, (t, live) in enumerate(zip(trees, live_s))])
    return step


def sharded_adaptive_mask(mesh: Mesh, px_scale, tau_px: float = 1.5,
                          level_min: int = 4, level_max: int = 10):
    """``ops/octree.adaptive_mask`` over the shards: ``(trees, live
    shards, cam_pos, frustum=None) -> keep shards``, bit-equal to one
    device's."""
    def step(trees, live_s, cam_pos, frustum=None):
        return run(mesh, [octree.adaptive_mask_shard(
            t, cam_pos, px_scale, tau_px, level_min, level_max, live,
            frustum, across=True, index=i)
            for i, (t, live) in enumerate(zip(trees, live_s))])
    return step


def sharded_adaptive_counts(mesh: Mesh, px_scale, taus: tuple[float, ...],
                            level_min: int = 4, level_max: int = 10):
    """``ops/octree.adaptive_counts`` over the shards: ``(trees, live
    shards, cam_pos, frustum=None) -> i32[len(taus)]`` on the first
    device, the whole tau ladder in one pass."""
    def step(trees, live_s, cam_pos, frustum=None):
        return run(mesh, [octree.adaptive_counts_shard(
            t, cam_pos, px_scale, taus, level_min, level_max, live, frustum,
            across=True, index=i)
            for i, (t, live) in enumerate(zip(trees, live_s))])[0]
    return step


def sharded_pick(mesh: Mesh, include_deleted: bool = False):
    """``interactive.pick`` over the shards: ``(ShardedCloud, origin,
    direction, point_scale) -> (segment, distance, hit)`` on the first
    device; ties go to the lowest row of the concatenated shards, as
    ``argmin`` takes them on one device."""
    def step(cloud: ShardedCloud, origin, direction, point_scale):
        return run(mesh, [edit.pick_shard(c, origin, direction, point_scale,
                                          include_deleted, across=True,
                                          index=i)
                          for i, c in enumerate(cloud.shards)])[0]
    return step


def sharded_render(mesh: Mesh, cfg: Config = DEFAULT_CONFIG):
    """The splat frame over the shards: ``(pos shards, prop shards, mask
    shards, camera, palette) -> f32[H,W,3]`` on the first device.

    Each shard rasterizes its points into the packed (depth << 8 | palette)
    i32 key image; one min over the shards composites them, the z-test
    being a min of integer keys, so the image is the one-device image bit
    for bit; the dilation and the eye-dome (their kernels) then run once on
    it."""
    rcfg = cfg.render

    def step(pos_s, prop_s, mask_s, cam, palette):
        kimg = _fold([splat.rasterize_keys(p, pr, m, cam, rcfg)
                      for p, pr, m in zip(pos_s, prop_s, mask_s)], minimum)
        color, z01, _ = splat.resolve_keys(kimg, cam, palette, rcfg)
        return splat.eye_dome(color, z01, rcfg)
    return step


def sharded_inventory(mesh: Mesh, cfg: Config = DEFAULT_CONFIG,
                      method: int = 0, symmetric: bool = False,
                      axis_algo: str = "average", **rbv_kw):
    """The whole forest's inventory over the shards: ``(pos, segment,
    classification, valid shards) -> (Traits, counts i32[S,3], found
    bool[S], origin f32[S,3])`` on the first device.

    The batched axes and RBVs and the class counts are shard programs: the
    extents and max grids combine by a min and a max (exact), the counts by
    an integer sum, the axes' band and layer sums and the mean grids' sums
    by one sum in shard order of each shard's own segmented sums."""
    n_seg = cfg.segmentation.max_segments + 1

    def step(pos_s, seg_s, cls_s, valid_s):
        return run(mesh, [rbv.inventory_shard(
            p, s, c, v, n_seg, method, symmetric, axis_algo, rbv_kw,
            across=True) for p, s, c, v in zip(pos_s, seg_s, cls_s,
                                               valid_s)])[0]
    return step


def sharded_height_above_ground(mesh: Mesh, pos_s, classification_s, live_s,
                                lo, hi, cell: float, cap: int = 4096) -> list:
    """``rasters.height_above_ground`` over the shards -> f32 shards: one
    min of the shards' raw DTMs, one flood of it, then each shard's points
    read it; bit-equal to one device's."""
    (rows, cols), shape, cell = rs.grid_dims(lo, hi, cell, cap=cap)
    return run(mesh, [rs.height_above_ground_shard(
        p, c, live, full(lo[0], p), full(lo[2], p),
        full(1.0 / cell, p), shape, (rows, cols), across=True)
        for p, c, live in zip(pos_s, classification_s, live_s)])


def live_bounds(pos_s, live_s) -> tuple[torch.Tensor, torch.Tensor]:
    """``segmentation.scene_bounds`` of the shards' live points, on the
    first device: the shards' raw bounds folded by a min and a max."""
    raw = [seg.scene_bounds_raw(p, live) for p, live in zip(pos_s, live_s)]
    any_live = _fold([live.any() for live in live_s], maximum)
    return seg.scene_bounds_finalize(_fold([r[0] for r in raw], minimum),
                                     _fold([r[1] for r in raw], maximum),
                                     any_live)
