"""Point-sharded steps over a list of devices: the PyTorch port of the step
half of ``treee_tpu/parallel/sharding.py``.

The JAX package runs its mesh mode under one controller: ``shard_map`` over
a ``Mesh``, with ``psum`` / ``pmin`` / ``pmax`` between the shards.  The
port keeps that shape in one process:

- a :class:`Mesh` is a tuple of ``torch.device``s.  A device may appear
  more than once: ``make_mesh(["cuda:0"] * 4)`` runs the whole shard logic
  on one card, ``make_mesh(["cpu"] * 4)`` on the CPU;
- a sharded array is a list of per-shard tensors with equal rows, each on
  its shard's device (:func:`shard_points`, :func:`shard_points_morton`);
- a shard's step is a *shard program*: a generator that yields each value
  to combine across the shards as ``(op, value)`` and receives the combined
  value.  :func:`run` drives one program per shard in lockstep.  ``"min"``,
  ``"max"`` and ``"sum"`` gather the shards' tensors to the first shard's
  device, reduce them in shard order and copy the result back to each
  shard's device (:func:`all_min`, :func:`all_max`, :func:`all_sum`);
  ``"once"`` runs the first shard's callable on its device and copies what
  it returns to the others (the replicated band scan: one run instead of
  one a shard, the same result).

Segmentation couples the shards through the global bounds, the anchor
histogram and the band count grids; the table through the y grid, the
segments' counts and y extents and the support table.  Each is an integer
sum or an f32 min or max, which do not depend on the order of the shards,
so a sharded step equals the one-device step bit for bit.

The interactive half of the JAX module (octree, LOD and adaptive masks,
adaptive counts, pick, render and inventory, ``sharding.py:372-700``) and
the ``Session``'s mesh mode are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import characteristics as ch
from .. import rasters as rs
from .. import segmentation as seg
from ..cloud import CLASS_GROUND
from ..config import Config, DEFAULT_CONFIG
from ..device import resolve
from ..ops import morton
from ..ops.kernels.seg_cummax import order as f32_order
from ..ops.kernels.seg_cummax import unorder as f32_unorder


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


# --- collectives over the shards' tensors ----------------------------------

def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min; floats in the total order of
    ``seg_cummax.order`` (-0.0 below +0.0), as the rasters' integer
    scatter takes it, so that no grouping changes a bit."""
    if a.dtype == torch.float32:
        return f32_unorder(torch.minimum(f32_order(a), f32_order(b)))
    return torch.minimum(a, b)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max, floats as in :func:`minimum`."""
    if a.dtype == torch.float32:
        return f32_unorder(torch.maximum(f32_order(a), f32_order(b)))
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


REDUCTIONS = {"min": all_min, "max": all_max, "sum": all_sum}


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
    while True:
        requests, returned = [], []
        for program, reply in zip(programs, replies):
            try:
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
    shard row (shards concatenated) to the input row.  The anchor histogram
    then subsamples other points than over the input order, so the band
    anchor, and the ids with it, may differ from the one-device step's
    (ROADMAP, slice 9b)."""
    pos = torch.as_tensor(pos, dtype=torch.float32).cpu()
    valid = torch.as_tensor(valid, dtype=torch.bool).cpu()
    order = morton_order(pos, valid)
    pos_s, valid_s = shard_points(mesh, pos[order], valid[order])
    return pos_s, valid_s, order.numpy()


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
            p, live & (c == CLASS_GROUND), live, rs.f32(lo[0], p),
            rs.f32(lo[2], p), rs.f32(1.0 / cell, p), (ph, pw), (rows, cols))
        dtm.append(d)
        dsm.append(s)
    return (rs.finalize_rasters(_fold(dtm, minimum), _fold(dsm, maximum),
                                rows, cols, y_offset=y_offset),
            (rows, cols), cell)
