"""Halo tiles: surveys larger than one card holds, run tile by tile; the
PyTorch port of ``treee_tpu/parallel/tiles.py``.

- The survey is sorted by x once; each x-range tile is a contiguous row
  range, extended by a halo at least as wide as the largest crown, so every
  tree lies whole inside at least one tile.
- Every tile is padded to one capacity and runs the port's
  ``full_pipeline`` on the card, or, with a mesh, the point-sharded
  ``sharded_session_step`` over its devices.
- Trees that straddle a tile edge are segmented by both neighbours; the
  halo points, present in both, vote on an id-to-id mapping (a majority a
  left id, at least 3 votes), and a union-find on the host merges the
  tiles' label spaces into dense global ids.
- Each point takes its id and class from its primary tile, the one whose
  core range holds it; a global id's analytics row is in the table of the
  tile that holds most of its core points (``info["owners"]``).

Rasters need no halo: per-cell min and max compose exactly, so
:func:`tiled_rasters` streams the survey through the card in slabs into two
accumulators that stay on the card.

Every copy to the card is a synchronous copy from pageable host memory,
straight from the survey's arrays: it has finished when it returns, and no
host buffer is written while a copy from it may still run, so the staging
race that the JAX package guards against (its round-4 fault, a host buffer
overwritten under an asynchronous transfer) cannot occur.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import rasters as rs
from ..cloud import CLASS_GROUND
from ..config import Config, DEFAULT_CONFIG
from ..device import DEFAULT_DEVICE, resolve
from ..ops.f32 import full
from ..pipeline import full_pipeline
from . import sharding

log = logging.getLogger(__name__)

# a tile's capacity is a multiple of this many rows, times the mesh's size:
# each shard then holds a multiple of the anchor histogram's stride
BLOCK = 1024
# a halo mapping needs at least this many shared points (a noise floor)
MIN_VOTES = 3


class _UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.parent.setdefault(x, x)
        while p != self.parent[p]:
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        self.parent[x] = p
        return p

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def plan_tiles(x: np.ndarray, n_tiles: int, halo: float):
    """Split the x extent into ``n_tiles`` equal core ranges plus halos.

    Returns a list of (core_lo, core_hi, ext_lo, ext_hi): the cores
    partition [min, max] (a point belongs to the core with x < core_hi, the
    last core closed), the extended ranges overlap by ``halo`` on interior
    edges."""
    lo, hi = float(x.min()), float(x.max())
    edges = np.linspace(lo, hi, n_tiles + 1)
    tiles = []
    for i in range(n_tiles):
        c0, c1 = float(edges[i]), float(edges[i + 1])
        e0 = c0 - (halo if i > 0 else 0.0)
        e1 = c1 + (halo if i < n_tiles - 1 else 0.0)
        tiles.append((c0, c1, e0, e1))
    return tiles


def _sort_by_x(pos: np.ndarray) -> np.ndarray:
    """i32[N] rows in ascending x: one value sort of (total-order f32 key
    << 32 | row) packed into u64, ties by row."""
    n = len(pos)
    bits = pos[:, 0].copy().view(np.uint32)
    key = np.where(bits >> 31, ~bits, bits | np.uint32(0x80000000))
    packed = (key.astype(np.uint64) << np.uint64(32)) | np.arange(
        n, dtype=np.uint64)
    del bits, key
    packed.sort()
    return (packed & np.uint64(0xFFFFFFFF)).astype(np.int32)


def _tile_step(tpos, tvalid, max_distance, cfg, mesh, step):
    """One padded tile on the card: (segment, classification) as host
    arrays in the tile's row order, the table, the SegmentationResult.

    With a mesh the tile, already in x order, splits into contiguous shards,
    each an x-strip: their strided anchor subsamples make up the tile's, and
    every other cross-shard value is an exact min, max or sum, so the ids
    equal the mesh-free tile's."""
    if mesh is None:
        seg, cls, table, res = full_pipeline(tpos, tvalid, max_distance, cfg)
    else:
        pos_s, valid_s = sharding.shard_points(mesh, tpos, tvalid)
        seg_s, cls_s, table, res = step(pos_s, valid_s, max_distance)
        seg, cls = sharding.gather(seg_s), sharding.gather(cls_s)
    return seg.cpu().numpy(), cls.to(torch.uint8).cpu().numpy(), table, res


def tiled_pipeline(pos: np.ndarray, n_tiles: int, max_distance: float = 0.75,
                   cfg: Config = DEFAULT_CONFIG, halo: float = 12.0,
                   progress=None, mesh: sharding.Mesh | None = None,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Segment a survey held in host memory tile by tile on ``device``, or
    with ``mesh`` point-sharded over its devices (its first device then
    takes the place of ``device``).

    Args:
      pos: f32[N,3] y-up positions (host memory).
      n_tiles: number of x-range tiles; size a tile to what one card (or
        the mesh) holds, and to ``max_segments`` trees.
      halo: overlap width in metres; must exceed the largest crown
        diameter.
      progress: optional callable(tile_index, n_tiles).

    Returns (segment i32[N] global ids, dense from 1; classification
    u8[N]; the tiles' SegmentTables; info dict: ``n_tiles``, ``capacity``,
    ``n_segments``, ``halo``, ``tile_times`` (each tile's (slice, run)
    seconds), ``sort_s``, ``owners`` (global id -> (tile, local id));
    and beyond the JAX package's keys ``reconcile_s`` (the votes, the
    relabel and the return to the input order) and each tile's ``n_alloc``
    and ``occupied_overflow``).
    """
    dev = mesh.devices[0] if mesh is not None else resolve(device)
    n = len(pos)
    t0 = time.perf_counter()
    order = _sort_by_x(pos)
    pos_s = pos[order]
    xs = pos_s[:, 0]
    sort_s = time.perf_counter() - t0
    tiles = plan_tiles(xs, n_tiles, halo)

    # contiguous sorted-row ranges: ext = [a, b) covers x in [e0, e1],
    # core = [ka, kb) partitions the rows (the last tile closed above)
    ext: list[tuple[int, int]] = []
    cores: list[tuple[int, int]] = []
    for i, (c0, c1, e0, e1) in enumerate(tiles):
        ext.append((int(np.searchsorted(xs, e0, side="left")),
                    int(np.searchsorted(xs, e1, side="right"))))
        cores.append((int(np.searchsorted(xs, c0, side="left")) if i else 0,
                      int(np.searchsorted(xs, c1, side="left"))
                      if i < n_tiles - 1 else n))

    block = BLOCK * (mesh.size if mesh is not None else 1)
    step = (sharding.sharded_session_step(mesh, cfg) if mesh is not None
            else None)
    cap = max(block, -(-max(b - a for a, b in ext) // block) * block)

    seg_store = np.zeros((n_tiles, cap), np.int32)
    cls_store = np.zeros((n_tiles, cap), np.uint8)
    tile_results = []   # (ext_lo, n_ext, table)
    tile_times, n_alloc, overflow = [], [], []
    for t, (a, b) in enumerate(ext):
        if progress is not None:
            progress(t, n_tiles)
        t0 = time.perf_counter()
        m = b - a
        tpos = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        tpos[:m] = torch.from_numpy(pos_s[a:b]).to(dev)
        tvalid = torch.arange(cap, device=dev) < m
        t1 = time.perf_counter()
        seg, cls, table, res = _tile_step(tpos, tvalid, max_distance, cfg,
                                          mesh, step)
        seg_store[t, :m] = seg[:m]
        cls_store[t, :m] = cls[:m]
        n_alloc.append(int(res.n_segments))
        overflow.append(bool(res.occupied_overflow))
        t2 = time.perf_counter()
        tile_results.append((a, m, table))
        tile_times.append((t1 - t0, t2 - t1))
        log.info("tile %d/%d: slice %.1fs run+fetch %.1fs", t + 1, n_tiles,
                 t1 - t0, t2 - t1)
        del tpos, tvalid, seg, cls, res

    # --- cross-tile reconciliation: halo points lie in both neighbours;
    # each (left id, right id) pair they carry votes for a merge ---
    t0 = time.perf_counter()
    uf = _UnionFind()
    n_locals = cfg.segmentation.max_segments + 2

    def gid(tile: int, local: int) -> int:
        return tile * n_locals + local

    for t in range(n_tiles - 1):
        a0, m0, _ = tile_results[t]
        a1, m1, _ = tile_results[t + 1]
        s, e = max(a0, a1), min(a0 + m0, a1 + m1)
        if e <= s:
            continue
        ia = seg_store[t, s - a0:e - a0]
        ib = seg_store[t + 1, s - a1:e - a1]
        both = (ia > 0) & (ib > 0)
        pairs = (ia[both].astype(np.int64) << 32) | ib[both].astype(np.int64)
        uniq, counts = np.unique(pairs, return_counts=True)
        if not len(uniq):
            continue
        left, right = uniq >> 32, uniq & 0xFFFFFFFF
        # the majority right id of each left id: sorted by (left, count),
        # the last row of each left id wins
        vote = np.lexsort((counts, left))
        left_s, right_s, cnt_s = left[vote], right[vote], counts[vote]
        last = np.concatenate([left_s[1:] != left_s[:-1], [True]])
        for la, rb, v in zip(left_s[last], right_s[last], cnt_s[last]):
            if v >= MIN_VOTES:
                uf.union(gid(t, int(la)), gid(t + 1, int(rb)))

    # --- dense global ids; each point's id and class from its primary tile;
    # a global id's owner is the tile holding most of its core points ---
    segment_sorted = np.empty(n, np.int32)
    class_sorted = np.empty(n, np.uint8)
    remap: dict[int, int] = {}
    owners: dict[int, tuple[int, int]] = {}
    owner_counts: dict[int, int] = {}
    for t, (a, _m, _table) in enumerate(tile_results):
        ka, kb = cores[t]
        seg_core = seg_store[t, ka - a:kb - a]
        counts = np.bincount(seg_core, minlength=n_locals)
        lut = np.zeros(n_locals, np.int32)
        for sid in np.flatnonzero(counts):
            if sid == 0:
                continue
            root = uf.find(gid(t, int(sid)))
            g = remap.setdefault(root, len(remap) + 1)
            lut[sid] = g
            if int(counts[sid]) > owner_counts.get(g, 0):
                owner_counts[g] = int(counts[sid])
                owners[g] = (t, int(sid))
        np.take(lut, seg_core, out=segment_sorted[ka:kb])
        class_sorted[ka:kb] = cls_store[t, ka - a:kb - a]

    # back to the caller's point order
    segment_out = np.empty(n, np.int32)
    class_out = np.empty(n, np.uint8)
    segment_out[order] = segment_sorted
    class_out[order] = class_sorted
    info = {
        "n_tiles": n_tiles,
        "capacity": cap,
        "n_segments": len(remap),
        "halo": halo,
        "tile_times": tile_times,
        "sort_s": sort_s,
        "owners": owners,
        "reconcile_s": time.perf_counter() - t0,
        "n_alloc": n_alloc,
        "occupied_overflow": overflow,
    }
    return segment_out, class_out, [r[2] for r in tile_results], info


def tiled_rasters(pos: np.ndarray, classification: np.ndarray,
                  cell: float = 0.5, cap: int = 4096, slab: int = 1 << 25,
                  y_offset: float = 0.0, progress=None,
                  device: str | torch.device = DEFAULT_DEVICE):
    """DTM / DSM / CHM of a survey held in host memory, bit-equal to
    ``rasters.compute_rasters`` over the same points.

    The survey streams through ``device`` in slabs of ``slab`` points; each
    slab's height grids fold into two [H, W] accumulators on the device by
    an f32 min (ground) and max (surface), exact in any grouping, and one
    ``finalize_rasters`` ends it.  ``classification`` is
    :func:`tiled_pipeline`'s per-point output.  Returns (grids dict,
    (rows, cols), cell) like ``compute_rasters``."""
    dev = resolve(device)
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    (rows, cols), (ph, pw), cell = rs.grid_dims(lo, hi, cell, cap=cap)
    dtm = torch.full((ph, pw), rs.BIG, dtype=torch.float32, device=dev)
    dsm = torch.full((ph, pw), -rs.BIG, dtype=torch.float32, device=dev)
    lo_x, lo_z, inv = full(lo[0], dtm), full(lo[2], dtm), full(1.0 / cell, dtm)
    slab = max(1, min(slab, n))
    n_slabs = -(-n // slab)
    for t in range(n_slabs):
        if progress is not None:
            progress(t, n_slabs)
        p = torch.from_numpy(pos[t * slab:(t + 1) * slab]).to(dev)
        c = torch.from_numpy(classification[t * slab:(t + 1) * slab]).to(dev)
        live = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        d, s = rs.height_grids(p, c == CLASS_GROUND, live, lo_x, lo_z, inv,
                               (ph, pw), (rows, cols))
        dtm = sharding.minimum(dtm, d)
        dsm = sharding.maximum(dsm, s)
    grids = rs.finalize_rasters(dtm, dsm, rows, cols, y_offset=y_offset)
    return grids, (rows, cols), cell
