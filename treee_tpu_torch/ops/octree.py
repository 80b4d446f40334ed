"""Morton-coded linear octree, the port of ``treee_tpu/ops/octree.py``.

- *Build*: one stable sort of Morton keys (``ops/morton.py``) and each sorted
  slot's rank within its leaf node.  A node at level ``l`` is the run of
  sorted points that share the key prefix ``key >> 3*(10-l)``.
- *LOD*: ``lod_mask`` keeps up to ``points_per_node`` evenly strided points
  of every level-``l`` node; ``adaptive_mask`` picks each region's level by
  its cells' projected size on screen; both can cull whole nodes against the
  view frustum.  Masks are in the points' original order.
- *Tables and compaction*: padded per-level node tables, and the masked rows
  compacted to dense fixed-capacity buffers or original-order indices.
- *Shards*: :func:`build_shard`, :func:`lod_mask_shard`,
  :func:`adaptive_mask_shard` and :func:`adaptive_counts_shard` are shard
  programs (``parallel/program.py``): the one-device functions run them
  alone, ``parallel/sharding.py`` over the shards of a Morton-ordered
  cloud, where the concatenated shard-local sorts are the global sort of
  the real keys (each shard's padding sorts to its own end).  The scans
  over sorted slots continue from shard to shard through gathered scalar
  carries.

The JAX package's blocked doubling scan, a TPU workaround, is
``torch.cummax``/``cummin`` here.  Every division by a constant divides two
tensors (``f32.full``), and every sum of three terms is written
out as ``(a + b) + c``, so that the card rounds as the CPU does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.program import (gathered, next_min, prev_max, prev_sum,
                                run_alone)
from . import morton
from .f32 import full

INVALID_KEY = 0x7FFFFFFF
_BIG = 3.0e38
# the packed compaction key's flag bit: masked rows sort first
_ROW_BITS = 30


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _revcummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative min: the min over each slot and every later one."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _starts(x: torch.Tensor) -> torch.Tensor:
    """bool[N]: the slots whose value differs from the previous slot's."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                      x[1:] != x[:-1]])


@dataclasses.dataclass
class Octree:
    """Linear octree over a fixed-capacity point set.

    keys:   i32[N] sorted Morton keys; padding slots hold INVALID_KEY.
    order:  i32[N] original point index per sorted slot.
    rank:   i32[N] rank of each sorted slot within its leaf node.
    inv:    i32[N] sorted slot per original point index (inverse permutation).
    lo, hi: f32[3] bounding cube used for quantization.

    A shard's tree (:func:`build_shard`) leaves ``rank`` and ``inv`` out
    (None): they would be the shard's own.
    """

    keys: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor | None
    inv: torch.Tensor | None
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def _bounds_and_keys(pos: torch.Tensor, valid: torch.Tensor, across: bool):
    """Shard program -> (keys i32[N], lo f32[3], hi f32[3]): the valid
    points' bounding box (with ``across``, every shard's; the unit box when
    none is valid) and their Morton keys over it, ``INVALID_KEY`` at the
    other rows.  The prologue of :func:`build` and :func:`build_keys`, so
    that the two cannot drift apart."""
    m = valid[:, None]
    lo = torch.where(m, pos, _BIG).amin(dim=0)
    hi = torch.where(m, pos, -_BIG).amax(dim=0)
    any_valid = valid.any()
    if across:
        lo = yield "min", lo
        hi = yield "max", hi
        any_valid = yield "max", any_valid
    lo = torch.where(any_valid, lo, 0.0)
    hi = torch.where(any_valid, hi, 1.0)
    keys = torch.where(valid, morton.encode_positions(pos, lo, hi), INVALID_KEY)
    return keys, lo, hi


def build_keys(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sorted int32[N] Morton keys only, the step's form of :func:`build`.

    A keys-only sort returns the same array whether stable or not, so the
    cheaper unstable sort is used."""
    keys, _, _ = run_alone(_bounds_and_keys(pos, valid, False))
    return torch.sort(keys, stable=False).values


def build_shard(pos: torch.Tensor, valid: torch.Tensor, across: bool):
    """Shard program -> Octree without ``rank`` and ``inv``: the keys over
    the bounding box of every shard's valid points, sorted stably within the
    shard."""
    keys, lo, hi = yield from _bounds_and_keys(pos, valid, across)
    slot = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    keys_sorted, order = morton.sort_by_key(keys, slot)
    return Octree(keys=keys_sorted, order=order, rank=None, inv=None, lo=lo,
                  hi=hi)


def build(pos: torch.Tensor, valid: torch.Tensor) -> Octree:
    """The linear octree of f32[N,3] positions with a validity mask."""
    tree = run_alone(build_shard(pos, valid, False))
    slot = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    # rank within the leaf node: slots since the last key change
    rank = slot - _cummax(torch.where(_starts(tree.keys), slot, 0))
    inv = torch.zeros_like(slot)
    inv[tree.order] = slot
    return dataclasses.replace(tree, rank=rank, inv=inv)


def _extent(tree: Octree) -> torch.Tensor:
    return torch.clamp((tree.hi - tree.lo).max(), min=1e-6)


def _cell_bounds(tree: Octree, coarse: torch.Tensor, level: int):
    """AABB (lo, hi) f32[..., 3] of the level-``level`` cells with prefixes
    ``coarse``, elementwise.  The grid step is extent / (MORTON_SIZE - 1),
    as in ``morton.quantize``, so each cell covers the points keyed to it."""
    base_keys = coarse << (3 * (morton.MORTON_BITS - level))
    cell = morton.decode(base_keys).to(torch.float32)
    extent = _extent(tree)
    step = full(morton.MORTON_SIZE - 1, extent)
    cell_size = torch.div(extent, step) * (1 << (morton.MORTON_BITS - level))
    lo = tree.lo + torch.div(cell, step) * extent
    return lo, lo + cell_size


def aabb_in_frustum(lo: torch.Tensor, hi: torch.Tensor,
                    planes: torch.Tensor) -> torch.Tensor:
    """Conservative AABB-against-frustum test, elementwise over [..., 3]
    boxes: a box passes when its positive vertex is inside every plane of
    ``planes`` f32[6,4] (``Camera.frustum_planes``).  One plane at a time,
    each distance summed as ``((x*a + y*b) + z*c) + d``."""
    planes = planes.to(lo.device)
    inside = torch.ones(lo.shape[:-1], dtype=torch.bool, device=lo.device)
    for p in planes:
        v = [torch.where(p[i] > 0, hi[..., i], lo[..., i]) for i in range(3)]
        d = ((v[0] * p[0] + v[1] * p[1]) + v[2] * p[2]) + p[3]
        inside &= d >= 0.0
    return inside


def _live_sorted(tree: Octree, live: torch.Tensor | None) -> torch.Tensor:
    """bool[N] per sorted slot: a key, and live where ``live`` (original
    order) is given."""
    has_key = tree.keys != INVALID_KEY
    return has_key if live is None else live[tree.order] & has_key


def _scatter_back(tree: Octree, keep_sorted: torch.Tensor) -> torch.Tensor:
    """A per-slot mask in the points' original order."""
    keep = torch.zeros_like(keep_sorted)
    keep[tree.order] = keep_sorted
    return keep


def lod_mask(tree: Octree, level: int, points_per_node: int = 1,
             live: torch.Tensor | None = None,
             frustum: torch.Tensor | None = None) -> torch.Tensor:
    """bool[N] in ORIGINAL point order: the LOD subset for ``level``.

    Points are grouped by their level-``level`` key prefix and up to
    ``points_per_node`` of each node survive, strided evenly through the
    node's Morton run.  ``live`` (original order) makes ranks and strides
    count live points only, so a deleted representative hands over to a
    live sibling.  ``frustum`` (f32[6,4]) culls the nodes whose cell lies
    outside the view before the selection.
    """
    return run_alone(lod_mask_shard(tree, level, points_per_node, live,
                                    frustum, across=False))


def lod_mask_shard(tree: Octree, level: int, points_per_node: int,
                   live: torch.Tensor | None, frustum: torch.Tensor | None,
                   across: bool, index: int = 0):
    """:func:`lod_mask` as a shard program of shard ``index``.

    A node's rank and live count come from the inclusive running live count
    ``cum``: its exclusive value at the node's first real slot carried
    forward (a running max), its value at the node's last real slot carried
    backward (a running min).  Over shards, ``cum`` adds the live counts of
    the shards before; a shard's first real slot starts a node unless the
    last real key before it has the same prefix, its last real slot ends
    one unless the next shard's first real key does (padding, at each
    shard's end, must neither start nor end a node); the two running scans
    continue from the shards before and after.
    """
    shift = 3 * (morton.MORTON_BITS - level)
    keys = tree.keys
    real = keys != INVALID_KEY
    coarse = keys >> shift
    live_sorted = _live_sorted(tree, live)
    if frustum is not None:
        lo_c, hi_c = _cell_bounds(tree, coarse, level)
        live_sorted = live_sorted & aabb_in_frustum(lo_c, hi_c, frustum)
    cum = torch.cumsum(live_sorted, 0, dtype=torch.int32)
    g = yield from gathered(torch.stack([
        torch.where(real, keys, -1).amax(),
        torch.where(real, keys, INVALID_KEY).amin(), cum[-1]]), across)
    prev_coarse = prev_max(g[:, 0], index, -1) >> shift
    next_coarse = next_min(g[:, 1], index, INVALID_KEY) >> shift
    cum = cum + prev_sum(g[:, 2], index)

    new_node = real & torch.cat([(coarse[:1] != prev_coarse),
                                 coarse[1:] != coarse[:-1]])
    start = _cummax(torch.where(new_node, cum - live_sorted.to(torch.int32),
                                0))
    slot = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    next_c = torch.cat([coarse[1:], coarse.new_full((1,), INVALID_KEY)])
    next_c = torch.where(slot == real.sum(dtype=torch.int32) - 1, next_coarse,
                         next_c)
    is_end = real & (next_c != coarse)
    end = _revcummin(torch.where(is_end, cum, INVALID_KEY))
    g = yield from gathered(torch.stack([start[-1], end[0]]), across)
    start = torch.maximum(start, prev_max(g[:, 0], index, 0))
    end = torch.minimum(end, next_min(g[:, 1], index, INVALID_KEY))

    rank = cum - 1 - start
    count = end - start
    stride = torch.clamp((count + points_per_node - 1) // points_per_node,
                         min=1)
    return _scatter_back(tree, live_sorted & (rank % stride == 0))


def _level_proj(tree: Octree, lvl: int, cam_pos: torch.Tensor,
                px_scale: torch.Tensor):
    """Per sorted slot at octree level ``lvl``: (shift, prefix, cell lo,
    cell hi, the cell's projected size in pixels at its centre's distance
    from the camera)."""
    shift = 3 * (morton.MORTON_BITS - lvl)
    coarse = tree.keys >> shift
    lo_c, hi_c = _cell_bounds(tree, coarse, lvl)
    d = 0.5 * (lo_c + hi_c) - cam_pos
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    extent = _extent(tree)
    cell = torch.div(extent, full(float(1 << lvl), extent))
    proj = torch.div(cell * px_scale, torch.clamp(dist, min=1e-3))
    return shift, coarse, lo_c, hi_c, proj


def _level_ring(proj: torch.Tensor, tau_px: float, lvl: int, level_min: int,
                level_max: int):
    """(ring, near_all) of one level's screen-error band: ``proj <= tau <
    2*proj``; the coarsest level also takes the far field, the finest keeps
    every live point whose cells still project larger than tau (near_all,
    else None)."""
    ring = proj <= tau_px
    if lvl != level_min:
        ring &= 2.0 * proj > tau_px
    near_all = None
    if lvl == level_max:
        near_all = proj > tau_px
        ring |= near_all
    return ring, near_all


def _adaptive_keeps(tree: Octree, cam_pos, px_scale, taus, level_min: int,
                    level_max: int, live, frustum, across: bool, index: int):
    """Shard program -> one bool[N] keep mask per tau, in sorted order.

    "First live slot of its level-l node" is ``(prev >> shift) < prefix``
    at every level, where ``prev`` is the full key of the last live slot
    before (-1 where none; -1 >> s is -1): keys are sorted, and over shards
    the running max continues from the shards before."""
    dev = tree.keys.device
    live_sorted = _live_sorted(tree, live)
    run_key = torch.where(live_sorted, tree.keys, -1)
    g = yield from gathered(run_key.amax(), across)
    carry = prev_max(g, index, -1)
    run_key = torch.maximum(_cummax(run_key), carry)
    prev_key = torch.cat([carry[None], run_key[:-1]])
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32).to(dev)
    px_scale = torch.as_tensor(px_scale, dtype=torch.float32).to(dev)
    keeps = [torch.zeros_like(live_sorted) for _ in taus]
    for lvl in range(level_min, level_max + 1):
        shift, coarse, lo_c, hi_c, proj = _level_proj(tree, lvl, cam_pos,
                                                      px_scale)
        live_here = live_sorted
        if frustum is not None:
            live_here = live_here & aabb_in_frustum(lo_c, hi_c, frustum)
        first_live = live_sorted & ((prev_key >> shift) < coarse)
        for keep, tau in zip(keeps, taus):
            ring, near_all = _level_ring(proj, tau, lvl, level_min, level_max)
            keep |= live_here & ring & (first_live if near_all is None
                                        else near_all | first_live)
    return keeps


def adaptive_mask(tree: Octree, cam_pos: torch.Tensor, px_scale,
                  tau_px: float = 1.5, level_min: int = 4,
                  level_max: int = 10, live: torch.Tensor | None = None,
                  frustum: torch.Tensor | None = None) -> torch.Tensor:
    """bool[N] in ORIGINAL point order: the screen-error LOD cut.

    A region is drawn at the coarsest level whose cells project to at most
    ``tau_px`` pixels at their distance from ``cam_pos`` (``px_scale``:
    f_proj * height/2, world to pixels at distance 1), one point per cell
    (its first live point); the finest level keeps every live point.  The
    level rings partition the live points.
    """
    return run_alone(adaptive_mask_shard(tree, cam_pos, px_scale, tau_px,
                                         level_min, level_max, live, frustum,
                                         across=False))


def adaptive_mask_shard(tree: Octree, cam_pos, px_scale, tau_px: float,
                        level_min: int, level_max: int, live, frustum,
                        across: bool, index: int = 0):
    """:func:`adaptive_mask` as a shard program of shard ``index``."""
    (keep,) = yield from _adaptive_keeps(tree, cam_pos, px_scale, (tau_px,),
                                         level_min, level_max, live, frustum,
                                         across, index)
    return _scatter_back(tree, keep)


def adaptive_counts(tree: Octree, cam_pos: torch.Tensor, px_scale,
                    taus: tuple[float, ...], level_min: int = 4,
                    level_max: int = 10, live: torch.Tensor | None = None,
                    frustum: torch.Tensor | None = None) -> torch.Tensor:
    """i32[len(taus)]: ``adaptive_mask(..., tau).sum()`` for every tau of a
    ladder in one pass; the per-level geometry is computed once and each
    tau adds only its ring compares."""
    return run_alone(adaptive_counts_shard(tree, cam_pos, px_scale, taus,
                                           level_min, level_max, live,
                                           frustum, across=False))


def adaptive_counts_shard(tree: Octree, cam_pos, px_scale,
                          taus: tuple[float, ...], level_min: int,
                          level_max: int, live, frustum, across: bool,
                          index: int = 0):
    """:func:`adaptive_counts` as a shard program of shard ``index``: the
    shards' counts summed."""
    keeps = yield from _adaptive_keeps(tree, cam_pos, px_scale, taus,
                                       level_min, level_max, live, frustum,
                                       across, index)
    counts = torch.stack([k.sum(dtype=torch.int32) for k in keeps])
    if across:
        counts = yield "sum", counts
    return counts


@dataclasses.dataclass
class NodeTable:
    """Padded per-level node table: contiguous sorted-slot ranges per node.

    prefix: i32[M] level-l key prefix per node (INVALID_KEY padding).
    start:  i32[M] first sorted slot of the node.
    count:  i32[M] number of points in the node.
    n:      i32[]  number of real nodes.
    """

    prefix: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    n: torch.Tensor


def node_table(tree: Octree, level: int, max_nodes: int) -> NodeTable:
    """The level-``level`` node table, padded to ``max_nodes`` entries.

    Nodes beyond ``max_nodes`` are dropped; ``n`` still reports the true
    count, so ``n > max_nodes`` signals the truncation.  Scatters write the
    dropped and non-start slots to one spare entry past the end."""
    has_key = tree.keys != INVALID_KEY
    coarse = torch.where(has_key,
                         tree.keys >> (3 * (morton.MORTON_BITS - level)),
                         INVALID_KEY)
    new_node = _starts(coarse) & has_key
    node_id = torch.cumsum(new_node, 0, dtype=torch.int32) - 1
    slot = torch.arange(tree.capacity, dtype=torch.int32,
                        device=coarse.device)
    in_cap = node_id < max_nodes
    tgt = torch.where(new_node & in_cap, node_id, max_nodes)
    prefix = torch.full((max_nodes + 1,), INVALID_KEY, dtype=torch.int32,
                        device=coarse.device)
    prefix[tgt] = coarse
    start = torch.zeros_like(prefix)
    start[tgt] = slot
    seg = torch.where(has_key & in_cap, node_id, max_nodes)
    count = torch.zeros_like(prefix).index_add_(0, seg,
                                                has_key.to(torch.int32))
    return NodeTable(prefix=prefix[:max_nodes], start=start[:max_nodes],
                     count=count[:max_nodes],
                     n=new_node.sum(dtype=torch.int32))


def node_bounds(table: NodeTable, tree: Octree,
                level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """AABB (lo, hi) f32[M,3] of each node of the table (the cell math of
    :func:`lod_mask`'s frustum test)."""
    return _cell_bounds(tree, table.prefix, level)


def _targets(mask: torch.Tensor, capacity: int):
    """(count, tgt): the masked rows' dense positions, ``capacity`` for the
    unmasked rows and those past the capacity; count clamped to it."""
    pos_idx = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    tgt = torch.where(mask & (pos_idx < capacity), pos_idx, capacity)
    return torch.clamp(mask.sum(dtype=torch.int32), max=capacity), tgt


def compact(mask: torch.Tensor, capacity: int, *arrays: torch.Tensor):
    """Masked rows gathered into dense fixed-capacity buffers ->
    (count, tuple of arrays); rows past ``capacity`` are dropped, padding
    rows are zero."""
    count, tgt = _targets(mask, capacity)
    outs = []
    for a in arrays:
        out = a.new_zeros((capacity + 1,) + a.shape[1:])
        out[tgt] = a
        outs.append(out[:capacity])
    return count, tuple(outs)


def compact_indices(mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Original-order indices of the masked rows -> (count, idx i32[cap]).

    The first ``capacity`` masked rows in ascending order, index 0 in the
    padding slots (mask them with ``arange < count``); count is clamped to
    the capacity.  One key-only sort of ``(~mask << 30) | row``: masked rows
    sort first, in row order, so the head is the compaction.  Rows past
    2^30 do not fit that key and take a scatter of the dense positions,
    whose result is the same."""
    n = mask.shape[0]
    if n > (1 << _ROW_BITS):
        return _compact_indices_scatter(mask, capacity)
    count = torch.clamp(mask.sum(dtype=torch.int32), max=capacity)
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    keys = torch.sort(torch.where(mask, src, src | (1 << _ROW_BITS))).values
    head = keys[:capacity] & ((1 << _ROW_BITS) - 1)
    if head.shape[0] < capacity:
        head = torch.cat([head, head.new_zeros(capacity - head.shape[0])])
    slot = torch.arange(capacity, dtype=torch.int32, device=mask.device)
    return count, torch.where(slot < count, head, 0)


def _compact_indices_scatter(mask: torch.Tensor, capacity: int):
    """:func:`compact_indices` by a scatter of each masked row's dense
    position, for any row count."""
    count, tgt = _targets(mask, capacity)
    src = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    idx = src.new_zeros(capacity + 1)
    idx[tgt] = src
    return count, idx[:capacity]


def snug_capacity(n: int, headroom: float = 1.25, floor: int = 4096) -> int:
    """Padded row capacity for an ``n``-row LOD subset, a host int.

    A frame's projection and scatter cost follows the padded row count, so
    the padding is snug: ``n * headroom`` rounded up to a granule of 1/16 of
    its magnitude (2^max(12, bits - 4)), at most ~6% waste; ``headroom``
    leaves room for edits that grow the subset before the next rebuild."""
    t = max(int(n * headroom), 1)
    g = 1 << max(12, t.bit_length() - 4)
    return max(floor, -(-t // g) * g)
