"""k-nearest-neighbour search: tiled brute force (exact) and a grid hash;
the port of ``treee_tpu/ops/neighbors.py``.

Replaces the reference's ``k-nearest`` KD-tree crate (k-nearest/src/
kd_tree.rs:19-143), used for the 31-neighbour curvature property
(treee/src/calculations.rs:328-373).

- ``knn_bruteforce``: exact search, ``kernels.knn_select`` (one hand kernel
  on the card, query tiles on the CPU).  Squared distances from the
  coordinates' differences, ``(dx^2 + dy^2) + dz^2`` in f32, as the grid
  query takes them (no matrix multiply, so no TF32, and the card's
  distances equal the CPU's bit for bit).  The JAX package's identity
  ``|q|^2 + |p|^2 - 2 q.p`` cancels: at coordinates ~100 m from the origin
  its error (~1e-3 m^2) exceeds the gaps between a point's 31st and 32nd
  neighbours, and picks other neighbours for ~40% of a tree's points.
- ``knn_grid``: a grid hash built by one stable sort of cell ids; each query
  takes up to ``cell_capacity`` candidates from each of its 27 neighbour
  cells.  Approximate where a cell overflows its cap or true neighbours lie
  beyond the neighbour cells.
- ``knn_grid_reduce``: the grid query in blocks of rows sized from the
  device's free memory, each block reduced per row at once, so nothing
  ``[N, k, 3]``-shaped exists for the whole cloud.

The k nearest come in ascending distance, ties to the lower index (brute
force) or the lower candidate position (grid), as ``lax.top_k`` orders
them: each distance's bits and its position form one int64 key, so the
selection has exactly one answer on every device and run.  Both return the
query itself among its neighbours (the reference KD-tree does too).
"""

from __future__ import annotations

import torch

from ..config import NeighborConfig
from ..utils.profiling import span
from . import kernels
from .f32 import full, sum3
from .kernels.knn_select import smallest_k

INF = 3.0e38
INVALID_CID = 0x7FFFFFFF
# the 27 neighbour cells in (dx, dy, dz) loop order, dz fastest
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
# bytes a grid query row holds at once (27 * cap candidates of slots,
# coordinates, distances and keys), per candidate
_GRID_BYTES_PER_CANDIDATE = 48


def knn_bruteforce(pos: torch.Tensor, valid: torch.Tensor, k: int = 31,
                   tile: int = NeighborConfig.query_tile
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of every point against all valid points.

    Returns (indices i32[N,k], sqdist f32[N,k]); invalid points sit at
    distance INF, so a query with fewer than k valid points is padded with
    them, lowest index first.  Exact counterpart of KDTree::k_nearest with
    unbounded radius (calculations.rs:279-280: k=31, max_distance=f32::MAX).
    ``k`` is at least 1 and, but for N = 0, at most N; on the card at most
    ``kernels.knn_select``'s 64.
    """
    with span("neighbors.knn", pos.device):
        return kernels.knn_select(pos, valid, k, tile)


class GridHash:
    """The cell-sorted hash of the valid points of ``pos``: cell ids sorted
    stably (so a cell's points keep index order), the point order, the
    coordinates in that order, and each row's cell.  Cells are
    ``_effective_cell``'s, clipped to the 2^grid_bits grid; invalid rows get
    cell id 0x7FFFFFFF and sort last."""

    def __init__(self, pos: torch.Tensor, valid: torch.Tensor, cell_size,
                 grid_bits: int = 7):
        self.grid_bits = grid_bits
        g = 1 << grid_bits
        lo, cs = _effective_cell(pos, valid, cell_size, grid_bits)
        f = torch.floor(torch.div(pos - lo, cs))
        # clamped as floats: an int conversion of a value out of range is
        # undefined, and XLA's saturates before the clip
        self.cell = torch.clamp(f, 0, g - 1).to(torch.int32)
        cid = _cell_id(self.cell, grid_bits)
        cid = torch.where(valid, cid, INVALID_CID)
        self.cell_ids_sorted, order = torch.sort(cid, stable=True)
        self.point_order = order.to(torch.int32)
        self.sorted_pos = pos[order]
        self.pos = pos
        self.n = pos.shape[0]


def _cell_id(cell: torch.Tensor, grid_bits: int) -> torch.Tensor:
    return ((cell[..., 0] << (2 * grid_bits)) | (cell[..., 1] << grid_bits)
            | cell[..., 2])


def _effective_cell(pos: torch.Tensor, valid: torch.Tensor, cell_size,
                    grid_bits: int):
    """(lo, cell size): the grid origin and the cell size coarsened so that
    the 2^grid_bits cells a side cover the scene, max(cell, ext/(2^bits-1))."""
    g = 1 << grid_bits
    lo = torch.where(valid[:, None], pos, INF).amin(dim=0)
    hi = torch.where(valid[:, None], pos, -INF).amax(dim=0)
    ext = torch.clamp((hi - lo).amax(), min=0.0)
    cs = torch.maximum(full(float(cell_size), ext),
                       torch.div(ext, full(float(g - 1), ext)))
    return lo, cs


def _query(grid: GridHash, rows: torch.Tensor, k: int, cell_capacity: int):
    """(idx i32[B,k], dist f32[B,k], nbrs f32[B,k,3]) of the query rows
    ``rows`` i64[B] of the hashed cloud."""
    g = 1 << grid.grid_bits
    dev = rows.device
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    qc = grid.cell[rows]
    nc = qc[:, None, :] + offs[None, :, :]                      # [B,27,3]
    in_grid = ((nc >= 0) & (nc < g)).all(dim=-1)
    ncid = _cell_id(nc, grid.grid_bits).contiguous()
    start = torch.searchsorted(grid.cell_ids_sorted, ncid, side="left")
    end = torch.searchsorted(grid.cell_ids_sorted, ncid, side="right")
    slot_off = torch.arange(cell_capacity, dtype=start.dtype, device=dev)
    slots = start[..., None] + slot_off                         # [B,27,cap]
    ok = (in_grid[..., None] & (slots < end[..., None])).flatten(1)
    slots = torch.clamp(slots, 0, grid.n - 1).flatten(1)        # [B,27*cap]
    cand = grid.sorted_pos[slots]                               # [B,C,3]
    qp = grid.pos[rows]
    dx = cand[..., 0] - qp[:, 0:1]
    dy = cand[..., 1] - qp[:, 1:2]
    dz = cand[..., 2] - qp[:, 2:3]
    d = torch.where(ok, sum3(dx * dx, dy * dy, dz * dz), INF)
    sel, dist = smallest_k(d, k)
    chosen = torch.gather(slots, 1, sel)
    idx = grid.point_order[chosen]
    nbrs = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 3))
    return idx, dist, nbrs


def query_block(cell_capacity: int, device: torch.device) -> int:
    """Query rows a grid block takes: a quarter of the card's free memory
    (at most 2 GiB), or 256 MiB on the CPU, over what one row holds."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = min(free // 4, 2 << 30)
    else:
        budget = 256 << 20
    per_row = 27 * cell_capacity * _GRID_BYTES_PER_CANDIDATE
    return max(1024, budget // per_row)


def knn_grid_reduce(pos: torch.Tensor, valid: torch.Tensor, cell_size,
                    per_row, k: int = 31, cell_capacity: int = 16,
                    grid_bits: int = 7, rows: torch.Tensor | None = None):
    """Grid k-NN of the query ``rows`` (default: every row) with a per-row
    reduction: ``per_row(idx i32[B,k], dist f32[B,k], nbrs f32[B,k,3])``
    returns a tuple of ``[B, ...]`` tensors, called on blocks of rows sized
    by :func:`query_block`; returns those tensors for all query rows.  The
    hash holds the valid points; a result does not depend on the blocks."""
    with span("neighbors.knn", pos.device):
        grid = GridHash(pos, valid, cell_size, grid_bits)
        if rows is None:
            rows = torch.arange(pos.shape[0], device=pos.device)
        block = query_block(cell_capacity, pos.device)
        parts = [per_row(*_query(grid, rows[b0:b0 + block], k,
                                 cell_capacity))
                 for b0 in range(0, rows.shape[0], block)]
        if not parts:
            parts = [per_row(*_query(grid, rows[:0], k, cell_capacity))]
        return tuple(torch.cat(leaves) for leaves in zip(*parts))


def knn_grid(pos: torch.Tensor, valid: torch.Tensor, cell_size, k: int = 31,
             cell_capacity: int = 16, grid_bits: int = 7
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN of every point via the 27-cell candidate gather:
    (indices i32[N,k], sqdist f32[N,k]).  A missing candidate sits at
    distance INF with the index of the clipped slot, as in the JAX
    package."""
    return knn_grid_reduce(pos, valid, cell_size, lambda i, d, nb: (i, d),
                           k=k, cell_capacity=cell_capacity,
                           grid_bits=grid_bits)


def neighbor_covariance_from(nbrs: torch.Tensor,
                             nbr_valid: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Covariance f32[M,3,3] of pre-gathered neighbour coordinates
    f32[M,k,3]: the mean over the valid neighbours, then the outer products
    summed and divided by their count, not count - 1 (calculations.rs:
    342-365).  Each entry is one sum over k, in the same order on every
    device; the matrix is symmetric by construction."""
    m, k = nbrs.shape[0], nbrs.shape[1]
    if nbr_valid is None:
        w = torch.ones((m, k, 1), dtype=torch.float32, device=nbrs.device)
    else:
        w = nbr_valid.to(torch.float32)[..., None]
    count = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)     # [M,1,1]
    mean = torch.div((nbrs * w).sum(dim=1, keepdim=True), count)
    diff = (nbrs - mean) * w
    cov = torch.empty((m, 3, 3), dtype=torch.float32, device=nbrs.device)
    for i in range(3):
        for j in range(i, 3):
            c = (diff[..., i] * diff[..., j]).sum(dim=1)
            cov[:, i, j] = c
            cov[:, j, i] = c
    return torch.div(cov, count)


def neighbor_covariance(pos: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_valid: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Covariance of each point's neighbour set, f32[N,3,3]; gathers the
    ``[N, k, 3]`` neighbour coordinates (fine for a segment's rows)."""
    return neighbor_covariance_from(pos[nbr_idx.long()], nbr_valid)
