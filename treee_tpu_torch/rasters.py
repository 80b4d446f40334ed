"""Terrain and canopy rasters: DTM, DSM, CHM (``treee_tpu/rasters.py``).

A digital terrain model (DTM) from ground-classified returns, a digital
surface model (DSM) from all live returns, and their difference, the canopy
height model (CHM); and each point's height above the hole-filled DTM.

The per-cell extremes are an integer min / max over the order-preserving
i32 image of the heights (``f32.order``), of the selected rows only:
integer atomics give the same bits on every run on the card, the sign of
zero included.  Ground holes take the nearest ground cell's
height by a jump flood over the grid, ``kernels.jump_flood_grid`` with the
JAX package's schedule (``next_pow2(max(H, W))/2, ..., 1``, then ``2, 1``),
each cell's seed carried as the seed cell's flat index.  Grid dims are
padded up to multiples of 128 as in the JAX package, so the flood wraps
over the same padded grid; callers get the live window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cloud import CLASS_GROUND
from .ops import kernels
from .ops.f32 import full, order, unorder
from .parallel.program import run_alone

BIG = 3.0e38
NODATA = -9999.0


def grid_dims(lo, hi, cell: float, cap: int = 4096, pad: int = 128):
    """Host-side raster sizing: ((rows, cols), padded (rows, cols), cell).

    ``cell`` grows to fit a ``cap``-cell axis when the scene is larger
    (same policy as segmentation.cell_size's static-grid growth); padded
    dims are multiples of ``pad`` for lane-aligned device layouts.
    """
    ex = float(hi[0]) - float(lo[0])
    ez = float(hi[2]) - float(lo[2])
    cell = float(cell)
    need = max(ex, ez) / max(cap - 1, 1)
    if need > cell:
        cell = need
    cols = max(1, int(math.floor(ex / cell)) + 1)
    rows = max(1, int(math.floor(ez / cell)) + 1)
    pad_r = (rows + pad - 1) // pad * pad
    pad_c = (cols + pad - 1) // pad * pad
    return (rows, cols), (pad_r, pad_c), cell


def cell_index(pos: torch.Tensor, lo_x: torch.Tensor, lo_z: torch.Tensor,
               inv_cell: torch.Tensor, width: int,
               live_dims: tuple[int, int]) -> torch.Tensor:
    """i32[N] flat cell of each point in a grid ``width`` cells wide: the
    offsets times ``inv_cell`` (f32 0-d tensors, a multiply, not a
    division), truncated, clipped to the live ``(rows, cols)``."""
    lr, lc = live_dims
    ix = torch.clamp(((pos[:, 0] - lo_x) * inv_cell).to(torch.int32), 0, lc - 1)
    iz = torch.clamp(((pos[:, 2] - lo_z) * inv_cell).to(torch.int32), 0, lr - 1)
    return iz * width + ix


def _extreme(flat: torch.Tensor, y: torch.Tensor, rows: torch.Tensor,
             size: int, fill: float, reduce: str) -> torch.Tensor:
    """f32[size]: ``reduce`` ("amin" | "amax") of ``y`` over the selected
    ``rows`` in each cell, ``fill`` where none falls."""
    out = order(torch.full((size,), fill, dtype=torch.float32,
                           device=y.device))
    return unorder(out.scatter_reduce_(0, flat[rows].long(), order(y[rows]),
                                       reduce))


def height_grids(pos, ground, live, lo_x, lo_z, inv_cell, shape,
                 live_dims=None):
    """(dtm, dsm) f32[H, W]: min ground y / max live y per cell; empty cells
    hold the sentinels +BIG (DTM) and -BIG (DSM).

    ``live_dims`` (rows, cols) bounds the index clip so f32 rounding at the
    max-extent boundary cannot push the extreme point into a padded cell
    that callers slice off."""
    h, w = shape
    flat = cell_index(pos, lo_x, lo_z, inv_cell, w,
                      live_dims if live_dims is not None else (h, w))
    y = pos[:, 1]
    dtm = _extreme(flat, y, ground, h * w, BIG, "amin")
    dsm = _extreme(flat, y, live, h * w, -BIG, "amax")
    return dtm.view(h, w), dsm.view(h, w)


def jfa_steps(h: int, w: int) -> list[int]:
    """The raster flood's steps: next_pow2(max(h, w))/2, ..., 1, then 2, 1
    (JFA+2: mops up the rare misroutes of plain JFA)."""
    steps = []
    s = max(1, (1 << (max(h, w) - 1).bit_length()) // 2)
    while s >= 1:
        steps.append(s)
        s //= 2
    return steps + [2, 1]


def jfa_fill(grid: torch.Tensor, have: torch.Tensor):
    """Fill cells where ``have`` is False with the nearest seeded value:
    (f32[H,W] values, bool[H,W] ok), 0 and False where no seed is.

    A seed is its cell's flat index, at (row, col); every cell centre is
    its own (row, col), so the flood's f32 distances are sums of two exact
    integer squares, as in the JAX package.  The flood takes that form
    directly (no position planes): the kernel derives both from the
    index."""
    h, w = grid.shape
    slot = torch.where(have, torch.arange(h * w, dtype=torch.int32,
                                          device=grid.device).view(h, w), -1)
    origin = kernels.jump_flood_grid(slot, None, None, jfa_steps(h, w))
    ok = origin >= 0
    val = grid.reshape(-1)[origin.clamp(min=0).long()].view(h, w)
    return torch.where(ok, val, 0.0), ok


def compute_rasters(pos, classification, live, lo, hi, cell: float,
                    cap: int = 4096, y_offset: float = 0.0):
    """DTM / DSM / CHM over live points; returns (dict of f32[rows, cols]
    numpy arrays with NODATA holes, (rows, cols), cell).

    - ``dtm``: min ground-return height per cell, holes filled from the
      nearest ground cell (jump flood); NODATA only when the scene has no
      ground returns at all.  ``y_offset`` (the load-time recentering)
      shifts DTM/DSM to absolute map elevations.
    - ``dsm``: max live-return height per cell; NODATA where no returns.
    - ``chm``: max(dsm - dtm, 0) where the DSM exists; NODATA elsewhere.
    """
    (rows, cols), (ph, pw), cell = grid_dims(lo, hi, cell, cap=cap)
    ground = live & (classification == CLASS_GROUND)
    dtm_raw, dsm_raw = height_grids(
        pos, ground, live, full(lo[0], pos), full(lo[2], pos),
        full(1.0 / cell, pos), (ph, pw), (rows, cols))
    return (finalize_rasters(dtm_raw, dsm_raw, rows, cols, y_offset=y_offset),
            (rows, cols), cell)


def height_above_ground(pos, classification, live, lo_x, lo_z, inv_cell,
                        shape, live_dims):
    """Per-point height above the hole-filled DTM, f32[N] >= 0.

    The DTM is rasterized from ground-classified returns (the DTM of
    :func:`compute_rasters`) and every live point reads its cell's ground
    elevation.  Non-live points (and scenes with no ground returns at all)
    read 0."""
    return run_alone(height_above_ground_shard(
        pos, classification, live, lo_x, lo_z, inv_cell, shape, live_dims,
        across=False))


def height_above_ground_shard(pos, classification, live, lo_x, lo_z,
                              inv_cell, shape, live_dims, across: bool):
    """:func:`height_above_ground` as a shard program
    (``parallel/program.py``): over shards the raw DTM takes one min (exact)
    and is filled once, for every shard."""
    h, w = shape
    ground = live & (classification == CLASS_GROUND)
    flat = cell_index(pos, lo_x, lo_z, inv_cell, w, live_dims)
    dtm_raw = _extreme(flat, pos[:, 1], ground, h * w, BIG, "amin")
    if across:
        dtm_raw = yield "min", dtm_raw

    def fill():
        return jfa_fill(dtm_raw.view(h, w), dtm_raw.view(h, w) < BIG)
    dtm, ok = (yield "once", fill) if across else fill()
    at = flat.long()
    hag = torch.clamp(pos[:, 1] - dtm.reshape(-1)[at], min=0.0)
    return torch.where(live & ok.reshape(-1)[at], hag, 0.0)


def finalize_rasters(dtm_raw, dsm_raw, rows: int, cols: int,
                     y_offset: float = 0.0) -> dict[str, np.ndarray]:
    """Sentinel grids -> hole-filled / NODATA rasters dict of host arrays.

    ``y_offset`` restores the load-time recentering (world_offset[1]) on
    the absolute-elevation products DTM/DSM so .asc values are true map
    elevations; CHM is a difference and takes no offset.
    """
    dtm_filled, filled_ok = jfa_fill(dtm_raw, dtm_raw < BIG)
    have_s = dsm_raw > -BIG
    chm = torch.clamp(dsm_raw - dtm_filled, min=0.0)
    yo = full(y_offset, dtm_raw)

    def host(a):
        return a[:rows, :cols].contiguous().cpu().numpy()

    return {
        "dtm": host(torch.where(filled_ok, dtm_filled + yo, NODATA)),
        "dsm": host(torch.where(have_s, dsm_raw + yo, NODATA)),
        "chm": host(torch.where(have_s & filled_ok, chm, NODATA)),
    }
