"""Jump-flood Voronoi: the CUDA kernel ``csrc/jump_flood.cu`` and its plain
version.

Counterpart of ``jump_flood_pallas`` (``treee_tpu/ops/pallas_kernels.py``),
batched over bands as ``segmentation._jump_flood`` is: each cell of each band
ends with the slot of the nearest seed its flood reached.  The same flood of
one rectangular grid with its own step list, :func:`jump_flood_grid`, is the
rasters' hole fill (``treee_tpu/rasters.py::jfa_fill``): one kernel of
``csrc/jump_flood.cu`` that runs each step over tiles (:func:`grid_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

INF = 3.0e38
CLUSTER_CTAS = 8                 # CTAs of one band's thread-block cluster
BLOCK_SHARED_BYTES = 232_448     # shared memory one block may opt into (H100)
# the grid flood (csrc/jump_flood.cu: kTileHalo, kTileMaxSteps, kTileCells,
# kTileAxis)
TILE_HALO = 3                    # halo positions on each side of a window
TILE_MAX_STEPS = 16              # steps the grid flood takes a launch
TILE_CELLS = 15_360              # cells a tile holds (3.5 4-byte planes)
TILE_AXIS = 1024                 # cells a tile holds along one axis
TILE_COLUMN_CYCLES = 8           # cycles a tile takes side by side in columns
TILE_BLOCKS = 132                # blocks of the grid flood (one an H100 SM)
TILE_OVERHEAD = 2048             # a tile's fixed cost, in cells, for the plan
CELL_FORM_ROWS = 1 << 15         # rows and columns of the rasters' form:
CELL_FORM_COLS = 1 << 16         # its origins pack (row << 16 | col) in i32


def _check(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
           cell_center: torch.Tensor, square: bool = True) -> None:
    if seed_slot.dtype != torch.int32 or seed_slot.dim() != 3:
        raise ValueError(f"jump_flood: need i32[B,H,W] seed slots, got "
                         f"{seed_slot.dtype}{list(seed_slot.shape)}")
    b, h, w = seed_slot.shape
    if square and h != w:
        raise ValueError(f"jump_flood: bands must be square, got {h}x{w}")
    if seed_pos.dtype != torch.float32 or seed_pos.shape != (b, h, w, 2):
        raise ValueError(f"jump_flood: need f32[{b},{h},{w},2] seed "
                         f"positions, got {seed_pos.dtype}{list(seed_pos.shape)}")
    if cell_center.dtype != torch.float32 or cell_center.shape != (h, w, 2):
        raise ValueError(f"jump_flood: need f32[{h},{w},2] cell centres, got "
                         f"{cell_center.dtype}{list(cell_center.shape)}")
    if not seed_slot.device == seed_pos.device == cell_center.device:
        raise ValueError("jump_flood: inputs on different devices")


def steps(g: int) -> list[int]:
    """The flood's step lengths: g/2, g/4, ..., 1 (integer halving)."""
    out, s = [], g // 2
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def jump_flood_plain(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
                     cell_center: torch.Tensor,
                     step_list: list[int] | None = None) -> torch.Tensor:
    """Nearest-seed slot of every cell, i32[B,H,W]; -1 where no seed reached.

    ``seed_slot`` i32[B,H,W] (-1 where a cell holds no seed), ``seed_pos``
    f32[B,H,W,2] the seeds' absolute (x, z), ``cell_center`` f32[H,W,2].
    For each step s of ``step_list`` (default :func:`steps` of max(H, W),
    the segmentation's G/2, G/4, ..., 1), 8 directions in the order dy in
    (-s, 0, s), dx in (-s, 0, s), skipping (0, 0); each direction is one
    whole-grid update that reads the state the previous one left: cell
    (i, j) takes the seed of cell ((i - dy) mod H, (j - dx) mod W) where its
    squared distance (sx - cx)^2 + (sz - cz)^2 is strictly smaller.
    """
    _check(seed_slot, seed_pos, cell_center, square=False)
    if step_list is None:
        step_list = steps(max(seed_slot.shape[1:]))
    cx, cz = cell_center[..., 0], cell_center[..., 1]

    def dist(slot, sx, sz):
        ex = sx - cx
        ez = sz - cz
        return torch.where(slot >= 0, ex * ex + ez * ez, INF)

    slot = seed_slot
    sx, sz = seed_pos[..., 0], seed_pos[..., 1]
    d = dist(slot, sx, sz)
    for s in step_list:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cs = torch.roll(slot, (dy, dx), (1, 2))
                csx = torch.roll(sx, (dy, dx), (1, 2))
                csz = torch.roll(sz, (dy, dx), (1, 2))
                cd = dist(cs, csx, csz)
                better = cd < d
                slot = torch.where(better, cs, slot)
                sx = torch.where(better, csx, sx)
                sz = torch.where(better, csz, sz)
                d = torch.where(better, cd, d)
    return slot.clone() if slot is seed_slot else slot


def route(g: int) -> str:
    """Where the kernel keeps a band's origins at grid size ``g``:
    ``"shared"`` (its cluster's shared memory, double-buffered, up to
    G=480) or ``"device"`` (device memory)."""
    rows = -(-g // CLUSTER_CTAS)
    nbytes = 4 * (2 * rows * g + 4 + g)    # two planes, a flag, column z
    return "shared" if nbytes <= BLOCK_SHARED_BYTES else "device"


def jump_flood(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
               cell_center: torch.Tensor) -> torch.Tensor:
    """Jump-flood Voronoi (see :func:`jump_flood_plain`): the kernel on CUDA
    tensors, the plain version on CPU tensors.  One cluster launch a call,
    on the route :func:`route` picks by G."""
    _check(seed_slot, seed_pos, cell_center)
    if not build.on_cuda(seed_slot, "jump_flood"):
        return jump_flood_plain(seed_slot, seed_pos, cell_center)
    b, g, _ = seed_slot.shape
    out = torch.empty_like(seed_slot, memory_format=torch.contiguous_format)
    if b == 0 or g == 0:
        return out
    shared = route(g) == "shared"
    tmp = None if shared else torch.empty_like(out)
    seed_slot = seed_slot.contiguous()
    seed_pos = build.aligned(seed_pos)
    cell_center = build.aligned(cell_center)
    lib = build.library()
    build.launch(lib.treee_jump_flood, "jump_flood", seed_slot,
                 seed_slot.data_ptr(), seed_pos.data_ptr(),
                 cell_center.data_ptr(), out.data_ptr(),
                 0 if tmp is None else tmp.data_ptr(), b, g, int(shared))
    jump_flood.launches += 1
    return out


def resident_clusters(g: int) -> int:
    """How many of the kernel's 8-CTA clusters the current card holds at
    once at grid size ``g`` (card only)."""
    n = build.library().treee_jump_flood_clusters(g, int(route(g) == "shared"))
    if n < 0:
        build.check(-n, "jump_flood")
    return n


def _check_grid(seed_slot: torch.Tensor, seed_pos: torch.Tensor | None,
                cell_center: torch.Tensor | None) -> None:
    if seed_slot.dim() != 2:
        raise ValueError(f"jump_flood_grid: need an i32[H,W] grid, got "
                         f"{seed_slot.dtype}{list(seed_slot.shape)}")
    if (seed_pos is None) != (cell_center is None):
        raise ValueError("jump_flood_grid: give both seed positions and "
                         "cell centres, or neither (seeds at their cells)")
    if seed_pos is None:
        if seed_slot.dtype != torch.int32:
            raise ValueError(f"jump_flood_grid: need i32 seed slots, got "
                             f"{seed_slot.dtype}")
        h, w = seed_slot.shape
        if h >= CELL_FORM_ROWS or w >= CELL_FORM_COLS:
            raise ValueError(f"jump_flood_grid: seeds at their cells need "
                             f"fewer than {CELL_FORM_ROWS} rows and "
                             f"{CELL_FORM_COLS} columns, got {[h, w]}")
        return
    if seed_pos.dim() != 3:
        raise ValueError(f"jump_flood_grid: need f32[H,W,2] seed positions, "
                         f"got {seed_pos.dtype}{list(seed_pos.shape)}")
    _check(seed_slot[None], seed_pos[None], cell_center, square=False)


def cell_positions(h: int, w: int, device) -> torch.Tensor:
    """f32[h,w,2]: each cell's (row, col), the seed positions and cell
    centres of a flood whose seeds sit at their own cells."""
    rows = torch.arange(h, dtype=torch.float32, device=device)
    cols = torch.arange(w, dtype=torch.float32, device=device)
    return torch.stack([rows[:, None].expand(h, w),
                        cols[None, :].expand(h, w)], -1).contiguous()


def jump_flood_grid_plain(seed_slot: torch.Tensor,
                          seed_pos: torch.Tensor | None,
                          cell_center: torch.Tensor | None,
                          step_list: list[int]) -> torch.Tensor:
    """:func:`jump_flood_plain` of one rectangular grid with an explicit
    step list: ``seed_slot`` i32[H,W], ``seed_pos`` and ``cell_center``
    f32[H,W,2], or both None for seeds at their own cells and every centre
    at its cell's (row, col) (:func:`cell_positions`); returns i32[H,W]."""
    _check_grid(seed_slot, seed_pos, cell_center)
    if seed_pos is None:
        seed_pos = cell_center = cell_positions(*seed_slot.shape,
                                                seed_slot.device)
    return jump_flood_plain(seed_slot[None], seed_pos[None], cell_center,
                            list(step_list))[0]


def tile_axis(n: int, s: int, q: int, t: int) -> dict:
    """One axis of the grid flood's tiles for step ``s`` (``TileAxis`` of
    ``csrc/jump_flood.cu``): along ``n`` cells the step moves seeds along
    ``g`` = gcd(s mod n, n) cycles of ``p`` = n / g positions; a tile takes
    ``q`` adjacent cycles by ``t`` core positions, with ``halo`` positions
    on each side (none where t == p, the whole cycle): ``len`` cells along
    the axis, ``wins`` windows a cycle, ``tiles`` tiles along the axis."""
    r = s % n
    g = math.gcd(r, n)
    p = n // g
    if not (1 <= q <= g and 1 <= t <= p):
        raise ValueError(f"tile_axis: q={q}, t={t} for {g} cycles of {p}")
    halo = 0 if t == p else TILE_HALO
    wins = -(-p // t)
    return {"n": n, "s": r, "g": g, "p": p, "q": q, "t": t, "halo": halo,
            "len": (t + 2 * halo) * q, "wins": wins,
            "tiles": -(-g // q) * wins}


def _axis_choice(n: int, s: int, budget: int, q_min: int):
    """(q, t) of the largest tile along an axis within ``budget`` cells:
    whole cycles where ``q_min`` of them fit (as many as fit), else a
    window of ``q_min`` cycles; None where neither fits."""
    g = math.gcd(s % n, n)
    p = n // g
    q0 = min(g, q_min)
    if p * q0 <= budget:
        return min(g, budget // p), p
    t = budget // q0 - 2 * TILE_HALO
    return (q0, t) if t >= 1 else None


def _budgets(limit: int) -> list[int]:
    """Tile lengths to try along an axis: from 8 up by about a quarter
    each, below ``limit``, then ``limit``."""
    out, b = [], 8
    while b < limit:
        out.append(b)
        b += max(4, b // 4 // 4 * 4)
    return out + [limit]


@functools.lru_cache(maxsize=256)
def grid_plan(h: int, w: int, steps: tuple[int, ...],
              tile_cells: int = TILE_CELLS,
              axis_cells: int = TILE_AXIS) -> tuple[tuple[int, ...], ...]:
    """The grid flood's tiles, (q, t) of the rows then of the columns, for
    each step: of the tile shapes within ``tile_cells`` and ``axis_cells``
    whose columns hold at least :data:`TILE_COLUMN_CYCLES` adjacent cycles
    (or all), the one whose step takes the least time on
    :data:`TILE_BLOCKS` blocks: the waves of tiles times a tile's cells
    (halos included) plus :data:`TILE_OVERHEAD`; ties to fewer cells."""
    plan = []
    for s in steps:
        best = None
        for b_c in _budgets(axis_cells):
            col = _axis_choice(w, s, b_c, TILE_COLUMN_CYCLES)
            if col is None:
                continue
            ca = tile_axis(w, s, *col)
            for b_r in _budgets(min(axis_cells, tile_cells // ca["len"])):
                row = _axis_choice(h, s, b_r, 1)
                if row is None:
                    continue
                ra = tile_axis(h, s, *row)
                tiles = ra["tiles"] * ca["tiles"]
                cells = ra["len"] * ca["len"]
                key = (-(-tiles // TILE_BLOCKS) * (cells + TILE_OVERHEAD),
                       tiles * cells)
                if best is None or key < best[0]:
                    best = (key, row + col)
        if best is None:
            raise ValueError(f"grid_plan: no tile fits {tile_cells} cells "
                             f"for step {s} of a {h}x{w} grid")
        plan.append(best[1])
    return tuple(plan)


def grid_launches(h: int, w: int, step_list: list[int]) -> int:
    """CUDA launches one :func:`jump_flood_grid` call makes on the card:
    one a :data:`TILE_MAX_STEPS` steps (one for no step)."""
    if h * w == 0:
        return 0
    return max(1, -(-len(step_list) // TILE_MAX_STEPS))


@functools.lru_cache(maxsize=64)
def _host_args(h: int, w: int, steps: tuple[int, ...]):
    """The entry's host arrays: the steps and the plan, flattened (kept
    alive by the cache)."""
    host_steps = (ctypes.c_int * max(1, len(steps)))(*steps)
    flat = [v for entry in grid_plan(h, w, steps) for v in entry]
    return host_steps, (ctypes.c_int * max(1, len(flat)))(*flat)


def jump_flood_grid(seed_slot: torch.Tensor, seed_pos: torch.Tensor | None,
                    cell_center: torch.Tensor | None,
                    step_list: list[int]) -> torch.Tensor:
    """The flood of one grid (see :func:`jump_flood_grid_plain`): the
    kernel's grid entry on CUDA tensors (:func:`grid_launches` CUDA
    launches), the plain version on CPU tensors.  ``seed_pos`` and
    ``cell_center`` None: seeds at their own cells, centres at (row, col),
    and the kernel derives both from the cell index."""
    _check_grid(seed_slot, seed_pos, cell_center)
    step_list = [int(s) for s in step_list]
    if any(s < 1 for s in step_list):
        raise ValueError(f"jump_flood_grid: steps must be >= 1, got "
                         f"{step_list}")
    if not build.on_cuda(seed_slot, "jump_flood_grid"):
        return jump_flood_grid_plain(seed_slot, seed_pos, cell_center,
                                     step_list)
    h, w = seed_slot.shape
    if h * w >= 2**31:
        raise ValueError(f"jump_flood_grid: {h}x{w} cells do not fit i32")
    out = torch.empty((h, w), dtype=torch.int32, device=seed_slot.device)
    if h * w == 0:
        return out
    tmp = torch.empty_like(out) if len(step_list) > 1 else None
    seed_slot = seed_slot.contiguous()
    pos_ptr = cc_ptr = 0
    if seed_pos is not None:
        seed_pos = build.aligned(seed_pos)
        cell_center = build.aligned(cell_center)
        pos_ptr, cc_ptr = seed_pos.data_ptr(), cell_center.data_ptr()
    host_steps, host_tiles = _host_args(h, w, tuple(step_list))
    lib = build.library()
    build.launch(lib.treee_jump_flood_grid, "jump_flood_grid", seed_slot,
                 seed_slot.data_ptr(), pos_ptr, cc_ptr, out.data_ptr(),
                 0 if tmp is None else tmp.data_ptr(),
                 ctypes.addressof(host_steps), ctypes.addressof(host_tiles),
                 len(step_list), h, w)
    jump_flood_grid.launches += 1
    return out


jump_flood.launches = 0
jump_flood_grid.launches = 0
