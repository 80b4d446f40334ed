"""Jump-flood Voronoi: the CUDA kernel ``csrc/jump_flood.cu`` and its plain
version.

Counterpart of ``jump_flood_pallas`` (``treee_tpu/ops/pallas_kernels.py``),
batched over bands as ``segmentation._jump_flood`` is: each cell of each band
ends with the slot of the nearest seed its flood reached.  The same flood of
one rectangular grid with its own step list, :func:`jump_flood_grid`, is the
rasters' hole fill (``treee_tpu/rasters.py::jfa_fill``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

INF = 3.0e38
CLUSTER_CTAS = 8                 # CTAs of one band's thread-block cluster
BLOCK_SHARED_BYTES = 232_448     # shared memory one block may opt into (H100)


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


def _check_grid(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
                cell_center: torch.Tensor) -> None:
    if seed_slot.dim() != 2 or seed_pos.dim() != 3:
        raise ValueError(f"jump_flood_grid: need an i32[H,W] grid, got "
                         f"{seed_slot.dtype}{list(seed_slot.shape)}")
    _check(seed_slot[None], seed_pos[None], cell_center, square=False)


def jump_flood_grid_plain(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
                          cell_center: torch.Tensor,
                          step_list: list[int]) -> torch.Tensor:
    """:func:`jump_flood_plain` of one rectangular grid with an explicit
    step list: ``seed_slot`` i32[H,W], ``seed_pos`` and ``cell_center``
    f32[H,W,2]; returns i32[H,W]."""
    _check_grid(seed_slot, seed_pos, cell_center)
    return jump_flood_plain(seed_slot[None], seed_pos[None], cell_center,
                            list(step_list))[0]


def jump_flood_grid(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
                    cell_center: torch.Tensor,
                    step_list: list[int]) -> torch.Tensor:
    """The flood of one grid (see :func:`jump_flood_grid_plain`): the
    kernel's grid entry on CUDA tensors, the plain version on CPU tensors.
    One call of the entry, 2 + 8 * len(step_list) launches."""
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
    tmp = torch.empty_like(out) if step_list else None
    seed_slot = seed_slot.contiguous()
    seed_pos = build.aligned(seed_pos)
    cell_center = build.aligned(cell_center)
    host_steps = (ctypes.c_int * len(step_list))(*step_list)
    lib = build.library()
    build.launch(lib.treee_jump_flood_grid, "jump_flood_grid", seed_slot,
                 seed_slot.data_ptr(), seed_pos.data_ptr(),
                 cell_center.data_ptr(), out.data_ptr(),
                 0 if tmp is None else tmp.data_ptr(),
                 ctypes.addressof(host_steps), len(step_list), h, w)
    jump_flood_grid.launches += 1
    return out


jump_flood.launches = 0
jump_flood_grid.launches = 0
