"""Jump-flood Voronoi: the CUDA kernel ``csrc/jump_flood.cu`` and its plain
version.

Counterpart of ``jump_flood_pallas`` (``treee_tpu/ops/pallas_kernels.py``),
batched over bands as ``segmentation._jump_flood`` is: each cell of each band
ends with the slot of the nearest seed its flood reached.
"""

from __future__ import annotations

import torch

from . import build

INF = 3.0e38
CLUSTER_CTAS = 8                 # CTAs of one band's thread-block cluster
BLOCK_SHARED_BYTES = 232_448     # shared memory one block may opt into (H100)


def _check(seed_slot: torch.Tensor, seed_pos: torch.Tensor,
           cell_center: torch.Tensor) -> None:
    if seed_slot.dtype != torch.int32 or seed_slot.dim() != 3:
        raise ValueError(f"jump_flood: need i32[B,G,G] seed slots, got "
                         f"{seed_slot.dtype}{list(seed_slot.shape)}")
    b, g, g2 = seed_slot.shape
    if g != g2:
        raise ValueError(f"jump_flood: bands must be square, got {g}x{g2}")
    if seed_pos.dtype != torch.float32 or seed_pos.shape != (b, g, g, 2):
        raise ValueError(f"jump_flood: need f32[{b},{g},{g},2] seed "
                         f"positions, got {seed_pos.dtype}{list(seed_pos.shape)}")
    if cell_center.dtype != torch.float32 or cell_center.shape != (g, g, 2):
        raise ValueError(f"jump_flood: need f32[{g},{g},2] cell centres, got "
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
                     cell_center: torch.Tensor) -> torch.Tensor:
    """Nearest-seed slot of every cell, i32[B,G,G]; -1 where no seed reached.

    ``seed_slot`` i32[B,G,G] (-1 where a cell holds no seed), ``seed_pos``
    f32[B,G,G,2] the seeds' absolute (x, z), ``cell_center`` f32[G,G,2].
    For each step s of :func:`steps`, 8 directions in the order dy in
    (-s, 0, s), dx in (-s, 0, s), skipping (0, 0); each direction is one
    whole-grid update that reads the state the previous one left: cell
    (i, j) takes the seed of cell ((i - dy) mod G, (j - dx) mod G) where its
    squared distance (sx - cx)^2 + (sz - cz)^2 is strictly smaller.
    """
    _check(seed_slot, seed_pos, cell_center)
    cx, cz = cell_center[..., 0], cell_center[..., 1]

    def dist(slot, sx, sz):
        ex = sx - cx
        ez = sz - cz
        return torch.where(slot >= 0, ex * ex + ez * ez, INF)

    slot = seed_slot
    sx, sz = seed_pos[..., 0], seed_pos[..., 1]
    d = dist(slot, sx, sz)
    for s in steps(seed_slot.shape[-1]):
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


jump_flood.launches = 0
