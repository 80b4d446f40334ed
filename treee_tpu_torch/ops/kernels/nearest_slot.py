"""The step's occupied-cell Voronoi: the CUDA kernel ``csrc/nearest_slot.cu``
and its plain version.

No TPU kernel of the JAX package does this: it computes the stage with XLA
ops (``treee_tpu/segmentation.py::_bruteforce_voronoi``), which the plain
version below follows, chunked over the slots with a running minimum.  The
kernel stages each band's active slots in shared memory and walks them
against the occupied cells' centres in registers (see the source's note).

The two agree bit for bit on finite positions.  A NaN distance would skip
its whole chunk in the plain version (its ``amin`` is NaN) and only itself
in the kernel; the step's positions are finite.
"""

from __future__ import annotations

import torch

from . import build

INF = 3.0e38


def cell_centers(occ_idx: torch.Tensor, lo: torch.Tensor, s: torch.Tensor,
                 g: int):
    """(x, z) centres of the cells at global flat indices ``occ_idx``."""
    cell = occ_idx % (g * g)
    cx = lo[0] + ((cell // g).float() + 0.5) * s
    cz = lo[2] + ((cell % g).float() + 0.5) * s
    return cx, cz


def _check(occ_idx, occ_valid, tracked_pos, active, lo, s, n_bands: int,
           g: int, chunk: int) -> None:
    if occ_idx.dtype != torch.int32 or occ_idx.dim() != 1:
        raise ValueError(f"nearest_slot: need i32[R] cell indices, got "
                         f"{occ_idx.dtype}{list(occ_idx.shape)}")
    if occ_valid.dtype != torch.bool or occ_valid.shape != occ_idx.shape:
        raise ValueError(f"nearest_slot: need bool{list(occ_idx.shape)} row "
                         f"flags, got {occ_valid.dtype}"
                         f"{list(occ_valid.shape)}")
    if (tracked_pos.dtype != torch.float32 or tracked_pos.dim() != 3
            or tracked_pos.shape[0] != n_bands or tracked_pos.shape[2] != 2):
        raise ValueError(f"nearest_slot: need f32[{n_bands},T,2] slot "
                         f"positions, got {tracked_pos.dtype}"
                         f"{list(tracked_pos.shape)}")
    if active.dtype != torch.bool or active.shape != tracked_pos.shape[:2]:
        raise ValueError(f"nearest_slot: need bool"
                         f"{list(tracked_pos.shape[:2])} slot flags, got "
                         f"{active.dtype}{list(active.shape)}")
    if lo.dtype != torch.float32 or lo.shape != (3,):
        raise ValueError(f"nearest_slot: need f32[3] lo, got "
                         f"{lo.dtype}{list(lo.shape)}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"nearest_slot: need one f32 cell size, got "
                         f"{s.dtype}{list(s.shape)}")
    if g < 1 or n_bands * g * g > 0x7FFFFFFF:
        raise ValueError(f"nearest_slot: {n_bands} bands of {g}x{g} cells "
                         "do not fit i32 cell indices")
    if chunk < 1:
        raise ValueError(f"nearest_slot: chunk must be >= 1, got {chunk}")
    if not (occ_idx.device == occ_valid.device == tracked_pos.device
            == active.device == lo.device == s.device):
        raise ValueError("nearest_slot: inputs on different devices")


def nearest_slot_plain(occ_idx, occ_valid, tracked_pos_b, active_b, lo, s,
                       n_bands: int, g: int, chunk: int) -> torch.Tensor:
    """Nearest active tracked slot of each occupied cell's band, i32[B,G,G].

    ``occ_idx`` i32[R] global flat indices (band * G * G + cell) of the
    occupied cells, ``occ_valid`` bool[R] which rows hold one,
    ``tracked_pos_b`` f32[B,T,2] and ``active_b`` bool[B,T] the slots,
    ``lo`` f32[3] and ``s`` the grid's origin and cell size.  Each occupied
    cell scores every slot of its band, chunked over the slots with a
    running minimum; ties go to the lowest slot.  Cells that are not among
    the valid rows, and empty cells, get -1.
    """
    _check(occ_idx, occ_valid, tracked_pos_b, active_b, lo, s, n_bands, g,
           chunk)
    gg = g * g
    t_cap = tracked_pos_b.shape[1]
    occ_band = (occ_idx // gg).long()
    ccx, ccz = cell_centers(occ_idx, lo, s, g)
    best_d = torch.full_like(ccx, INF)
    best = torch.full_like(occ_idx, -1)
    for c0 in range(0, t_cap, chunk):
        c1 = min(c0 + chunk, t_cap)
        tp = tracked_pos_b[:, c0:c1][occ_band]               # [occ, chunk, 2]
        at = active_b[:, c0:c1][occ_band]
        ex = ccx[:, None] - tp[..., 0]
        ez = ccz[:, None] - tp[..., 1]
        dist = torch.where(at, ex * ex + ez * ez, INF)
        dm = dist.amin(dim=1)
        j = torch.argmin(dist, dim=1)
        upd = dm < best_d
        best = torch.where(upd & (dm < INF), c0 + j.to(torch.int32), best)
        best_d = torch.where(upd, dm, best_d)
    # the padding rows scatter to a drop slot past the grid
    tgt = torch.where(occ_valid, occ_idx, n_bands * gg)
    out = torch.full((n_bands * gg + 1,), -1, dtype=best.dtype,
                     device=best.device)
    out[tgt.long()] = best
    return out[:n_bands * gg].view(n_bands, g, g)


def nearest_slot(occ_idx, occ_valid, tracked_pos_b, active_b, lo, s,
                 n_bands: int, g: int, chunk: int) -> torch.Tensor:
    """Occupied-cell Voronoi (see :func:`nearest_slot_plain`): the kernel on
    CUDA tensors, the plain version on CPU tensors.  ``chunk`` is the plain
    version's; the kernel stages the slots as shared memory allows.

    A valid row's index must lie in the grid: the plain version raises on
    one that does not (on the CPU), the kernel writes nothing for it, since
    a check would cost a synchronisation."""
    _check(occ_idx, occ_valid, tracked_pos_b, active_b, lo, s, n_bands, g,
           chunk)
    if not build.on_cuda(occ_idx, "nearest_slot"):
        return nearest_slot_plain(occ_idx, occ_valid, tracked_pos_b,
                                  active_b, lo, s, n_bands, g, chunk)
    occ_idx, occ_valid = occ_idx.contiguous(), occ_valid.contiguous()
    tracked_pos_b = build.aligned(tracked_pos_b)
    active_b, lo, s = active_b.contiguous(), lo.contiguous(), s.contiguous()
    out = torch.empty((n_bands, g, g), dtype=torch.int32,
                      device=occ_idx.device)
    build.launch(build.library().treee_nearest_slot, "nearest_slot", occ_idx,
                 occ_idx.data_ptr(), occ_valid.data_ptr(),
                 tracked_pos_b.data_ptr(), active_b.data_ptr(), lo.data_ptr(),
                 s.data_ptr(), out.data_ptr(), occ_idx.shape[0], n_bands,
                 tracked_pos_b.shape[1], g)
    nearest_slot.launches += 1
    return out


nearest_slot.launches = 0
