"""Gather from a table: the CUDA kernel ``csrc/take_along.cu`` and its
plain version.

Counterpart of the Mosaic gather probe ``tools/probe_extract.py`` (the
``pl.pallas_call`` in ``try_kernel`` with the bodies ``k_taa0``, ``k_taa1``
and ``k_take``), which asked whether a TPU kernel can gather inside its fast
memory.  No path of the port calls it; its entry point is
``python -m treee_tpu_torch.tools.probe_extract``.

Indices must lie in range.  The plain version raises on one that does not
(on the CPU); the kernel is not checked, since that would cost a
synchronisation, and gives NaN there.
"""

from __future__ import annotations

import torch

from . import build


def _check(tab: torch.Tensor, idx: torch.Tensor, axis) -> None:
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"take_along_axis: need an f32 table and i32 "
                         f"indices, got {tab.dtype} and {idx.dtype}")
    if tab.device != idx.device:
        raise ValueError("take_along_axis: table and indices on different "
                         "devices")
    if axis is None:
        if tab.dim() != 1 or not tab.numel():
            raise ValueError(f"take_along_axis: axis=None needs a non-empty "
                             f"1-D table, got {list(tab.shape)}")
        return
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0, 1 or None, got "
                         f"{axis}")
    other = 1 - axis
    if (tab.dim() != 2 or idx.dim() != 2 or not tab.numel()
            or idx.shape[other] != tab.shape[other]):
        raise ValueError(f"take_along_axis: need tab[R,L] and idx matching it "
                         f"off axis {axis}, got {list(tab.shape)} and "
                         f"{list(idx.shape)}")


def take_along_axis_plain(tab: torch.Tensor, idx: torch.Tensor,
                          axis) -> torch.Tensor:
    """``jnp.take_along_axis(tab, idx, axis)`` for axis 0 or 1 of a 2-D
    table; ``tab[idx]`` (any index shape) for a 1-D table with
    ``axis=None``."""
    _check(tab, idx, axis)
    if axis is None:
        return tab[idx.long()]
    return torch.take_along_dim(tab, idx.long(), dim=axis)


def take_along_axis(tab: torch.Tensor, idx: torch.Tensor,
                    axis) -> torch.Tensor:
    """Gather (see :func:`take_along_axis_plain`): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(tab, idx, axis)
    if not build.on_cuda(tab, "take_along_axis"):
        return take_along_axis_plain(tab, idx, axis)
    tab = tab.contiguous()
    idx = idx.contiguous()
    out = torch.empty_like(idx, dtype=torch.float32)  # idx is contiguous
    if axis is None:
        rows, cols, m, ax = 1, tab.shape[0], idx.numel(), -1
    else:
        rows, cols = tab.shape
        m, ax = idx.shape[axis], axis
    if m == 0:
        return out
    build.launch(build.library().treee_take_along, "take_along_axis", tab,
                 tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols, m,
                 ax)
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
