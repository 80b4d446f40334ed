"""CC label sweeps: the CUDA kernel ``csrc/cc_sweep.cu`` and its plain version.

Counterpart of ``cc_sweep_pallas`` (``treee_tpu/ops/pallas_kernels.py``).
"""

from __future__ import annotations

import torch

from . import build

IBIG = 0x7FFFFFFF


def _check(lbl: torch.Tensor, sweeps: int) -> None:
    if lbl.dtype != torch.int32 or lbl.dim() != 3 or lbl.shape[1] != lbl.shape[2]:
        raise ValueError(f"cc_sweep: need i32[B,G,G] labels, got "
                         f"{lbl.dtype}{list(lbl.shape)}")
    if sweeps < 1:
        raise ValueError(f"cc_sweep: sweeps must be >= 1, got {sweeps}")


def cc_sweep_plain(lbl: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` synchronous 3x3 min-pool sweeps per band of i32[B,G,G]
    labels.  ``IBIG`` marks empty cells, which stay empty; cells outside
    the grid count as empty."""
    _check(lbl, sweeps)
    b, g, _ = lbl.shape
    occ = lbl != IBIG
    pad = lbl.new_full((b, g + 2, g + 2), IBIG)
    x = lbl
    for _ in range(sweeps):
        pad[:, 1:-1, 1:-1] = x
        m = torch.minimum(torch.minimum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:])
        p = torch.minimum(torch.minimum(m[:, :, :-2], m[:, :, 1:-1]), m[:, :, 2:])
        x = torch.where(occ, p, IBIG)
    return x


def cc_sweep(lbl: torch.Tensor, sweeps: int) -> torch.Tensor:
    """CC sweeps (see :func:`cc_sweep_plain`): the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check(lbl, sweeps)
    if not build.on_cuda(lbl, "cc_sweep"):
        return cc_sweep_plain(lbl, sweeps)
    lbl = lbl.contiguous()
    out = torch.empty_like(lbl)
    tmp = torch.empty_like(lbl)      # used only where G > 480
    b, g, _ = lbl.shape
    build.launch(build.library().treee_cc_sweep, "cc_sweep", lbl,
                 lbl.data_ptr(), out.data_ptr(), tmp.data_ptr(), b, g, sweeps)
    cc_sweep.launches += 1
    return out


cc_sweep.launches = 0
