"""Splat dilation: the CUDA kernel ``csrc/dilate.cu`` and its plain version.

Counterpart of the XLA scan in ``treee_tpu/render/splat.py::resolve_keys``,
which is the TPU's default path, and of ``dilate_pallas``
(``treee_tpu/ops/pallas_kernels.py``).  The port follows the XLA scan: the
source offsets are carried at full width.  The Pallas kernel packs them
into 4-bit fields, which hold only |offset| <= 7, while one pass can move a
splat 3 pixels along an axis, so at radius 3 the two differ where near
points have large splats.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..f32 import full
from . import build

IBIG = 0x7FFFFFFF
# the eight neighbour directions (dy, dx) of one pass, in the scan's order
DIRECTIONS = ((-1, 0), (1, 0), (0, -1), (0, 1),
              (-1, -1), (-1, 1), (1, -1), (1, 1))
# offsets travel at most 3 px per pass and per axis, and the kernel keeps
# them in int16
MAX_RADIUS = 10_000
# packed key (23-bit depth << 8 | palette) -> z01 scale, as an f32
ZSCALE = float(np.float32(1.0 / ((1 << 23) - 1)))


def _check(kimg: torch.Tensor, radius: int) -> None:
    if kimg.dtype != torch.int32 or kimg.dim() != 2 or not kimg.numel():
        raise ValueError(f"dilate: need a non-empty i32[H,W] key image, got "
                         f"{kimg.dtype}{list(kimg.shape)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"dilate: radius must be in [1, {MAX_RADIUS}], "
                         f"got {radius}")


def radius_from_key(k: torch.Tensor, p22: float, p23: float,
                    coef: float) -> torch.Tensor:
    """Pixel radius of the splat whose packed key is ``k``: invert
    z01 = -p22 + p23/d to the view depth d, then coef / d, at least 0.71."""
    z01 = (k >> 8).float() * ZSCALE
    d = torch.div(full(p23, k), torch.clamp(z01 + p22, max=-1e-9))
    return torch.clamp(torch.div(full(coef, k), torch.clamp(d, min=1e-6)),
                       min=0.71)


def dilate_scan(kimg: torch.Tensor, radius: int, p22: float, p23: float,
                coef: float):
    """:func:`dilate_plain`, also returning each pixel's source offsets
    (sdx, sdy) as f32[H,W], zero where the pixel kept its own key."""
    _check(kimg, radius)
    h, w = kimg.shape
    dev = kimg.device
    k = kimg
    rd = torch.where(k != IBIG, radius_from_key(k, p22, p23, coef), 0.0)
    sdx = torch.zeros((h, w), dtype=torch.float32, device=dev)
    sdy = torch.zeros((h, w), dtype=torch.float32, device=dev)
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    for _ in range(radius):
        for dy, dx in DIRECTIONS:
            ck = torch.roll(k, (dy, dx), (0, 1))
            crd = torch.roll(rd, (dy, dx), (0, 1))
            cdx = torch.roll(sdx, (dy, dx), (0, 1)) + dx
            cdy = torch.roll(sdy, (dy, dx), (0, 1)) + dy
            inside = cdx * cdx + cdy * cdy <= crd * crd
            # roll wraps: reject sources from the opposite screen edge
            src_ok = ((row - dy >= 0) & (row - dy < h)
                      & (col - dx >= 0) & (col - dx < w))
            better = (ck != IBIG) & inside & (ck < k) & src_ok
            k = torch.where(better, ck, k)
            rd = torch.where(better, crd, rd)
            sdx = torch.where(better, cdx, sdx)
            sdy = torch.where(better, cdy, sdy)
    return (k.clone() if k is kimg else k), sdx, sdy


def dilate_plain(kimg: torch.Tensor, radius: int, p22: float, p23: float,
                 coef: float) -> torch.Tensor:
    """``radius`` passes of min-key growth over the 8-neighbourhood: in each
    direction, a pixel takes its neighbour's key where that key is smaller
    and the pixel lies within the key's splat circle, measured from the
    splat's source pixel.  ``p22``, ``p23`` and ``coef`` are f32 values (see
    :func:`radius_from_key`)."""
    return dilate_scan(kimg, radius, p22, p23, coef)[0]


@functools.cache
def passes_per_launch() -> int:
    """Passes the kernel runs in one launch."""
    return build.library().treee_dilate_passes_per_launch()


def launches_for(radius: int) -> int:
    """CUDA launches the kernel makes for ``radius`` passes."""
    return -(-radius // passes_per_launch())


def _launch(kimg: torch.Tensor, radius: int, p22: float, p23: float,
            coef: float, stats: int) -> torch.Tensor:
    """The kernel on CUDA tensor ``kimg``; ``stats`` is 0 or the address of
    a zeroed i32[4] (see :func:`tile_stats`).  Counts one launch for each
    group of passes the kernel runs."""
    kimg = kimg.contiguous()
    h, w = kimg.shape
    n = launches_for(radius)
    out = torch.empty_like(kimg)
    # keys and offsets between launches: the last launch writes keys only
    tmp = torch.empty_like(kimg) if n > 1 else None
    off = (torch.empty((min(n - 1, 2), h, w), dtype=torch.int32,
                       device=kimg.device) if n > 1 else None)
    build.launch(build.library().treee_dilate, "dilate", kimg,
                 kimg.data_ptr(), out.data_ptr(),
                 0 if tmp is None else tmp.data_ptr(),
                 0 if off is None else off[0].data_ptr(),
                 0 if off is None or n < 3 else off[1].data_ptr(), h, w,
                 radius, p22, p23, coef, ZSCALE, stats)
    dilate.launches += n
    return out


def dilate(kimg: torch.Tensor, radius: int, p22: float, p23: float,
           coef: float) -> torch.Tensor:
    """Splat dilation (see :func:`dilate_plain`): the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  Counts one launch for each
    group of passes the kernel runs."""
    _check(kimg, radius)
    if not build.on_cuda(kimg, "dilate"):
        return dilate_plain(kimg, radius, p22, p23, coef)
    return _launch(kimg, radius, p22, p23, coef, 0)


dilate.launches = 0


def tile_stats(kimg: torch.Tensor, radius: int, p22: float, p23: float,
               coef: float) -> dict[str, int]:
    """The kernel's exact shortcuts on CUDA tensor ``kimg``, summed over its
    launches: ``tiles`` run, ``empty`` (no key in the tile's span: written
    empty at once), ``stopped`` (a pass changed nothing, so the tile ended
    before its last pass) and ``passes`` run.  The launches count as
    :func:`dilate`'s."""
    _check(kimg, radius)
    if not kimg.is_cuda:
        raise ValueError("dilate.tile_stats: needs a CUDA tensor")
    stats = torch.zeros(4, dtype=torch.int32, device=kimg.device)
    _launch(kimg, radius, p22, p23, coef, stats.data_ptr())
    return dict(zip(("tiles", "empty", "stopped", "passes"),
                    stats.tolist()))
