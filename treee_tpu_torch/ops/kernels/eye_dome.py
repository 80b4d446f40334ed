"""Eye-dome lighting: the CUDA kernel ``csrc/eye_dome.cu`` and its plain
version.

Counterpart of ``eye_dome_pallas`` (``treee_tpu/ops/pallas_kernels.py``) and
of the XLA path of ``treee_tpu/render/splat.py::eye_dome``.  The colour stays
in HWC layout; the Pallas kernel's [3,H,W] layout is a TPU tiling choice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build
from ..f32 import full


def _check(color: torch.Tensor, z01: torch.Tensor) -> None:
    if z01.dtype != torch.float32 or z01.dim() != 2 or not z01.numel():
        raise ValueError(f"eye_dome: need a non-empty f32[H,W] depth, got "
                         f"{z01.dtype}{list(z01.shape)}")
    if color.dtype != torch.float32 or color.shape != (*z01.shape, 3):
        raise ValueError(f"eye_dome: need f32[H,W,3] colour for depth "
                         f"{list(z01.shape)}, got {color.dtype}"
                         f"{list(color.shape)}")
    if color.device != z01.device:
        raise ValueError("eye_dome: colour and depth on different devices")


def _constants(near: float, far: float, strength: float):
    """(2n, f+n, f-n, strength) as the f32 values XLA uses: each computed in
    double from the Python floats, then rounded to f32 once."""
    return tuple(float(np.float32(v)) for v in
                 (2.0 * near, far + near, far - near, strength))


@functools.lru_cache(maxsize=64)
def _launch_constants(near: float, far: float, strength: float,
                      ed_color: tuple[float, float, float]):
    """The kernel's seven f32 constants: :func:`_constants`, then
    ``ed_color``.  Every frame of a session asks for the same seven, and
    converting them costs a frame's launch as much host time again."""
    return _constants(near, far, strength) + tuple(
        float(np.float32(c)) for c in ed_color)


def eye_dome_plain(color: torch.Tensor, z01: torch.Tensor, near: float,
                   far: float, strength: float,
                   ed_color: tuple[float, float, float]) -> torch.Tensor:
    """Linearize depth, take the max over the 4-neighbourhood (edge-clamped),
    clamp it to ``lin + strength`` and blend ``ed_color`` over ``color``
    with alpha = (max - lin) / strength on covered pixels (z01 < 1)."""
    _check(color, z01)
    n2, fpn, fmn, s = _constants(near, far, strength)
    lin = torch.where(z01 >= 1.0, 1.0,
                      torch.div(full(n2, z01), fpn - z01 * fmn))
    up = torch.cat([lin[:1], lin[:-1]], 0)
    down = torch.cat([lin[1:], lin[-1:]], 0)
    left = torch.cat([lin[:, :1], lin[:, :-1]], 1)
    right = torch.cat([lin[:, 1:], lin[:, -1:]], 1)
    m = torch.maximum(torch.maximum(up, down), torch.maximum(left, right))
    m = torch.maximum(m, lin)
    m = torch.minimum(m, lin + s)
    alpha = torch.where(z01 < 1.0, torch.div(m - lin, full(s, z01)), 0.0)
    alpha = alpha[..., None]
    ed = torch.tensor(ed_color, dtype=torch.float32, device=color.device)
    return color * (1.0 - alpha) + ed * alpha


def eye_dome(color: torch.Tensor, z01: torch.Tensor, near: float, far: float,
             strength: float,
             ed_color: tuple[float, float, float]) -> torch.Tensor:
    """Eye-dome lighting (see :func:`eye_dome_plain`): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(color, z01)
    if not build.on_cuda(z01, "eye_dome"):
        return eye_dome_plain(color, z01, near, far, strength, ed_color)
    # the kernel moves colour and depth 16 bytes an access
    color = build.aligned(color)
    z01 = build.aligned(z01)
    h, w = z01.shape
    out = torch.empty_like(color)
    build.launch(build.library().treee_eye_dome, "eye_dome", z01,
                 color.data_ptr(), z01.data_ptr(), out.data_ptr(), h, w,
                 *_launch_constants(near, far, strength, tuple(ed_color)))
    eye_dome.launches += 1
    return out


eye_dome.launches = 0
