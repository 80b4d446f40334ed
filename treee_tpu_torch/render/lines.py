"""Line overlays: hull wireframes, RBV cages, trunk axes; the port of
``treee_tpu/render/lines.py``.

Each segment is sampled densely, the samples are projected with the splat
pass's camera, depth-tested against its z-buffer with a small bias (so lines
win ties against their own surface), and the hit pixels are painted.  The
sample parameters and the line colour are made on the frame's device, so
a call copies nothing from the host but endpoints given as host arrays.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..ops.f32 import full
from .camera import Camera
from .splat import _pixel, _project, f32


def sample_lines(endpoints: torch.Tensor, samples: int = 32) -> torch.Tensor:
    """f32[L,2,3] segment endpoints -> f32[L*samples,3] sample points.

    The sample parameters are XLA's ``linspace(0, 1, samples)`` in f32:
    i * f32(1/(samples-1)), the last one exactly 1.
    """
    t = torch.arange(samples, dtype=torch.float32, device=endpoints.device)
    if samples > 1:
        t = t * full(f32(1.0 / (samples - 1)), t)
        t[-1].fill_(1.0)
    t = t[None, :, None]
    a = endpoints[:, 0:1, :]
    b = endpoints[:, 1:2, :]
    return (a + (b - a) * t).reshape(-1, 3)


def overlay(
    color: torch.Tensor,       # f32[H,W,3] splat-pass output
    z01: torch.Tensor,         # f32[H,W] splat-pass depth
    endpoints: torch.Tensor,   # f32[L,2,3]
    cam: Camera,
    cfg: RenderConfig = RenderConfig(),
    line_color: tuple[float, float, float] = (0.0, 0.0, 0.0),
    samples: int = 32,
    depth_bias: float = 2e-4,
) -> torch.Tensor:
    """Paint depth-tested line samples over a rendered frame."""
    w, h = cfg.width, cfg.height
    pts = sample_lines(endpoints, samples)
    fx, fy, depth, z01_s, _ = _project(pts, cam, w, h)
    ix = _pixel(fx, w)
    iy = _pixel(fy, h)
    ok = ((depth > f32(cfg.near)) & (depth < f32(cfg.far))
          & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h))
    pix = torch.where(ok, iy * w + ix, w * h)
    ref = z01.reshape(-1)[torch.clamp(pix, 0, w * h - 1).long()]
    visible = ok & (z01_s <= ref + f32(depth_bias))
    tgt = torch.where(visible, pix, w * h).long()
    painted = torch.zeros(w * h + 1, dtype=torch.bool, device=color.device)
    painted.index_fill_(0, tgt, True)
    painted = painted[: w * h].view(h, w)
    lc = torch.stack([full(c, color) for c in line_color])
    return torch.where(painted[..., None], lc, color)
