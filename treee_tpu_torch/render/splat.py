"""Point-splat rasterizer + eye-dome lighting, the port of
``treee_tpu/render/splat.py``.

The same scatter-based design: project every point, z-test by one i32
scatter-min of a packed (23-bit depth << 8 | 8-bit palette) key into a flat
key image, grow the splats in image space by ``max_splat_radius`` dilation
passes with the winner's circle test (CUDA kernel ``dilate``), shade through
the palette, then eye-dome lighting (CUDA kernel ``eye_dome``).

Every constant that JAX uses as an f32 is rounded to f32 here once, on the
host, so each elementwise op sees the same operands as XLA's.  The
projection is written out as f32 multiplies and adds, never as a matrix
multiply, so no device setting (TF32 on a CUDA card) lowers its precision;
the JAX package runs it at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import kernels
from ..ops.kernels.dilate import ZSCALE
from ..utils.profiling import span, waited
from .camera import Camera

IBIG = 0x7FFFFFFF
DEPTH_BITS = 23


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return float(np.float32(x))


def prop_from_segment(segment: torch.Tensor) -> torch.Tensor:
    """Hash segment ids into well-spread [0,1) palette coordinates.

    A Fibonacci hash in u32 arithmetic, which torch lacks: the product is
    taken in int64 and masked to 32 bits.
    """
    h = ((segment.long() * 2654435761) & 0xFFFFFFFF) >> 8
    return h.float() / float(1 << 24)


def _project(pos: torch.Tensor, cam: Camera, width: int, height: int):
    """Project to (pixel_x, pixel_y, view_depth, z01, proj[1,1])."""
    view = cam.view_matrix().to(pos.device)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]

    def row(i):
        return ((x * view[i, 0] + y * view[i, 1]) + z * view[i, 2]) + view[i, 3]

    vx, vy, vz = row(0), row(1), row(2)
    depth = -vz
    p = cam.projection_entries(width / height)
    w = torch.clamp(depth, min=1e-6)
    ndc_x = float(p[0, 0]) * vx / w
    ndc_y = float(p[1, 1]) * vy / w
    z01 = (float(p[2, 2]) * vz + float(p[2, 3])) / w
    fx = (ndc_x * 0.5 + 0.5) * width
    fy = (1.0 - (ndc_y * 0.5 + 0.5)) * height
    return fx, fy, depth, z01, p[1, 1]


def _pixel(f: torch.Tensor, size: int) -> torch.Tensor:
    """floor(f) as i32; values beyond the image clamp to -1 or ``size``, so
    the conversion is defined and the bounds tests see the same answer."""
    return torch.floor(f).clamp(-1, size).to(torch.int32)


def rasterize_keys(pos: torch.Tensor, prop: torch.Tensor, mask: torch.Tensor,
                   cam: Camera, cfg: RenderConfig = RenderConfig()
                   ) -> torch.Tensor:
    """Splat visibility pass -> packed key image i32[H,W].

    The key packs (quantized depth << 8 | palette index), so one scatter-min
    is the z-test and the colour pick; min is order-free, so the result does
    not depend on the order of the atomics.  A point renders only if its
    centre pixel is on screen.
    """
    with span("render.splat", pos.device):
        w, h = cfg.width, cfg.height
        fx, fy, depth, z01, _ = _project(pos, cam, w, h)
        pmin = f32(cfg.prop_min / float(0xFFFFFFFF))
        pmax = f32(cfg.prop_max / float(0xFFFFFFFF))
        vis = (mask & (depth > f32(cfg.near)) & (depth < f32(cfg.far))
               & (prop >= pmin) & (prop <= pmax))
        ix0 = _pixel(fx, w)
        iy0 = _pixel(fy, h)
        n_pix = w * h
        # clamp to 2^23 - 2: zq = 2^23 - 1 with palette 255 would pack to
        # IBIG
        zq = torch.clamp(
            (torch.clamp(z01, 0.0, 1.0) * ((1 << DEPTH_BITS) - 1))
            .to(torch.int32), max=(1 << DEPTH_BITS) - 2)
        pal8 = torch.clamp(prop * 256.0, 0.0, 255.0).to(torch.int32)
        key = (zq << 8) | pal8
        on = vis & (ix0 >= 0) & (ix0 < w) & (iy0 >= 0) & (iy0 < h)
        pix = torch.where(on, iy0 * w + ix0, n_pix)
        buf = torch.full((n_pix + 1,), IBIG, dtype=torch.int32,
                         device=pos.device)
        buf.scatter_reduce_(0, pix.long(), torch.where(vis, key, IBIG),
                            "amin")
        return buf[:n_pix].view(h, w)


def dilate_params(cam: Camera, cfg: RenderConfig):
    """(p22, p23, coef) of the splat dilation, each the f32 that XLA uses:
    the projection's z entries and point_size * proj[1,1] * h/2."""
    p22 = f32(cfg.far / (cfg.near - cfg.far))
    p23 = f32(cfg.near * cfg.far / (cfg.near - cfg.far))
    f_proj = cam.projection_entries(cfg.width / cfg.height)[1, 1]
    coef = np.float32(np.float32(cfg.point_size) * f_proj) * np.float32(
        cfg.height / 2.0)
    return p22, p23, float(coef)


def unpack_z01(k: torch.Tensor) -> torch.Tensor:
    return (k >> 8).float() * ZSCALE


def resolve_keys(kimg: torch.Tensor, cam: Camera, palette: torch.Tensor,
                 cfg: RenderConfig = RenderConfig()):
    """Shade a packed key image: splat dilation, palette, background.

    Returns (color f32[H,W,3], depth01 f32[H,W], hit bool[H,W]).
    """
    with span("render.shade", kimg.device):
        r = cfg.max_splat_radius
        if r > 0:
            kimg = kernels.dilate(kimg, r, *dilate_params(cam, cfg))
        hit = kimg != IBIG
        color = palette[torch.clamp(kimg & 255, 0,
                                    palette.shape[0] - 1).long()]
        waited("render.background")      # a host-to-device copy
        bg = torch.tensor(cfg.background, dtype=torch.float32,
                          device=kimg.device)
        color = torch.where(hit[..., None], color, bg)
        z01_px = torch.where(hit, unpack_z01(kimg), 1.0)
        return color, z01_px, hit


def render_points(pos: torch.Tensor, prop: torch.Tensor, mask: torch.Tensor,
                  cam: Camera, palette: torch.Tensor,
                  cfg: RenderConfig = RenderConfig()):
    """Rasterize splats; returns (color f32[H,W,3], depth01 f32[H,W],
    hit bool[H,W]).  ``prop`` is the normalized [0,1] point property."""
    return resolve_keys(rasterize_keys(pos, prop, mask, cam, cfg), cam,
                        palette, cfg)


def eye_dome(color: torch.Tensor, z01: torch.Tensor,
             cfg: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Eye-dome lighting post-process (eye_dome.wgsl:37-67 semantics):
    linearize depth, take the edge-clamped 4-neighbour max, clamp the excess
    by the strength and alpha-blend the silhouette colour."""
    s = max(1.0 - cfg.eye_dome_strength, 0.1) ** 6  # eye_dome.rs:226-229
    with span("render.shade", z01.device):
        return kernels.eye_dome(color, z01, cfg.near, cfg.far, s,
                                cfg.eye_dome_color)


def render_frame(pos: torch.Tensor, prop: torch.Tensor, mask: torch.Tensor,
                 cam: Camera, palette: torch.Tensor,
                 cfg: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Full frame: splat pass + eye-dome post-process -> f32[H,W,3]."""
    color, z01, _ = render_points(pos, prop, mask, cam, palette, cfg)
    return eye_dome(color, z01, cfg)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
