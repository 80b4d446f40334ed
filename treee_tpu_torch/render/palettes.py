"""Property-colour lookup palettes, the port of ``treee_tpu/render/palettes.py``.

Each palette is built in numpy, exactly as the JAX package builds it, and
returned as an f32[P,3] tensor on the device asked for.  Turbo uses Google's
published polynomial approximation (Apache-2.0 formula); warm is a dark-red
-> orange -> light-yellow ramp; white is constant.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE

PALETTE_SIZE = 256

# Turbo colormap polynomial coefficients (Google AI blog, 2019).
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973])


def _poly(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    return sum(ci * x**i for i, ci in enumerate(c))


@functools.lru_cache(maxsize=None)
def _turbo(size: int) -> np.ndarray:
    x = np.linspace(0.0, 1.0, size)
    rgb = np.stack([_poly(_TURBO_R, x), _poly(_TURBO_G, x), _poly(_TURBO_B, x)], -1)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _warm(size: int) -> np.ndarray:
    x = np.linspace(0.0, 1.0, size)[:, None]
    dark = np.array([[0.35, 0.05, 0.05]])
    orange = np.array([[0.95, 0.55, 0.15]])
    light = np.array([[1.0, 0.97, 0.75]])
    lo = dark + (orange - dark) * np.clip(x * 2, 0, 1)
    hi = orange + (light - orange) * np.clip(x * 2 - 1, 0, 1)
    return np.where(x < 0.5, lo, hi).astype(np.float32)


def _rgb_cube() -> np.ndarray:
    idx = np.arange(256)
    r = ((idx >> 5) & 0x7) / 7.0
    g = ((idx >> 2) & 0x7) / 7.0
    b = (idx & 0x3) / 3.0
    return np.stack([r, g, b], -1).astype(np.float32)


def turbo(size: int = PALETTE_SIZE, device: str | torch.device = DEFAULT_DEVICE):
    return torch.from_numpy(_turbo(size)).to(device)


def warm(size: int = PALETTE_SIZE, device: str | torch.device = DEFAULT_DEVICE):
    return torch.from_numpy(_warm(size)).to(device)


def white(size: int = PALETTE_SIZE, device: str | torch.device = DEFAULT_DEVICE):
    return torch.ones((size, 3), dtype=torch.float32, device=device)


def rgb_cube(device: str | torch.device = DEFAULT_DEVICE):
    """256-entry 3-3-2 true-colour cube for source-RGB display: index
    (r3 << 5) | (g3 << 2) | b2, channels quantized to 8/8/4 levels."""
    return torch.from_numpy(_rgb_cube()).to(device)


def get(name: str, size: int = PALETTE_SIZE,
        device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    try:
        fn = {"turbo": turbo, "warm": warm, "white": white}[name]
    except KeyError:
        raise ValueError(f"unknown palette {name!r}; pick turbo/warm/white") from None
    return fn(size, device)


def sample(palette: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Palette lookup for normalized t in [0,1] (point_cloud.wgsl:78-79)."""
    n = palette.shape[0]
    idx = torch.clamp((t * n).to(torch.int32), 0, n - 1)
    return palette[idx.long()]
