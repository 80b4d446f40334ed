"""The viewer's frame, written from the renderer's published semantics
(``render/src/*.wgsl`` of the upstream, as the TPU system states them) in
PyTorch, on the device the points are on.  Every f32 division is of two
tensors (correctly rounded on any device).

1. Each drawn point (valid, segment not 0) is moved into the camera's frame
   (the inverse of its rigid camera-to-world transform) and projected with
   a right-handed perspective (NDC z in [0, 1]); it is drawn where its
   centre pixel lies on the screen and its depth between near and far.
2. Its colour is its segment's: a Fibonacci hash of the id picks one of
   the 256 entries of the Turbo palette.  A z-buffer keeps, per pixel, the
   least key (depth on 23 bits, then the colour index).
3. Splats grow in ``max_splat_radius`` passes over the eight neighbour
   directions, in a fixed order: a pixel takes a neighbour's key where it
   is smaller and the pixel lies within that splat's circle (its radius in
   pixels from its depth, at least 0.71), measured from the splat's own
   pixel.
4. Pixels without a key take the background; eye-dome lighting darkens
   each covered pixel by how far its linearised depth lies in front of its
   four neighbours' largest; the image is rounded to u8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F = np.float32
IBIG = 0x7FFFFFFF
DEPTH_BITS = 23
ZSCALE = F(1.0 / ((1 << DEPTH_BITS) - 1))
# the neighbour directions (dy, dx) of one pass, in their order
DIRECTIONS = ((-1, 0), (1, 0), (0, -1), (0, 1),
              (-1, -1), (-1, 1), (1, -1), (1, 1))
# Turbo: Google's polynomial approximation (2019), lowest power first
TURBO = np.array([
    [0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396,
     59.28637943],
    [0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857,
     2.82956604],
    [0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912,
     27.34824973]])


def turbo(size: int = 256) -> np.ndarray:
    """f32[size,3] Turbo colours at evenly spaced points of [0, 1]."""
    x = np.linspace(0.0, 1.0, size)
    rgb = np.zeros((size, 3))
    for c in TURBO.T[::-1]:             # Horner, highest power first
        rgb = rgb * x[:, None] + c[None, :]
    return np.clip(rgb, 0.0, 1.0).astype(F)


def colour_index(seg: torch.Tensor) -> torch.Tensor:
    """The palette entry of each segment id: the top 8 bits of the id's
    32-bit Fibonacci hash."""
    return ((seg.long() * 2654435761) & 0xFFFFFFFF) >> 24


def projection(cfg: dict):
    """(f / aspect, f, far / (near - far), near far / (near - far)) as f32."""
    f = 1.0 / math.tan(cfg["fov_y"] / 2.0)
    n, fr = cfg["near"], cfg["far"]
    return (F(f / (cfg["width"] / cfg["height"])), F(f), F(fr / (n - fr)),
            F(n * fr / (n - fr)))


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as an f32 0-d tensor on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def z_buffer(pos: torch.Tensor, drawn: torch.Tensor, seg: torch.Tensor,
             transform: np.ndarray, cfg: dict) -> torch.Tensor:
    """Steps 1-2: the key image i64[H,W], ``IBIG`` where nothing is drawn."""
    w, h = cfg["width"], cfg["height"]
    t = np.asarray(transform, np.float64)
    rot = t[:3, :3].T
    view = np.concatenate([rot, -(rot @ t[:3, 3])[:, None]], 1).astype(F)
    view = torch.from_numpy(view).to(pos.device)
    p = pos[drawn]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]

    def row(i):
        return ((x * view[i, 0] + y * view[i, 1]) + z * view[i, 2]) + view[i, 3]

    vx, vy, vz = row(0), row(1), row(2)
    depth = -vz
    p00, p11, p22, p23 = (_c(v, x) for v in projection(cfg))
    wc = torch.clamp(depth, min=F(1e-6))
    half = _c(0.5, x)
    fx = ((p00 * vx) / wc * half + half) * _c(w, x)
    fy = (_c(1.0, x) - ((p11 * vy) / wc * half + half)) * _c(h, x)
    z01 = (p22 * vz + p23) / wc
    ix = torch.floor(fx.clamp(-1, w)).long()
    iy = torch.floor(fy.clamp(-1, h)).long()
    on = ((depth > _c(cfg["near"], x)) & (depth < _c(cfg["far"], x))
          & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h))
    zq = torch.clamp((z01.clamp(0, 1) * _c((1 << DEPTH_BITS) - 1, x))
                     .long(), max=(1 << DEPTH_BITS) - 2)
    key = (zq << 8) | colour_index(seg[drawn])
    img = torch.full((h * w,), IBIG, dtype=torch.int64, device=pos.device)
    img.scatter_reduce_(0, (iy * w + ix)[on], key[on], "amin")
    return img.view(h, w)


def splat_radius(key: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The pixel radius of the splat with this key: view depth from the key's
    NDC depth, point_size projected to pixels, at least 0.71."""
    _, p11, p22, p23 = projection(cfg)
    coef = F(F(F(cfg["point_size"]) * p11) * F(cfg["height"] / 2.0))
    z01 = (key >> 8).float() * _c(ZSCALE, key)
    d = _c(p23, key) / torch.clamp(z01 + _c(p22, key), max=F(-1e-9))
    return torch.clamp(_c(coef, key) / torch.clamp(d, min=F(1e-6)),
                       min=F(0.71))


def grow(img: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Step 3 on the key image."""
    h, w = img.shape
    k = img.clone()
    rd = torch.where(k != IBIG, splat_radius(k, cfg), 0.0)
    sdx = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    sdy = torch.zeros_like(sdx)
    for _ in range(cfg["max_splat_radius"]):
        for dy, dx in DIRECTIONS:
            # the pixels whose source neighbour (y - dy, x - dx) is inside
            ty = slice(max(dy, 0), h + min(dy, 0))
            tx = slice(max(dx, 0), w + min(dx, 0))
            sy = slice(max(-dy, 0), h + min(-dy, 0))
            sx = slice(max(-dx, 0), w + min(-dx, 0))
            ck, crd = k[sy, sx].clone(), rd[sy, sx].clone()
            cdx, cdy = sdx[sy, sx] + float(dx), sdy[sy, sx] + float(dy)
            take = ((ck != IBIG) & (ck < k[ty, tx])
                    & (cdx * cdx + cdy * cdy <= crd * crd))
            for a, b in ((k, ck), (rd, crd), (sdx, cdx), (sdy, cdy)):
                a[ty, tx] = torch.where(take, b, a[ty, tx])
    return k


def shade(k: torch.Tensor, cfg: dict) -> np.ndarray:
    """Step 4: u8[H,W,3] on the host."""
    hit = k != IBIG
    pal = torch.from_numpy(turbo()).to(k.device)
    bg = torch.tensor(cfg["background"], dtype=torch.float32,
                      device=k.device)
    colour = torch.where(hit[..., None], pal[k & 255], bg)
    z01 = torch.where(hit, (k >> 8).float() * _c(ZSCALE, k), 1.0)
    n, fr = cfg["near"], cfg["far"]
    n2, fpn, fmn = _c(2.0 * n, z01), _c(fr + n, z01), _c(fr - n, z01)
    s = _c(max(1.0 - cfg["eye_dome_strength"], 0.1) ** 6, z01)
    lin = torch.where(z01 >= 1, 1.0, n2 / (fpn - z01 * fmn))
    e = torch.nn.functional.pad(lin[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    m = torch.maximum(torch.maximum(e[:-2, 1:-1], e[2:, 1:-1]),
                      torch.maximum(e[1:-1, :-2], e[1:-1, 2:]))
    m = torch.minimum(torch.maximum(m, lin), lin + s)
    alpha = torch.where(z01 < 1, (m - lin) / s, 0.0)[..., None]
    ed = torch.tensor(cfg["eye_dome_color"], dtype=torch.float32,
                      device=k.device)
    out = colour * (1.0 - alpha) + ed * alpha
    return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu(
        ).numpy()


def frame(pos: torch.Tensor, valid: torch.Tensor, seg: torch.Tensor,
          transform: np.ndarray, cfg: dict) -> np.ndarray:
    """The frame u8[H,W,3] of the points with these ids from the camera
    ``transform`` (camera-to-world, -z forward)."""
    drawn = valid & (seg != 0)
    return shade(grow(z_buffer(pos, drawn, seg, transform, cfg), cfg), cfg)
