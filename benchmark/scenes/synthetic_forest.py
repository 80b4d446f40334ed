"""The repository's bench stand: a jittered grid of trees on a noisy flat
ground, as ``treee_tpu_torch/io/las.py`` makes it (``synthetic_tree`` and
``synthetic_forest`` copied unchanged, numpy on the host)."""

from __future__ import annotations

import numpy as np


def generate(params: dict, seed: int) -> np.ndarray:
    """f32[N,3] y-up points of the stand from ``seed``."""
    return synthetic_forest(**params, seed=seed)


def ground_y(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The ground's height under (x, z): the plane y = 0."""
    return np.zeros_like(x)


def synthetic_tree(
    rng: np.random.Generator,
    base: np.ndarray,
    trunk_height: float = 4.0,
    crown_height: float = 6.0,
    crown_radius: float = 2.5,
    trunk_radius: float = 0.25,
    n_points: int = 20_000,
) -> np.ndarray:
    """One tree: trunk cylinder + crown ellipsoid, y-up, rooted at ``base``."""
    n_trunk = n_points // 5
    n_crown = n_points - n_trunk
    theta = rng.uniform(0, 2 * np.pi, n_trunk)
    r = trunk_radius * np.sqrt(rng.uniform(0, 1, n_trunk))
    h = rng.uniform(0, trunk_height, n_trunk)
    trunk = np.stack([r * np.cos(theta), h, r * np.sin(theta)], axis=1)

    u = rng.normal(size=(n_crown, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rad = rng.uniform(0, 1, n_crown) ** (1 / 3)
    crown = u * rad[:, None]
    crown[:, 0] *= crown_radius
    crown[:, 2] *= crown_radius
    crown[:, 1] = crown[:, 1] * (crown_height / 2) + trunk_height + crown_height / 2
    pts = np.concatenate([trunk, crown]).astype(np.float32)
    return pts + base.astype(np.float32)


def synthetic_forest(
    n_trees: int = 16,
    spacing: float = 8.0,
    points_per_tree: int = 20_000,
    ground_points: int = 40_000,
    seed: int = 0,
    jitter: float = 1.5,
) -> np.ndarray:
    """Grid of trees + noisy ground plane; y-up, centered near origin."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_trees)))
    half = (side - 1) * spacing / 2
    trees = []
    for t in range(n_trees):
        gx, gz = t % side, t // side
        base = np.array(
            [gx * spacing - half + rng.uniform(-jitter, jitter), 0.0,
             gz * spacing - half + rng.uniform(-jitter, jitter)]
        )
        trees.append(
            synthetic_tree(
                rng, base,
                trunk_height=rng.uniform(3.0, 6.0),
                crown_height=rng.uniform(4.0, 8.0),
                crown_radius=rng.uniform(1.5, 3.0),
                n_points=points_per_tree,
            )
        )
    extent = half + spacing
    ground = np.stack(
        [rng.uniform(-extent, extent, ground_points),
         rng.normal(0.0, 0.05, ground_points),
         rng.uniform(-extent, extent, ground_points)],
        axis=1,
    ).astype(np.float32)
    return np.concatenate(trees + [ground]).astype(np.float32)
