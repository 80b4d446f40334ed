"""The repository's stand-in for an ALS tile: clustered stems, touching
crowns, log-normal tree sizes and densities, a flight strip of doubled
density, 0.2% outliers up to 60 m and sloped ground, as
``treee_tpu_torch/io/las.py`` makes it (``synthetic_forest_realistic``
copied unchanged, numpy on the host; ``synthetic_tree`` from the grid
stand's file)."""

from __future__ import annotations

import numpy as np

from harness.files import load_module

synthetic_tree = load_module("scenes", "synthetic_forest").synthetic_tree


def generate(params: dict, seed: int) -> np.ndarray:
    """f32[N,3] y-up points of the stand from ``seed``."""
    return synthetic_forest_realistic(**params, seed=seed)


def ground_y(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The ground's height under (x, z), as the generator draws it."""
    return 2.0 * np.sin(x * 0.06) * np.cos(z * 0.05) + 0.04 * x


def synthetic_forest_realistic(
    n_trees: int = 24,
    extent: float = 60.0,
    mean_points_per_tree: int = 9_000,
    ground_points: int = 60_000,
    seed: int = 0,
) -> np.ndarray:
    """Stress scene standing in for a real ALS tile (the PANGAEA example the
    reference fetches online, empty.rs:59-122, is unreachable offline):

    - CLUSTERED tree positions (parent-child Thomas process) so crowns
      overlap and inter-tree gaps vary, unlike the jittered grid of
      :func:`synthetic_forest`;
    - log-normal size and point-density variation per tree (big dominant
      trees next to sparse understory), crown ellipsoids squashed at random;
    - flight-strip density banding (scan overlap doubles density in a strip
      across the tile) plus 0.2% outlier noise points (birds/atmosphere);
    - undulating ground with slope.

    Segmentation on this scene exercises touching crowns, density cliffs and
    off-terrain noise; tests assert behavior by invariant (SURVEY.md §4.3).
    """
    rng = np.random.default_rng(seed)
    # Thomas cluster process for stem positions, with self-thinning: real
    # stands keep stems a few meters apart (competition), so reject draws
    # closer than ~3 m to an accepted stem — crowns still overlap heavily
    n_parents = max(2, n_trees // 4)
    parents = rng.uniform(-extent / 2, extent / 2, (n_parents, 2))
    min_stem_dist = 3.0
    stems = []
    attempts = 0
    while len(stems) < n_trees and attempts < n_trees * 60:
        attempts += 1
        p = parents[rng.integers(0, n_parents)]
        cand = p + rng.normal(0.0, extent / 10.0, 2)
        if stems and (np.linalg.norm(np.asarray(stems) - cand, axis=1).min()
                      < min_stem_dist):
            continue
        stems.append(cand)
    stems = np.asarray(stems)

    def ground_y(x, z):
        return (2.0 * np.sin(x * 0.06) * np.cos(z * 0.05)
                + 0.04 * x)  # undulation + slope

    chunks = []
    for t, (sx, sz) in enumerate(stems):
        size = float(np.exp(rng.normal(0.0, 0.35)))
        n_pts = max(400, int(mean_points_per_tree
                             * np.exp(rng.normal(0.0, 0.6))))
        base = np.array([sx, ground_y(sx, sz), sz])
        tree = synthetic_tree(
            rng, base,
            trunk_height=rng.uniform(3.0, 7.0) * size,
            crown_height=rng.uniform(4.0, 9.0) * size,
            crown_radius=rng.uniform(1.8, 4.0) * size,
            trunk_radius=0.2 * size,
            n_points=n_pts,
        )
        # squash the crown ellipsoid at a random azimuth
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        sq = rng.uniform(0.6, 1.0)
        dx, dz = tree[:, 0] - sx, tree[:, 2] - sz
        u, v = c * dx + s * dz, -s * dx + c * dz
        u *= sq
        tree[:, 0] = sx + c * u - s * v
        tree[:, 2] = sz + s * u + c * v
        chunks.append(tree)

    gx = rng.uniform(-extent / 2, extent / 2, ground_points)
    gz = rng.uniform(-extent / 2, extent / 2, ground_points)
    gy = ground_y(gx, gz) + rng.normal(0.0, 0.06, ground_points)
    chunks.append(np.stack([gx, gy, gz], axis=1).astype(np.float32))

    pts = np.concatenate(chunks).astype(np.float32)
    # flight-strip overlap: duplicate (with sensor jitter) points in a band
    strip = np.abs(pts[:, 0] - extent / 8) < extent / 6
    dup = pts[strip] + rng.normal(0.0, 0.02, (int(strip.sum()), 3)).astype(np.float32)
    # sparse outliers above the canopy
    n_out = max(1, len(pts) // 500)
    outliers = np.stack([
        rng.uniform(-extent / 2, extent / 2, n_out),
        rng.uniform(15.0, 60.0, n_out),
        rng.uniform(-extent / 2, extent / 2, n_out),
    ], axis=1).astype(np.float32)
    return np.concatenate([pts, dup, outliers]).astype(np.float32)
