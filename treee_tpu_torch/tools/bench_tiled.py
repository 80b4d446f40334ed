"""A 100M-point survey on one card through halo tiles (BASELINE.md config
5); the port's counterpart of ``tools/bench_tiled.py``.

Makes the wide synthetic survey on the host (``synthetic_forest``: trees
of 12,000 points 7 m apart, the rest ground, seed 0), runs
``parallel.tiles.tiled_pipeline`` over it with ``Config()`` and prints one
JSON line with the JAX tool's keys; ``"device"`` names the card.

    python -m treee_tpu_torch.tools.bench_tiled [--cpu]

Environment: ``TILED_POINTS`` (default 100,000,000), ``TILED_TILES``
(default 4), ``TILED_CHM`` (set: also ``tiled_rasters`` over the survey, at
``TILED_CHM_CELL`` metres, default 1.0), ``TILED_CACHE`` (a ``.npy`` path
that keeps the generated survey between runs).  ``--cpu`` runs on the CPU
(use a small ``TILED_POINTS``); otherwise it needs a CUDA card and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..io import las
from ..parallel import tiles
from ..rasters import NODATA

POINTS_PER_TREE = 12_000


def survey(n_target: int, cache: str = "") -> tuple[np.ndarray, float]:
    """(f32[N,3] points, seconds to make or load them): the tree grid
    stretched so that the tiles cut real canopy."""
    t0 = time.perf_counter()
    if cache and os.path.exists(cache):
        pts = np.load(cache)
        if len(pts) < n_target * 0.99:
            raise ValueError(f"{cache} holds {len(pts)} points, not "
                             f"~{n_target}")
    else:
        n_trees = max(1, int(n_target * 0.75) // POINTS_PER_TREE)
        pts = las.synthetic_forest(
            n_trees=n_trees, spacing=7.0, points_per_tree=POINTS_PER_TREE,
            ground_points=n_target - n_trees * POINTS_PER_TREE, seed=0)
        if cache:
            np.save(cache, pts)
    return pts, time.perf_counter() - t0


def measure(pts: np.ndarray, n_tiles: int, device, gen_s: float,
            chm_cell=None, progress=None):
    """The tiled run over ``pts`` on ``device``: (JSON record, segment ids,
    classes, info); ``gen_s`` is the survey's :func:`survey` time."""
    cfg = DEFAULT_CONFIG
    n = len(pts)
    t0 = time.perf_counter()
    seg, cls, _, info = tiles.tiled_pipeline(
        pts, n_tiles=n_tiles, max_distance=cfg.segmentation.max_distance,
        cfg=cfg, progress=progress, device=device)
    wall = time.perf_counter() - t0
    tt = info["tile_times"]
    # tiles 1+ are the steady state every further tile of a longer survey
    # sees (tile 0 also loads the kernel library)
    steady_s = sum(s + r for s, r in tt[1:]) if len(tt) > 1 else None
    steady = (round(n / n_tiles * (n_tiles - 1) / steady_s / 1e6, 3)
              if steady_s else None)
    chm_s = chm_cells = None
    if chm_cell is not None:
        t0 = time.perf_counter()
        grids, _, _ = tiles.tiled_rasters(pts, cls, cell=chm_cell,
                                          device=device)
        chm_s = round(time.perf_counter() - t0, 1)
        chm_cells = int((grids["chm"] != NODATA).sum())
    record = {
        "metric": "tiled survey Mpts/s (one card, halo tiles + reconcile)",
        "value": round(n / wall / 1e6, 3),
        "unit": "Mpts/s",
        "points": n,
        "tiles": n_tiles,
        "tile_capacity": info["capacity"],
        "wall_s": round(wall, 2),
        "gen_s": round(gen_s, 1),
        "sort_s": round(info["sort_s"], 1),
        "tile_slice_s": [round(s, 1) for s, _ in tt],
        "tile_run_s": [round(r, 1) for _, r in tt],
        "steady_mpts_s": steady,
        "n_segments": info["n_segments"],
        "labeled_frac": round(float((seg > 0).mean()), 4),
        "chm_s": chm_s,
        "chm_live_cells": chm_cells,
        "device": (torch.cuda.get_device_name(torch.device(device))
                   if torch.device(device).type == "cuda" else "cpu"),
    }
    return record, seg, cls, info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("bench_tiled: torch sees no CUDA card (--cpu runs "
                         "on the CPU)")
    n_target = int(os.environ.get("TILED_POINTS", 100_000_000))
    n_tiles = int(os.environ.get("TILED_TILES", 4))
    chm_cell = (float(os.environ.get("TILED_CHM_CELL", "1.0"))
                if os.environ.get("TILED_CHM") else None)
    pts, gen_s = survey(n_target, os.environ.get("TILED_CACHE", ""))
    print(f"# tiled: generated {len(pts):,} pts in {gen_s:.0f}s, {n_tiles} "
          "tiles", file=sys.stderr, flush=True)

    def prog(t, total):
        print(f"# tiled: tile {t + 1}/{total}", file=sys.stderr, flush=True)

    record, _, _, _ = measure(pts, n_tiles, device, gen_s, chm_cell, prog)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
