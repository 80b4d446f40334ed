"""Segments against trees on ``bench_tiled``'s synthetic survey.

``synthetic_forest`` writes tree t as rows [t * per_tree, (t + 1) *
per_tree), so a tiled run's ids can be held against the trees themselves:

- :func:`tree_majority`: each tree's majority id and the share of its
  points that carry it; a tree *owns* its id when no other tree's majority
  is the same id;
- :func:`edge_agreement`: of the trees that an x edge cuts, how often a
  point on one side and a point on the other carry the same id.  At the
  tiles' core edges the two sides take their ids from two tiles, so this
  reads the halo reconcile (a reconcile that joins nothing gives 0); at the
  middle of each core it reads the segmentation alone.

Run on the survey's geometry (6,250 trees 7 m apart) at a chosen density,
and optionally with a segmentation setting changed, it prints one JSON
line::

    python -m treee_tpu_torch.tools.survey_trees [--cpu] [--per-tree 600]
        [--trees 6250] [--tiles 4] [--max-trees-per-band C] [--grid-size G]

The ground keeps the survey's share (4,000 points a tree).  Without
``--cpu`` it needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..io import las
from ..parallel import tiles

# bench_tiled's survey: 75% of the points in trees of 12,000 points
GROUND_PER_TREE = 4_000


def tree_majority(seg: np.ndarray, n_trees: int, per_tree: int):
    """Each tree's majority id (ties to the lowest) and that share of its
    points, as two [n_trees] arrays."""
    ids = np.sort(seg[:n_trees * per_tree].reshape(n_trees, per_tree), axis=1)
    start = np.ones(ids.shape, bool)
    start[:, 1:] = ids[:, 1:] != ids[:, :-1]
    first = np.flatnonzero(start.ravel())
    length = np.diff(np.append(first, ids.size))
    tree = first // per_tree
    best = np.lexsort((-length, tree))      # by tree, then longest run
    head = np.concatenate([[True], tree[best][1:] != tree[best][:-1]])
    return ids.ravel()[first[best][head]], length[best][head] / per_tree


def owned(majority: np.ndarray) -> int:
    """How many trees hold a majority id that no other tree holds."""
    _, count = np.unique(majority, return_counts=True)
    return int((count == 1).sum())


def edge_agreement(pts: np.ndarray, seg: np.ndarray, n_trees: int,
                   per_tree: int, edges) -> tuple[float, int]:
    """Of the trees that an x edge cuts with at least a tenth of their
    points on each side, the mean chance that a point left of the edge and
    one right of it carry the same id, and how many such trees there are.
    """
    xs = pts[:n_trees * per_tree, 0].reshape(n_trees, per_tree)
    ids = seg[:n_trees * per_tree].reshape(n_trees, per_tree)
    same, total = 0.0, 0
    for e in edges:
        left = xs < e
        n_left = left.sum(axis=1)
        cut = np.flatnonzero((n_left >= per_tree // 10)
                             & (per_tree - n_left >= per_tree // 10))
        for t in cut:
            m = int(ids[t].max()) + 1
            fl = np.bincount(ids[t][left[t]], minlength=m) / n_left[t]
            fr = (np.bincount(ids[t][~left[t]], minlength=m)
                  / (per_tree - n_left[t]))
            same += float(fl @ fr)
        total += len(cut)
    return same / max(total, 1), total


def core_edges(pts: np.ndarray, n_tiles: int, halo: float = 12.0):
    """(the tiles' interior core edges, the middle of each core) in x, as
    ``tiled_pipeline`` plans them."""
    plan = tiles.plan_tiles(pts[:, 0], n_tiles, halo)
    return ([c1 for _, c1, _, _ in plan[:-1]],
            [(c0 + c1) / 2 for c0, c1, _, _ in plan])


def report(pts, seg, info, n_trees: int, per_tree: int) -> dict:
    """The tree measures of one tiled run, as a dict."""
    majority, share = tree_majority(seg, n_trees, per_tree)
    real, mid = core_edges(pts, info["n_tiles"], info["halo"])
    at_edges, n_edges = edge_agreement(pts, seg, n_trees, per_tree, real)
    at_mid, n_mid = edge_agreement(pts, seg, n_trees, per_tree, mid)
    return {
        "trees": n_trees,
        "n_segments": info["n_segments"],
        "n_alloc": info["n_alloc"],
        "occupied_overflow": info["occupied_overflow"],
        "labeled_frac": round(float((seg > 0).mean()), 4),
        "trees_owning_an_id": owned(majority),
        "majority_share_median": round(float(np.median(share)), 4),
        "trees_under_half": int((share < 0.5).sum()),
        "edge_agreement": round(at_edges, 4), "edge_trees": n_edges,
        "mid_agreement": round(at_mid, 4), "mid_trees": n_mid,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--per-tree", type=int, default=600)
    ap.add_argument("--trees", type=int, default=6250)
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--max-trees-per-band", type=int, default=None)
    ap.add_argument("--grid-size", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("survey_trees: torch sees no CUDA card (--cpu runs "
                         "on the CPU)")
    seg_cfg = DEFAULT_CONFIG.segmentation
    for name in ("max_trees_per_band", "grid_size"):
        if getattr(args, name) is not None:
            seg_cfg = dataclasses.replace(seg_cfg,
                                          **{name: getattr(args, name)})
    cfg = dataclasses.replace(DEFAULT_CONFIG, segmentation=seg_cfg)
    pts = las.synthetic_forest(
        n_trees=args.trees, spacing=7.0, points_per_tree=args.per_tree,
        ground_points=args.trees * GROUND_PER_TREE * args.per_tree // 12_000,
        seed=0)
    t0 = time.perf_counter()
    seg, _, _, info = tiles.tiled_pipeline(
        pts, args.tiles, seg_cfg.max_distance, cfg,
        device="cpu" if args.cpu else "cuda")
    out = {"per_tree": args.per_tree, "tiles": args.tiles,
           "max_trees_per_band": seg_cfg.max_trees_per_band,
           "grid_size": seg_cfg.grid_size,
           "seconds": round(time.perf_counter() - t0, 1)}
    out.update(report(pts, seg, info, args.trees, args.per_tree))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
