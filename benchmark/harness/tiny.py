"""A cell at a tiny size on the CPU, for the benchmark's tests: a stand of
a few thousand points, small static capacities and a 160x90 frame."""

from __future__ import annotations

import io
import json
import time

import torch

from . import cell, files

SEGMENTATION = {"grid_size": 32, "max_bands": 16, "max_trees_per_band": 32,
                "max_segments": 64, "cc_occupied_cap": 4096}
RENDER = {"width": 160, "height": 90}
SCENES = {
    "synthetic_forest": {"n_trees": 9, "spacing": 7.0,
                         "points_per_tree": 400, "ground_points": 1500},
    "synthetic_forest_realistic": {"n_trees": 9, "extent": 20.0,
                                   "mean_points_per_tree": 400,
                                   "ground_points": 1500},
}
# a request kind's traffic parameters at the tiny size, where they differ:
# the orbit closer in, so the 20 m stand fills the frame as 15M points do
TRAFFIC = {"render": {"distance_m": [20.0, 60.0]}}


def sizes(workload: str, root=files.ROOT) -> tuple[dict, dict, dict]:
    """(config sections, scene, traffic overrides) of ``workload`` at the
    tiny size."""
    cell_, conf = files.workload(files.spec(root), workload)
    cfg = json.loads((root / conf["file"]).read_text())
    sections = {k: dict(v) for k, v in cfg["config"].items()}
    sections["segmentation"].update(SEGMENTATION)
    sections["render"].update(RENDER)
    scene = {"generator": cfg["scene"]["generator"],
             "params": SCENES[cfg["scene"]["generator"]]}
    kind = files.load_json("traffic", cell_["traffic"])["request"]
    return sections, scene, TRAFFIC.get(kind, {})


def run(workload: str, seed: int, seconds: float = 0.5, trace: bool = False,
        root=files.ROOT):
    """Run ``workload`` at the tiny size on the CPU -> (exit code, stdout
    lines, stderr text)."""
    sections, scene, over = sizes(workload, root)
    out, err = io.StringIO(), io.StringIO()
    with torch.no_grad():
        rc = cell.run_cell(workload, seed, seconds, trace, time.perf_counter(),
                           torch.device("cpu"), root=root, sections=sections,
                           scene=scene, traffic_over=over, out=out, err=err)
    return rc, out.getvalue().splitlines(), err.getvalue()
