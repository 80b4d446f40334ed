"""The control of the benchmark's comparison: the plain reference put in the
port's place with its positions stored in bfloat16, the step below the f32
that the configurations state, compared with the f32 reference exactly as a
run compares the port.  The comparison has to reject it: each cell's
control reading has to pass at least one limit.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3 [--cpu]

Prints one JSON line per seed with the numbers compared and their limits.
On the card it runs at the cell's own size; ``--cpu`` runs on the CPU (the
stands at 15M points take minutes there).  The benchmark's runs never run
it.
"""

import os
import sys

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import cell, files  # noqa: E402
from harness import scene as scenes  # noqa: E402


def readings(workload: str, seed: int, device: torch.device,
             sections: dict | None = None, scene: dict | None = None,
             traffic_over: dict | None = None, root=files.ROOT) -> dict:
    """The control's compared numbers on ``seed``: the bf16 reference
    against the f32 reference on the requests a run would sample."""
    spec = files.spec(root)
    c, conf = files.workload(spec, workload)
    conf_file = json.loads((root / conf["file"]).read_text())
    sections = conf_file["config"] if sections is None else sections
    scene = conf_file["scene"] if scene is None else scene
    params = {**files.load_json("traffic", c["traffic"]),
              **(traffic_over or {})}
    kind = files.load_module("requests", params["request"])
    pts = scenes.make_points(scene, seed)
    traffic = kind.Traffic(params, seed, pts,
                           files.load_module("scenes", scene["generator"]),
                           sections)
    first = traffic.warm_ids().stop
    rng = np.random.default_rng([seed, 5])
    ids = sorted(int(i) for i in first + rng.choice(
        200, size=int(params["sample"]), replace=False))
    out = {}
    with torch.no_grad():
        for name, bf16 in (("control", True), ("reference", False)):
            api = cell.ReferenceApi(sections, device, bf16=bf16)
            out[name] = traffic.replay(api.session(pts), api, ids)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    checks = traffic.compare(out["control"], out["reference"])
    return {k: {"value": v, "limit": params["limits"][k]}
            for k, v in checks.items()}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA card (pass --cpu to run on the CPU)", file=sys.stderr)
        return 2
    device = torch.device("cpu" if a.cpu else "cuda:0")
    for seed in a.seeds:
        t = time.perf_counter()
        got = readings(a.workload, seed, device)
        rejected = any(v["value"] > v["limit"] for v in got.values())
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "rejected": rejected, "checks": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
