"""Running one cell: set-up, the measured window, the comparison with the
plain reference, and the result line."""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from . import files
from . import scene as scenes
from .tracing import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "treee_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not have
    loaded, compared whole (``treee_tpu_torch`` is not ``treee_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ProgramApi:
    """The port as the traffic drives it: its ``Session`` and ``Camera``."""

    def __init__(self, sections: dict, device: torch.device):
        from treee_tpu_torch import config as cfg_module
        from treee_tpu_torch import pipeline
        from treee_tpu_torch.render.camera import Camera
        self.config = scenes.config_from(cfg_module, sections)
        self.device = device
        self._session, self._camera = pipeline.Session, Camera

    def session(self, pts: np.ndarray):
        return self._session.from_points(pts, self.config, device=self.device)

    def camera(self, transform: np.ndarray, offset: float):
        r = self.config.render
        return self._camera.from_numpy(transform, offset, fov_y=r.fov_y,
                                       near=r.near, far=r.far,
                                       device=self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()


class ReferenceApi:
    """The plain reference (``benchmark/reference``) in the port's place;
    with ``bf16`` the control."""

    def __init__(self, sections: dict, device: torch.device,
                 bf16: bool = False):
        from reference.session import RefSession
        self.sections = sections
        self.device = device
        self.bf16 = bf16
        self._ref = RefSession

    def session(self, pts: np.ndarray):
        return self._ref(pts, self.sections, self.device, bf16=self.bf16)

    def camera(self, transform: np.ndarray, offset: float) -> np.ndarray:
        return transform


class Reservoir:
    """A uniform sample of ``k`` of the window's requests, from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 4])
        self.n = 0
        self.items: list[tuple[int, object]] = []

    def offer(self, i: int, out) -> None:
        if self.n < self.k:
            self.items.append((i, out))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = (i, out)
        self.n += 1


def card(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def reported(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics of ``BENCHMARK.json`` that this run reports."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if files.applies(m, cell)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device: torch.device, root: Path = files.ROOT,
             sections: dict | None = None, scene: dict | None = None,
             traffic_over: dict | None = None, out=sys.stdout,
             err=sys.stderr) -> int:
    """Run one cell and print its result line; returns the exit code.

    ``sections`` and ``scene`` replace the configuration file's, and
    ``traffic_over`` entries of the traffic file's (the CPU tests run a
    cell at a tiny size this way)."""
    spec = files.spec(root)
    cell, conf = files.workload(spec, workload)
    conf_file = json.loads((root / conf["file"]).read_text())
    sections = conf_file["config"] if sections is None else sections
    scene = conf_file["scene"] if scene is None else scene
    params = {**files.load_json("traffic", cell["traffic"]),
              **(traffic_over or {})}
    kind = files.load_module("requests", params["request"])
    parts = {}

    t = time.perf_counter()
    from treee_tpu_torch.ops import kernels
    parts["build_s"] = 0.0
    if device.type == "cuda":
        from treee_tpu_torch.ops.kernels import build
        _, parts["build_s"] = build.build()
        build.library()
    api = ProgramApi(sections, device)
    parts["library_s"] = time.perf_counter() - t0 - parts["build_s"]

    t = time.perf_counter()
    scene_module = files.load_module("scenes", scene["generator"])
    pts = scenes.make_points(scene, seed)
    traffic = kind.Traffic(params, seed, pts, scene_module, sections)
    parts["scene_s"] = time.perf_counter() - t

    metrics = reported(spec, workload, trace)
    readers = {m["name"]: files.load_module("metrics", m["name"])
               for m in metrics}
    tracer = Tracer(trace, device)
    if trace:
        for r in readers.values():
            for s in getattr(r, "SPANS", ()):
                if (files.BENCH_DIR / "spans" / f"{s}.json").exists():
                    tracer.wrap_span(s)
            for k in getattr(r, "KERNELS", ()):
                if k not in tracer.counts:
                    tracer.wrap_kernel(kernels, k)

    t = time.perf_counter()
    sess = api.session(pts)
    api.sync()
    parts["upload_s"] = time.perf_counter() - t

    t = time.perf_counter()
    traffic.prepare(sess, api, tracer)
    api.sync()
    parts["prepare_s"] = time.perf_counter() - t
    warm = traffic.warm_ids()
    for i in warm:
        traffic.before(sess, api, tracer, i)
        tracer.request(traffic.key(i))
        traffic.request(sess, api, tracer, i)
        api.sync()
        parts.setdefault("first_request_s", time.perf_counter() - t
                         - parts["prepare_s"])
    parts["warmup_s"] = time.perf_counter() - t

    sample = Reservoir(int(params["sample"]), seed)
    lat: list[float] = []
    attempted = failed = 0
    i = warm.stop
    setup_s = time.perf_counter() - t0
    with tracer.window():
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            traffic.before(sess, api, tracer, i)
            tracer.request(traffic.key(i))
            attempted += 1
            t = time.perf_counter()
            try:
                with tracer.label("request"):
                    got = traffic.request(sess, api, tracer, i)
                lat.append(time.perf_counter() - t)
            except Exception:      # a failed request counts, the run goes on
                got = None
                failed += 1
                lat.append(math.inf)
                if failed == 1:
                    traceback.print_exc(file=err)
            if got is not None:
                sample.offer(i, got)
            i += 1
        window_s = time.perf_counter() - start
    dev = card(device)
    tracer.unwrap()
    tracer.reduce()

    got = {j: traffic.host(o) for j, o in sample.items}
    sample.items.clear()
    del sess
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_api = ReferenceApi(sections, device)
    with torch.no_grad():
        ref = traffic.replay(ref_api.session(pts), ref_api, sorted(got))
    ref_s = time.perf_counter() - t
    checks = traffic.compare(got, ref)
    limits = params["limits"]
    correct = (failed == 0 and bool(got) and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in limits))

    run = types.SimpleNamespace(
        latencies_s=lat, window_s=window_s, completed=attempted - failed,
        setup_s=setup_s, spans=tracer.spans, trace=tracer.summary)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if trace and tracer.summary is not None:
        s = tracer.summary
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in checks.items()}

    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark must not load: {bad}", file=err)
        return 3
    ms = sorted(1e3 * x for x in lat)
    pct = {f"p{q}": ms[min(len(ms) - 1, len(ms) * q // 100)]
           for q in (10, 50, 90, 95, 99)} if ms else {}
    print(json.dumps({"setup_parts": parts, "samples": sorted(got),
                      "requests": len(lat), "latency_ms": pct,
                      "reference_s": ref_s,
                      "traffic": getattr(traffic, "stats", dict)()}),
          file=out)
    for k, v in checks.items():
        print(f"check {k} {v} limit {limits.get(k)}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark (BENCHMARK.json) on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = files.spec()
    cell, _ = files.workload(spec, a.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{a.workload} needs {cell['chips']} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with torch.no_grad():
        return run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0,
                        torch.device("cuda:0"))
