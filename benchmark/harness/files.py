"""Finding the benchmark's files by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def spec(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec_: dict, name: str) -> tuple[dict, dict]:
    """(the cell's entry in ``workloads``, its configuration's entry)."""
    cells = {w["name"]: w for w in spec_["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec_["configs"]}
    return cell, configs[cell["config"]]


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str, base: Path = BENCH_DIR) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    return json.loads((base / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """``benchmark/<kind>/<name>.py`` as a module (loaded once a process)."""
    path = base / kind / f"{name}.py"
    key = f"benchmark_{kind}:{name}@{base}"
    if key not in sys.modules:
        s = importlib.util.spec_from_file_location(key, path)
        if s is None or not path.exists():
            raise FileNotFoundError(f"no {kind} file {path}")
        mod = importlib.util.module_from_spec(s)
        sys.modules[key] = mod
        s.loader.exec_module(mod)
    return sys.modules[key]


def has_module(kind: str, name: str, base: Path = BENCH_DIR) -> bool:
    return (base / kind / f"{name}.py").exists()
