"""A configuration file made into the port's (or the reference's) ``Config``
and its stand's points."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import files


def config_from(cfg_module, sections: dict):
    """``cfg_module.Config`` (the port's or the reference's config module)
    with each section's fields as the configuration file states them; a
    section or field the module lacks raises."""
    default = cfg_module.Config()
    names = {f.name for f in dataclasses.fields(default)}
    unknown = set(sections) - names
    if unknown:
        raise KeyError(f"config sections {sorted(unknown)} not in Config")
    parts = {}
    for name in names:
        cur = getattr(default, name)
        kw = {}
        for k, v in sections.get(name, {}).items():
            if not hasattr(cur, k):
                raise KeyError(f"config field {name}.{k} not in Config")
            kw[k] = tuple(v) if isinstance(getattr(cur, k), tuple) else v
        parts[name] = dataclasses.replace(cur, **kw)
    return cfg_module.Config(**parts)


def thin(pts: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Exactly ``n`` of the points, drawn uniformly from ``seed``, in their
    order (a stand generated above the cap is thinned to it: truncating in
    the generator's order would drop whole trees, the strip and the
    outliers)."""
    if len(pts) < n:
        raise ValueError(f"the stand has {len(pts)} points, fewer than the "
                         f"{n} its configuration states")
    if len(pts) == n:
        return pts
    r = np.random.default_rng([seed, 3]).random(len(pts))
    keep = r <= np.partition(r, n - 1)[n - 1]
    return pts[keep]


def make_points(scene: dict, seed: int) -> np.ndarray:
    """The stand of a configuration's ``scene`` from ``seed``: f32[N,3]."""
    gen = files.load_module("scenes", scene["generator"])
    pts = gen.generate(scene["params"], seed)
    if scene.get("points") is not None:
        pts = thin(pts, int(scene["points"]), seed)
    return np.ascontiguousarray(pts, dtype=np.float32)
