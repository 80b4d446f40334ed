"""Request kind ``focus``: a tree's first open in the focused single-tree
view (the upstream's View mode), coloured by curvature with the crown hull,
the RBV cages and the trunk axis drawn over it.

Set-up segments the scan at ``setup_distance`` and computes the table with
full boxes (``Session.characteristics``).  The cycle is one present segment
for each of the ``target_points`` member counts: the segment whose count
lies nearest (ties to the lower id, no segment twice; a stand with fewer
segments cycles fewer).  Each tree's camera is fixed once from the seed: it
looks at the centre of the tree's box at a seeded yaw, at ``pitch_deg``,
from the distance at which the box's bounding sphere, grown by ``margin``,
fills the vertical field of view.  The requests run the cycle in a seeded
order, repeated; the warm-up runs one cycle.  Before each request the
session's focused-view caches are dropped (untimed), so every request is a
first open: the member rows, the k-NN curvature and the overlays are
computed anew.  A request is ``Session.render_focus`` to a u8[H,W,3] image
on the host.

Compared after the window, on a sample of the window's requests, against
the plain reference (``reference/focus.py``) on its own segmentation of the
stand, the reference's tree being the segment that shares the most points
with the port's member rows: the member rows, the curvature of the members
both hold (read from the caches the timed call filled, never recomputed)
and every pixel of the frame from the same camera.
"""

from __future__ import annotations

import math

import numpy as np

from harness import files
from reference import focus as ref_focus

look_at = files.load_module("requests", "render").look_at


def pick(counts: np.ndarray, present: np.ndarray,
         targets: list[int]) -> list[int]:
    """For each target in turn, the present segment (ids from 1) whose
    count lies nearest, ties to the lower id, none twice."""
    left = [i for i in range(1, len(counts)) if present[i]]
    out = []
    for t in targets:
        if not left:
            break
        best = min(left, key=lambda i: (abs(int(counts[i]) - t), i))
        out.append(best)
        left.remove(best)
    return out


def camera_for(lo: np.ndarray, hi: np.ndarray, yaw: float, pitch: float,
               margin: float, fov_y: float) -> tuple[np.ndarray, float]:
    """(f32[4,4] camera-to-world transform, distance) of a camera looking
    at the box's centre, the box's bounding sphere times ``margin`` filling
    ``fov_y``."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    radius = max(float(np.linalg.norm(hi - lo)) / 2.0, 0.5)
    dist = margin * radius / math.sin(fov_y / 2.0)
    return look_at((lo + hi) / 2.0, yaw, pitch, dist), dist


class Traffic:
    def __init__(self, params: dict, seed: int, pts: np.ndarray, scene,
                 config: dict):
        self.p = params
        self.render = config["render"]
        self.k = int(config["characteristics"]["neighbors"])
        self.rng = np.random.default_rng([seed, 1])
        self.n = len(params["target_points"])
        self.order = self.rng.permutation(self.n)
        self.yaws = self.rng.uniform(0.0, 360.0, self.n)
        self.trees: list[int] = []          # the port's segment ids
        self.cameras: list[tuple[np.ndarray, float]] = []
        self.port_cameras: list = []
        self.members: dict[int, np.ndarray] = {}    # request -> its rows

    def slot(self, i: int) -> int:
        """The cycle's position of request ``i``."""
        return int(self.order[i % len(self.order)])

    def camera(self, lo, hi, slot: int) -> tuple[np.ndarray, float]:
        return camera_for(lo, hi, float(self.yaws[slot]),
                          float(self.p["pitch_deg"]), float(self.p["margin"]),
                          float(self.render["fov_y"]))

    def key(self, i: int):
        return self.slot(i)

    def prepare(self, sess, api, tracer) -> None:
        sess.segment(float(self.p["setup_distance"]))
        table = sess.characteristics()
        api.sync()
        counts = table.count.cpu().numpy()
        self.trees = pick(counts, table.present.cpu().numpy(),
                          self.p["target_points"])
        if len(self.trees) < self.n:
            self.order = self.order[self.order < len(self.trees)]
        lo, hi = table.lo.cpu().numpy(), table.hi.cpu().numpy()
        self.cameras = [self.camera(lo[t], hi[t], s)
                        for s, t in enumerate(self.trees)]
        self.port_cameras = [api.camera(*c) for c in self.cameras]
        self.stats_ = {"trees": self.trees,
                       "members": [int(counts[t]) for t in self.trees]}

    def stats(self) -> dict:
        return getattr(self, "stats_", {})

    def warm_ids(self) -> range:
        return range(self.n)

    def before(self, sess, api, tracer, i: int) -> None:
        sess._clear_focus()

    def request(self, sess, api, tracer, i: int):
        s = self.slot(i)
        sid = self.trees[s]
        img = sess.render_focus(
            sid, self.port_cameras[s], display="curve",
            show_hull=True, hull_include="crown", show_rbv=True,
            rbv_method="max", show_axis=True, axis_algo="average")
        # what the timed call computed, from the caches it filled
        idx, sub_valid = sess._focus_idx_cache[sid]
        curve = sess._focus_prop_cache[("curve", sid, self.k)]
        return i, img, idx, sub_valid, curve

    def host(self, out) -> dict:
        i, img, idx, sub_valid, curve = out
        keep = sub_valid.cpu().numpy()
        rows = idx.cpu().numpy()[keep].astype(np.int64)
        self.members[i] = rows
        return {"members": rows, "curvature": curve.cpu().numpy()[keep],
                "frame": img}

    def replay(self, sess, api, ids) -> dict:
        """The reference's focused views of requests ``ids``.  After a run
        each request's tree is the reference's segment that shares the
        most points with the port's rows, and its camera the run's; without
        one (the control) the reference picks its trees and cameras from
        its own table, as ``prepare`` does from the port's."""
        sess.segment(float(self.p["setup_distance"]))
        ids_all = sess.ids
        ref_ids = ids_all.cpu().numpy()
        own = None
        if not self.members:
            table = sess.table
            own = pick(table["count"], table["present"],
                       self.p["target_points"])
        out = {}
        for i in ids:
            s = self.slot(i)
            if own is None:
                mine = ref_ids[self.members[i]]
                sid = int(np.bincount(mine).argmax()) if len(mine) else 0
                cam = self.cameras[s][0]
            else:
                sid = own[s] if s < len(own) else 0
                p = sess.pos[ids_all == sid].cpu().numpy()
                cam = (self.camera(p.min(0), p.max(0), s)[0] if len(p)
                       else np.eye(4, dtype=np.float32))
            out[i] = ref_focus.focus(sess.pos, sess.valid, ids_all,
                                     sess.classes, sid, cam, self.render)
        return out

    def compare(self, got: dict, ref: dict) -> dict:
        """Shares in parts per million: of the member rows of either side,
        those in one set and not the other; of the members both hold, those
        whose curvature differs by more than ``CURVE_TOL``; of the sampled
        frames' pixels, those that differ in any channel."""
        apart = rows = curve = shared = px = pixels = 0
        for i, r in ref.items():
            g = got[i]
            both, gi, ri = np.intersect1d(g["members"], r["members"],
                                          return_indices=True)
            union = len(g["members"]) + len(r["members"]) - len(both)
            rows += union
            apart += union - len(both)
            gap = np.abs(g["curvature"][gi].astype(np.float64)
                         - r["curvature"][ri])
            curve += int((~(gap <= CURVE_TOL)).sum())
            shared += len(both)
            f, rf = g["frame"], r["frame"]
            pixels += rf.shape[0] * rf.shape[1]
            px += (int((f != rf).any(axis=-1).sum()) if f.shape == rf.shape
                   else rf.shape[0] * rf.shape[1])
        return {"members_apart_ppm": 1e6 * apart / max(rows, 1),
                "curvature_apart_ppm": 1e6 * curve / max(shared, 1),
                "pixels_apart_ppm": 1e6 * px / max(pixels, 1)}


# a member's curvature counts as equal within this (the port's f32 closed
# form against the reference's f64 eigenvalues differ by ~1e-5 at most)
CURVE_TOL = 1e-4
