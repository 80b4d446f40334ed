"""Request kind ``render``: a camera move over the segmented scan and its
full frame on the host, as the upstream viewer draws every point every
frame.

Set-up segments the scan at ``setup_distance``.  The camera orbits the
stand's centre: each move turns the yaw by a seeded step from
``yaw_step_deg``; the pitch walks up and down ``pitch_deg`` by
``pitch_step_deg`` a move, and one move in ``zoom_every`` zooms by
``zoom_factor`` (out) or its inverse (in), walking the distance up and down
``distance_m``.  The pitch and zoom walks share one period, and the seed
picks the move at which a run enters it: every seed draws the same set of
pitches and distances, the frame's costs, in its own order.  A request is
the camera made from the move and ``Session.render(camera)``, a u8[H,W,3]
image on the host.  Compared after the window, on a sample of the window's
frames: every pixel against the plain reference's frame from the same
camera, on the reference's own segmentation of the stand.
"""

from __future__ import annotations

import numpy as np


def look_at(center: np.ndarray, yaw_deg: float, pitch_deg: float,
            distance: float) -> np.ndarray:
    """f32[4,4] camera-to-world transform of a camera ``distance`` from
    ``center`` at this yaw and pitch, looking at it (-z forward, y up)."""
    yaw, pitch = np.radians(yaw_deg), np.radians(pitch_deg)
    back = np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch),
                     np.cos(pitch) * np.cos(yaw)])
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2] = right, up, back
    t[:3, 3] = center + distance * back
    return t.astype(np.float32)


def stand_center(pts: np.ndarray) -> np.ndarray:
    """The middle of the stand's x/z box, at the median height."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    return np.array([(lo[0] + hi[0]) / 2, float(np.median(pts[::997, 1])),
                     (lo[2] + hi[2]) / 2])


def triangle(k: int, n: int) -> int:
    """Position ``k`` of a walk up and down ``n`` steps: 0, 1, ..., n,
    n - 1, ..., 1, 0, 1, ... (period 2n)."""
    k %= 2 * n
    return k if k <= n else 2 * n - k


class Traffic:
    def __init__(self, params: dict, seed: int, pts: np.ndarray, scene,
                 config: dict):
        p = self.p = params
        self.rng = np.random.default_rng([seed, 1])
        self.center = stand_center(pts)
        self.setup_distance = float(params["setup_distance"])
        self.warm = int(params["warm_frames"])
        lo, hi = p["pitch_deg"]
        self.pitch_steps = int(round((hi - lo) / p["pitch_step_deg"]))
        d0, d1 = p["distance_m"]
        self.zoom_steps = int(round(np.log(d1 / d0)
                                    / np.log(p["zoom_factor"])))
        self.every = int(p["zoom_every"])
        if self.pitch_steps != self.zoom_steps * self.every:
            raise ValueError("the pitch and zoom walks need one period")
        self.phase = int(self.rng.integers(2 * self.pitch_steps))
        self.yaws = [float(self.rng.uniform(0.0, 360.0))]

    def pose(self, i: int) -> tuple[float, float, float]:
        """(yaw, pitch, distance) of frame ``i``."""
        p = self.p
        while len(self.yaws) <= i:
            self.yaws.append((self.yaws[-1] + self.rng.uniform(
                *p["yaw_step_deg"])) % 360.0)
        k = self.phase + i
        pitch = p["pitch_deg"][0] + p["pitch_step_deg"] * triangle(
            k, self.pitch_steps)
        dist = p["distance_m"][0] * p["zoom_factor"] ** triangle(
            k // self.every, self.zoom_steps)
        return self.yaws[i], float(pitch), float(dist)

    def camera(self, api, i: int):
        yaw, pitch, dist = self.pose(i)
        return api.camera(look_at(self.center, yaw, pitch, dist), dist)

    def key(self, i: int):
        return None

    def prepare(self, sess, api, tracer) -> None:
        sess.segment(self.setup_distance)
        api.sync()

    def warm_ids(self) -> range:
        return range(self.warm)

    def before(self, sess, api, tracer, i: int) -> None:
        pass

    def request(self, sess, api, tracer, i: int):
        return sess.render(camera=self.camera(api, i))

    def host(self, out) -> np.ndarray:
        return out

    def replay(self, sess, api, ids) -> dict:
        sess.segment(self.setup_distance)
        return {i: sess.render(camera=self.camera(api, i)) for i in ids}

    def compare(self, got: dict, ref: dict) -> dict:
        """The share, in parts per million, of the sampled frames' pixels
        that differ from the reference's in any channel."""
        apart = pixels = 0
        for i, r in ref.items():
            pixels += r.shape[0] * r.shape[1]
            apart += (int((got[i] != r).any(axis=-1).sum())
                      if got[i].shape == r.shape else r.shape[0] * r.shape[1])
        return {"pixels_apart_ppm": 1e6 * apart / max(pixels, 1)}
