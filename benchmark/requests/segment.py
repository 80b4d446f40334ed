"""Request kind ``segment``: re-segmenting the whole scan, as a user does on
releasing the distance slider.

A request is ``Session.segment(d)``, which writes the ids, the classes and
the segment table, then a synchronize.  ``d`` cycles through a seeded
permutation of the traffic's ``distances``; the warm-up runs one cycle, so
every distance the window uses has run once.  Compared after the window, on
a sample of the window's requests: every point's segment and class, and
every entry of the table (float columns within ``TOLERANCE``), against the
plain reference at the same distance.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, params: dict, seed: int, pts: np.ndarray, scene,
                 config: dict):
        self.distances = [float(d) for d in params["distances"]]
        rng = np.random.default_rng([seed, 1])
        self.order = rng.permutation(len(self.distances))

    def distance(self, i: int) -> float:
        return self.distances[self.order[i % len(self.order)]]

    def key(self, i: int):
        return int(self.order[i % len(self.order)])

    def prepare(self, sess, api, tracer) -> None:
        pass

    def warm_ids(self) -> range:
        return range(len(self.order))

    def before(self, sess, api, tracer, i: int) -> None:
        pass

    def request(self, sess, api, tracer, i: int):
        sess.segment(self.distance(i))
        api.sync()
        return sess.cloud.segment, sess.cloud.classification, sess.table

    def host(self, out) -> dict:
        seg, cls_, table = out
        return {"segment": seg.cpu().numpy(),
                "classification": cls_.cpu().numpy(),
                "table": table.to_numpy()}

    def replay(self, sess, api, ids) -> dict:
        out = {}
        for i in ids:
            sess.segment(self.distance(i))
            out[i] = sess.answers()
        return out

    def compare(self, got: dict, ref: dict) -> dict:
        """Shares, in parts per million, of the sampled points whose segment
        or class, and of the table entries whose value, differ from the
        reference's.  Segments are matched one to one by the points they
        share (:func:`match_ids`): an id names a tracking slot, and a near
        tie of f32 sums can open the slots in another order, which renames
        trees without moving a point."""
        ids = classes = table = points = entries = 0
        for i, r in ref.items():
            g = got[i]
            n = len(r["segment"])
            rows = len(r["table"]["present"])
            to_ref = match_ids(g["segment"][:n], r["segment"], rows)
            # rows past the stand's points are the port's padding: no id
            ids += int((to_ref[g["segment"][:n]] != r["segment"]).sum()
                       + (g["segment"][n:] != 0).sum())
            classes += apart(g["classification"][:n], r["classification"])
            points += n
            for name, col in r["table"].items():
                mine = renumber(g["table"][name], to_ref)
                table += apart(mine[:rows], col, TOLERANCE.get(name)) + int(
                    np.count_nonzero(mine[rows:]))
                entries += col.size
        return {"ids_apart_ppm": 1e6 * ids / max(points, 1),
                "classes_apart_ppm": 1e6 * classes / max(points, 1),
                "table_apart_ppm": 1e6 * table / max(entries, 1)}


def match_ids(mine: np.ndarray, theirs: np.ndarray, rows: int) -> np.ndarray:
    """``to_ref``: a one-to-one map of the ids ``0..max(rows, ids) - 1`` of
    ``mine`` onto those of ``theirs``.  Pairs of ids are taken greedily by
    the points they share, most first; 0 (no segment) maps to 0; the ids
    left over on both sides are paired in order."""
    mine, theirs = mine.astype(np.int64), theirs.astype(np.int64)
    k = int(max(mine.max(initial=0), theirs.max(initial=0), rows - 1)) + 1
    pair, shared = np.unique(mine * k + theirs, return_counts=True)
    to_ref = np.full(k, -1, np.int64)
    to_ref[0] = 0
    taken = np.zeros(k, bool)
    taken[0] = True
    for p in pair[np.argsort(-shared, kind="stable")]:
        a, b = divmod(int(p), k)
        if to_ref[a] < 0 and not taken[b]:
            to_ref[a], taken[b] = b, True
    to_ref[to_ref < 0] = np.flatnonzero(~taken)
    return to_ref


def renumber(col: np.ndarray, to_ref: np.ndarray) -> np.ndarray:
    """``col``'s rows moved to the reference's ids."""
    col = np.asarray(col)
    out = np.zeros((len(to_ref),) + col.shape[1:], col.dtype)
    out[to_ref[:len(col)]] = col
    return out


# what an entry of a float column may lie from the reference's and still
# count as equal: (metres or square metres, share of the value).  Heights
# are read on the same quantised grid on both sides, so only a separator
# that moves by a slice (0.1 m) counts; a slice's area is the reference's
# exact polygon against the port's f32 shoelace, whose terms are squared
# coordinates of ~100 m and cancel (PERF.md section 2)
TOLERANCE = {"areas": (0.01, 0.01), "lo": (1e-3, 0.0), "hi": (1e-3, 0.0),
             "ground_sep": (1e-3, 0.0), "crown_sep": (1e-3, 0.0),
             "trunk_height": (1e-3, 0.0), "crown_height": (1e-3, 0.0)}


def apart(a: np.ndarray, b: np.ndarray, tol=None) -> int:
    """Entries of two arrays that differ, beyond ``tol`` = (absolute,
    relative) where given (a shape that differs counts every entry)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    if tol is None:
        return int((a != b).sum())
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return int((~(gap <= tol[0] + tol[1] * np.abs(b))).sum())
