"""``segment_points_ms``: the mean time of the ``segment_points`` span over the
traced window, the call that the ``Session`` makes into the
``segmentation`` layer (``spans/segment_points.json`` names it), on the host
clock, synchronized at both ends."""

SPANS = ("segment_points",)


def read(run):
    t = run.spans.get("segment_points")
    return 1e3 * sum(t) / len(t) if t else None
