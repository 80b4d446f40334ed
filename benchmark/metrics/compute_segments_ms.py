"""``compute_segments_ms``: the mean time of the ``compute_segments``
span over the traced window, the call that the ``Session`` makes into
the ``characteristics`` layer (``spans/compute_segments.json`` names
it), on the host clock, synchronized at both ends."""

SPANS = ("compute_segments",)


def read(run):
    t = run.spans.get("compute_segments")
    return 1e3 * sum(t) / len(t) if t else None
