"""``rasterize_ms``: the mean time of the ``rasterize_keys`` span over the
traced window, the call that the ``Session`` makes into the
``render.splat`` layer (``spans/rasterize_keys.json`` names it), on the host
clock, synchronized at both ends."""

SPANS = ("rasterize_keys",)


def read(run):
    t = run.spans.get("rasterize_keys")
    return 1e3 * sum(t) / len(t) if t else None
