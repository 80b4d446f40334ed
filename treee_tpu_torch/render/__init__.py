"""The splat frame: camera, palettes, rasterizer, eye-dome, line overlays."""

from . import camera, lines, palettes, splat  # noqa: F401
from .camera import Camera  # noqa: F401
from .splat import (eye_dome, prop_from_segment, render_frame,  # noqa: F401
                    render_points, to_u8)
