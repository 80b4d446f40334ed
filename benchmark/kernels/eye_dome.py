"""Work of one call of the port's ``eye_dome`` (eye-dome lighting of an
f32[H,W,3] colour image by its f32[H,W] depth): colour read and written
once, depth read once; about 40 operations per pixel."""

DEVICE_NAMES = ("eye_dome_strip",)


def work(args) -> tuple[int, int]:
    color, z01 = args[:2]
    return 4 * (2 * color.numel() + z01.numel()), 40 * z01.numel()
