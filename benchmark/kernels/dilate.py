"""Work of one call of the port's ``dilate`` (splat dilation of an i32[H,W]
key image): the image read once and written once; about 12 operations per
pixel, direction (8) and pass (``radius``)."""

DEVICE_NAMES = ("dilate_tile",)


def work(args) -> tuple[int, int]:
    kimg, radius = args[:2]
    return 8 * kimg.numel(), 12 * 8 * radius * kimg.numel()
