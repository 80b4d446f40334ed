"""Work of one call of the port's ``segmented_cumsum``: the i32 keys read
once, the f32 values read once and written once; one operation per
value."""

DEVICE_NAMES = ("scan_block",)


def work(args) -> tuple[int, int]:
    key, val = args[:2]
    return 4 * key.numel() + 8 * val.numel(), val.numel()
