"""Work of one call of the port's ``match_scan`` (mutual-nearest matching of
each band's centroids to the tracked slots): the centroids, their mask and
the slot state read once and written once; 5 operations per
centroid-slot distance per round."""

DEVICE_NAMES = ("match_scan_cluster",)


def work(args) -> tuple[int, int]:
    cents, cmask, _, rounds, t_cap = args[:5]
    b, c = cmask.shape
    return (4 * cents.numel() + cmask.numel() + b * t_cap * 9 + 4,
            5 * b * rounds * c * t_cap)
