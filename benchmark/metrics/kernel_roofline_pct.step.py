"""``kernel_roofline_pct.step``: the hand kernels of the step (CC sweeps,
the band match, the two segmented scans) against their roofline: the sum
over the window's calls of each call's least time on the card (its bytes at
3.35 TB/s or its operations at 67 TFLOP/s, as ``kernels/<name>.py`` counts
them), over the sum of those kernels' device time in the profiler's trace.
Left out where the trace lost a kernel record or none ran."""

KERNELS = ("cc_sweep", "match_scan", "segmented_cummax", "segmented_cumsum")


def read(run):
    return run.trace.roofline_pct(KERNELS) if run.trace else None
