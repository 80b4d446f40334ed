"""``cc_ms``: the mean over the window's ``Session.segment`` requests of the
device time of the program's ``segmentation.cc`` span (the connected
components: compaction, sweeps, pointer jumps and the fixpoint tests)."""

from harness import program


def read(run):
    return program.mean_ms(run, "Session.segment", "segmentation.cc")
