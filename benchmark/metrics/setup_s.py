"""``setup_s``: process start to the start of the window (library load and
kernel build, the stand, its upload, the state the traffic needs and the
warm-up), on the host clock."""


def read(run):
    return run.setup_s
