"""Torch's CPU threads for the port's tests: the cores shared out over the
pytest workers.

Torch starts one intra-op thread per core in every process.  Six pytest
workers on eight cores then run 48 spinning threads: six of the port's
test files took 395 s under ``-n 6`` on an 8-core CPU, and 131 s with one
thread a worker.  A test file calls :func:`share_cores` as it is
imported; run alone, it keeps every core.
"""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
