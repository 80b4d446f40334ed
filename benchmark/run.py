"""The port's benchmark: one cell of ``BENCHMARK.json`` on the CUDA card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the set-up's parts on one line, then the result as the last line of
standard output; each compared number and its limit are the last lines of
standard error.  Without a CUDA card (or with fewer cards than the cell
asks for) it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# the port's package sits at the root of the checkout, beside this folder
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], T0))
