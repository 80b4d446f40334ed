"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``treee_tpu/ops/pallas_kernels.py``.  Every wrapper runs its
kernel on a CUDA tensor and its plain version on a CPU tensor; a failed build
or launch raises, and no other device is accepted.  Each wrapper counts its
kernel launches in a plain integer attribute, ``wrapper.launches``.
"""

from .cc_sweep import cc_sweep, cc_sweep_plain
from .dilate import dilate, dilate_plain
from .eye_dome import eye_dome, eye_dome_plain
from .jump_flood import jump_flood, jump_flood_plain
from .jump_flood import jump_flood_grid, jump_flood_grid_plain
from .jump_flood import CLUSTER_CTAS as JUMP_FLOOD_CLUSTER_CTAS
from .jump_flood import grid_launches as jump_flood_grid_launches
from .jump_flood import grid_plan as jump_flood_grid_plan
from .jump_flood import resident_clusters as jump_flood_clusters
from .jump_flood import route as jump_flood_route
from .jump_flood import steps as jump_flood_steps
from .knn_select import knn_select, knn_select_plain
from .match_scan import match_scan, match_scan_plain
from .nearest_slot import nearest_slot, nearest_slot_plain
from .seg_cummax import segmented_cummax, segmented_cummax_plain
from .seg_cumsum import segmented_cumsum, segmented_cumsum_plain
from .take_along import take_along_axis, take_along_axis_plain

WRAPPERS = (cc_sweep, match_scan, segmented_cummax, dilate, eye_dome,
            segmented_cumsum, jump_flood, take_along_axis, jump_flood_grid,
            nearest_slot, knn_select)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
