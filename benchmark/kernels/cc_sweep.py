"""Work of one call of the port's ``cc_sweep`` (CC label sweeps over
i32[B,G,G] bands): each label read once and written once; 9 operations (8
mins and a select) per cell for each sweep a band needs to reach its
fixpoint and see it, at most ``sweeps`` (the kernel stops a band there).
The sweeps a band needs depend on its labels, so the work is worked out
from the call's input with a plain sweep (``DATA``)."""

import torch

DEVICE_NAMES = ("cc_sweep_cluster",)
DATA = True
IBIG = 0x7FFFFFFF


def sweep(lbl: torch.Tensor) -> torch.Tensor:
    """One synchronous 3x3 min-pool sweep of each band's labels; empty
    cells (``IBIG``) stay empty."""
    pad = torch.nn.functional.pad(lbl, (1, 1, 1, 1), value=IBIG)
    m = torch.minimum(torch.minimum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:])
    m = torch.minimum(torch.minimum(m[:, :, :-2], m[:, :, 1:-1]),
                      m[:, :, 2:])
    return torch.where(lbl != IBIG, m, IBIG)


def sweeps_to_fixpoint(lbl: torch.Tensor, cap: int) -> torch.Tensor:
    """i64[B]: per band, the sweeps after which one more sweep leaves it
    unchanged (cap + 1 where it still changes after cap)."""
    fix = torch.full((lbl.shape[0],), cap + 1, dtype=torch.int64,
                     device=lbl.device)
    x = lbl
    for k in range(cap + 1):
        y = sweep(x)
        still = (y != x).flatten(1).any(1)
        fix = torch.where(~still & (fix > cap), k, fix)
        x = y
    return fix


def work(args) -> tuple[int, int]:
    lbl, sweeps = args[:2]
    fix = sweeps_to_fixpoint(lbl, sweeps)
    needed = int(torch.clamp(fix + 1, max=sweeps).sum())
    return 8 * lbl.numel(), 9 * needed * lbl[0].numel()
