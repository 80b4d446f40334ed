"""Inputs of the occupied-cell Voronoi (``kernels.nearest_slot``), made with
numpy so that the CPU tests and the card tests take the same bits.

Each case is the band scan's form: ``occ_idx`` the global flat indices of
the occupied cells in ascending order (``torch.nonzero``'s), zero-padded to
the row capacity, ``occ_valid`` the rows that hold one, the slots' positions
and flags, the grid's ``lo`` and cell size.
"""

import numpy as np
import torch

# kind: (bands, G, slots, each band's share of occupied cells, active share)
CASES = {
    # bands of ~2,500, ~250 and ~25 cells: row tiles inside one band and
    # across two and three; an empty band; padding rows past the last cell
    "mixed": (6, 64, 300, (0.6, 0.06, 0.06, 0.0, 0.4, 0.006), 0.5),
    # slots on cell corners: four equidistant slots around every centre
    "ties": (3, 64, 256, (0.3, 0.05, 0.2), 1.0),
    # 20 distinct positions shared by 700 slots
    "dups": (3, 64, 700, (0.2, 0.1, 0.3), 0.7),
    # bands 1 and 2 hold occupied cells but no active slot
    "no_active_band": (4, 64, 300, (0.1, 0.2, 0.05, 0.1), 0.5),
    "all_active": (2, 64, 2048, (0.2, 0.05), 1.0),
    # slots no multiple of 256, of a row tile or of a warp
    "t_ragged": (3, 64, 1000, (0.1, 0.3, 0.02), 0.6),
    # more active slots than one stage holds
    "t_over_stage": (2, 64, 5000, (0.15, 0.05), 0.6),
    "g384": (2, 384, 2048, (0.03, 0.01), 0.5),
    "g480": (2, 480, 513, (0.02, 0.005), 0.5),
    # padding rows between the valid ones, pointing at occupied cells too
    "padding": (3, 64, 300, (0.2, 0.1, 0.2), 0.5),
    # fewer rows than occupied cells: the rest stay -1
    "cap": (3, 64, 300, (0.4, 0.3, 0.4), 0.5),
}
PAD_ROWS = 1500          # padding past the last row: one all-padding tile


def case(kind: str, seed: int = 0):
    """(occ_idx i32[R], occ_valid bool[R], tracked_pos f32[B,T,2], active
    bool[B,T], lo f32[3], s f32[], n_bands, g) of ``kind``, on the CPU."""
    n_bands, g, t_cap, fill, share = CASES[kind]
    rng = np.random.default_rng(sorted(CASES).index(kind) * 1009 + seed)
    f32 = np.float32
    if kind == "ties":
        # dyadic lo and s: centres and corners exact, so corner slots tie
        lo = np.array([-32.0, 0.0, -32.0], f32)
        s = f32(0.5)
    else:
        lo = np.array([-37.3, 1.7, 12.1], f32)
        s = f32(0.75)
    occ = rng.random((n_bands, g, g)) < np.array(fill)[:, None, None]
    flat = np.flatnonzero(occ).astype(np.int32)
    if kind == "ties":
        corner = rng.integers(0, g + 1, (n_bands, t_cap, 2))
        pos = lo[[0, 2]] + corner.astype(f32) * s
    elif kind == "dups":
        spots = rng.uniform(0, g, (20, 2)).astype(f32) * s + lo[[0, 2]]
        pos = spots[rng.integers(0, 20, (n_bands, t_cap))]
    else:
        pos = rng.uniform(0, g, (n_bands, t_cap, 2)).astype(f32) * s
        pos = pos + lo[[0, 2]]
    active = rng.random((n_bands, t_cap)) < share
    if kind == "no_active_band":
        active[1:3] = False
    if kind == "cap":
        occ_idx = flat[:len(flat) // 2]
        valid = np.ones(len(occ_idx), bool)
    elif kind == "padding":
        rows = len(flat) + len(flat) // 3
        at = np.sort(rng.choice(rows, len(flat), replace=False))
        occ_idx = rng.integers(0, n_bands * g * g, rows).astype(np.int32)
        occ_idx[::7] = flat[rng.integers(0, len(flat), len(occ_idx[::7]))]
        valid = np.zeros(rows, bool)
        occ_idx[at], valid[at] = flat, True
        occ_idx = np.concatenate([occ_idx, np.zeros(PAD_ROWS, np.int32)])
        valid = np.concatenate([valid, np.zeros(PAD_ROWS, bool)])
    else:
        occ_idx = np.concatenate([flat, np.zeros(PAD_ROWS, np.int32)])
        valid = np.arange(len(occ_idx)) < len(flat)
    return (torch.from_numpy(occ_idx.astype(np.int32)),
            torch.from_numpy(valid), torch.from_numpy(pos.astype(f32)),
            torch.from_numpy(active), torch.from_numpy(lo),
            torch.tensor(s), n_bands, g)
