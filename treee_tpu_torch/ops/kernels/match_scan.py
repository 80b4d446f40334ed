"""Band tracking: the CUDA kernel ``csrc/match_scan.cu`` and its plain version.

Counterpart of ``match_scan_pallas`` (``treee_tpu/ops/pallas_kernels.py``),
whose semantics are those of ``treee_tpu/segmentation.py::_match_band``
scanned over the bands.
"""

from __future__ import annotations

import torch

from . import build

INF = 3.0e38


def _check(cents: torch.Tensor, cmask: torch.Tensor, radius: float,
           t_cap: int, rounds: int) -> None:
    if cents.dtype != torch.float32 or cents.dim() != 3 or cents.shape[2] != 2:
        raise ValueError(f"match_scan: need f32[B,C,2] centroids, got "
                         f"{cents.dtype}{list(cents.shape)}")
    if cmask.dtype != torch.bool or cmask.shape != cents.shape[:2]:
        raise ValueError(f"match_scan: need bool[B,C] mask, got "
                         f"{cmask.dtype}{list(cmask.shape)}")
    if cmask.device != cents.device:
        raise ValueError("match_scan: centroids and mask on different devices")
    if t_cap < 1 or rounds < 0:
        raise ValueError(f"match_scan: bad t_cap={t_cap} or rounds={rounds}")
    if not radius < INF:
        raise ValueError(f"match_scan: radius must be below {INF}, got "
                         f"{radius}")


def match_scan_plain(cents: torch.Tensor, cmask: torch.Tensor, radius: float,
                     rounds: int, t_cap: int):
    """Track clusters top-down over the bands.

    Per band: ``rounds`` rounds of mutual-nearest pairing between the active
    tracked slots and the band's untaken clusters within ``radius`` (argmins
    break ties to the first index; a matched slot moves onto its cluster),
    then the k-th new cluster takes the k-th free slot by index.

    Returns (tracked_pos f32[B,T,2], active bool[B,T], n_alloc i32 scalar):
    the per-band snapshots and the number of slots allocated in all.
    """
    _check(cents, cmask, radius, t_cap, rounds)
    b, c_cap, _ = cents.shape
    dev = cents.device
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    pos = torch.zeros(t_cap + 1, 2, dtype=torch.float32, device=dev)
    act = torch.zeros(t_cap + 1, dtype=torch.bool, device=dev)
    n_alloc = torch.zeros((), dtype=torch.int32, device=dev)
    slots = torch.arange(t_cap, device=dev)
    out_pos = torch.empty(b, t_cap, 2, dtype=torch.float32, device=dev)
    out_act = torch.empty(b, t_cap, dtype=torch.bool, device=dev)
    for band in range(b):
        c = cents[band]
        taken = torch.cat([~cmask[band], torch.ones(1, dtype=torch.bool,
                                                    device=dev)])
        for _ in range(rounds):
            dx = pos[:t_cap, None, 0] - c[None, :, 0]
            dz = pos[:t_cap, None, 1] - c[None, :, 1]
            d = torch.sqrt(dx * dx + dz * dz)
            d = torch.where(act[:t_cap, None] & ~taken[None, :c_cap], d, INF)
            row_best = torch.argmin(d, dim=1)
            col_best = torch.argmin(d, dim=0)
            row_val = d.gather(1, row_best[:, None])[:, 0]
            mutual = ((col_best[row_best] == slots) & (row_val <= r)
                      & act[:t_cap])
            pos[:t_cap] = torch.where(mutual[:, None], c[row_best], pos[:t_cap])
            taken[torch.where(mutual, row_best, c_cap)] = True
        is_new = ~taken[:c_cap]
        free_order = torch.argsort(act[:t_cap].to(torch.uint8), stable=True)
        n_free = t_cap - act[:t_cap].sum()
        new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
        ok = is_new & (new_rank < n_free)
        slot = torch.where(ok, free_order[new_rank.clamp(0, t_cap - 1)], t_cap)
        pos[slot] = c
        act[slot] = True
        n_alloc += ok.sum(dtype=torch.int32)
        out_pos[band] = pos[:t_cap]
        out_act[band] = act[:t_cap]
    return out_pos, out_act, n_alloc


def match_scan(cents: torch.Tensor, cmask: torch.Tensor, radius: float,
               rounds: int, t_cap: int):
    """Band tracking (see :func:`match_scan_plain`): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(cents, cmask, radius, t_cap, rounds)
    if not build.on_cuda(cents, "match_scan"):
        return match_scan_plain(cents, cmask, radius, rounds, t_cap)
    b, c_cap, _ = cents.shape
    cents = cents.contiguous()
    cmask = cmask.contiguous()
    dev = cents.device
    out_pos = torch.empty(b, t_cap, 2, dtype=torch.float32, device=dev)
    out_act = torch.empty(b, t_cap, dtype=torch.bool, device=dev)
    n_alloc = torch.empty((), dtype=torch.int32, device=dev)
    build.launch(build.library().treee_match_scan, "match_scan", cents,
                 cents.data_ptr(), cmask.data_ptr(), b, c_cap, t_cap, rounds,
                 float(radius), out_pos.data_ptr(), out_act.data_ptr(),
                 n_alloc.data_ptr())
    match_scan.launches += 1
    return out_pos, out_act, n_alloc


match_scan.launches = 0
