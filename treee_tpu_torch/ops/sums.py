"""Per-key float sums in an order fixed by the input.

A float ``index_add_`` on a CUDA tensor adds with atomics, in another order
on every run, so sums that decide ids or table columns would not repeat.
``sums_by_key`` sorts the rows stably by key and sums each run of equal keys
with ``kernels.segmented_cumsum`` (the CUDA kernel on the card, its plain
version on the CPU); each run's last row is its total.  Every step is
deterministic, so two runs on the same input give the same bits.
``ordered_sums`` takes that route on the card and a sequential
``index_add_`` on the CPU, whose order is XLA's scatter-add's.
"""

from __future__ import annotations

import torch

from . import kernels


def sums_by_key(key: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    """f32[size, C]: the sum of the rows of ``val`` f32[M,C] per key in
    [0, size); zero for keys without rows, and rows with other keys left
    out."""
    key_s, order = torch.sort(key.to(torch.int32), stable=True)
    run = kernels.segmented_cumsum(key_s, val[order])
    q = torch.arange(size, dtype=torch.int32, device=key.device)
    end = (torch.searchsorted(key_s, q, side="right") - 1).clamp(min=0)
    return torch.where((key_s[end] == q)[:, None], run[end], 0.0)


def ordered_sums(key: torch.Tensor, val: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """f32[size, C]: as :func:`sums_by_key`, but on a CPU tensor summed by a
    sequential ``index_add_`` in row order, which is the order of XLA's
    scatter-add (so the CPU equals the JAX package bit for bit)."""
    if key.device.type != "cpu":
        return sums_by_key(key, val, size)
    tgt = torch.where((key >= 0) & (key < size), key, size).long()
    out = torch.zeros((size + 1, val.shape[1]), dtype=val.dtype)
    out.index_add_(0, tgt, val)
    return out[:size]
