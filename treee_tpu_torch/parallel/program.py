"""Shard programs: one sequence for a cloud on one device and for one shard
of a point-sharded cloud (``parallel/sharding.py``).

A shard program is a generator.  Over a mesh it yields each value that
combines across the shards as ``(op, tensor)`` and receives the combined
value: ``"min"``, ``"max"`` and ``"sum"`` reduce the shards' tensors,
``"gather"`` stacks them ``[D, ...]`` in shard order, and ``("once", fn)``
runs ``fn`` for all shards.  Run alone (``across=False``), a program yields
nothing and :func:`run_alone` returns what it returns.

A program that carries a value along the cloud's rows (a running max, a
count of the rows before) learns its shard's index when it is built;
:func:`gathered` gives it the shards' values, and :func:`prev_max`,
:func:`prev_sum` and :func:`next_min` fold the ones before or after it.  On
one device the program is shard 0 of 1, so the same lines give the
sentinels.
"""

from __future__ import annotations

import torch


def run_alone(program):
    """What a shard program returns when it runs on one device and so asks
    for no cross-shard value."""
    try:
        program.send(None)
    except StopIteration as done:
        return done.value
    raise AssertionError("a one-device program asked for a cross-shard value")


def gathered(x: torch.Tensor, across: bool):
    """The shards' values of ``x``, stacked ``[D, ...]`` in shard order
    (``x[None]`` alone); use as ``g = yield from gathered(x, across)``."""
    if across:
        return (yield "gather", x)
    return x[None]


def prev_max(g: torch.Tensor, index: int, sentinel) -> torch.Tensor:
    """The max of the stacked values ``g`` of the shards before ``index``;
    ``sentinel`` where there is none."""
    if index == 0:
        return torch.full_like(g[0], sentinel)
    return g[:index].amax(dim=0)


def prev_sum(g: torch.Tensor, index: int) -> torch.Tensor:
    """The sum of the stacked values ``g`` of the shards before ``index``."""
    return g[:index].sum(dim=0, dtype=g.dtype)


def next_min(g: torch.Tensor, index: int, sentinel) -> torch.Tensor:
    """The min of the stacked values ``g`` of the shards after ``index``;
    ``sentinel`` where there is none."""
    if index + 1 >= g.shape[0]:
        return torch.full_like(g[0], sentinel)
    return g[index + 1:].amin(dim=0)
