"""The port's f32 rules: how a plain version, a kernel and the JAX package
come to the same bits.

Ids, classes and tables are held bit-equal to the JAX package, and the card
bit-equal to the CPU.  That rests on three rules of arithmetic, which every
module of the port keeps where a result must match:

- **Round once per division.**  torch computes ``float / tensor`` as
  ``float * reciprocal(tensor)``, and on CUDA ``tensor / float`` as
  ``tensor * (1 / float)``, each rounded twice.  A division of two tensors
  on one device rounds once, as IEEE and XLA do: a Python number enters a
  division as :func:`full`, and :func:`div` divides by one.  :func:`full`
  is also how a Python number becomes an f32 on the device: made there,
  rounded to nearest like ``np.float32``, with no copy from the host.
- **Sum three terms as** ``(a + b) + c`` (:func:`sum3`), the order in which
  XLA reduces them.
- **Take extremes over the f32 total order.**  :func:`order` maps a float to
  an i32 whose signed order is the floats' order, -0.0 just below +0.0 and
  every NaN at one place above +inf; an integer min or max over these picks
  the same bits in any grouping, so integer atomics and shard combines
  repeat on every run.  :func:`unorder` maps back.

Rules that one module alone uses stay in it (``characteristics.fma``,
``quot``, ``_xla_row_sum``), as do the plain versions' own definitions
that another route reuses (``knn_select.smallest_k``,
``nearest_slot.cell_centers``).
"""

from __future__ import annotations

import torch


def full(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 0-d tensor on ``like``'s device.

    Divisions take their scalars in this form: torch computes
    ``float / tensor`` as ``float * reciprocal(tensor)``, and on CUDA
    ``tensor / float`` as ``tensor * (1 / float)``, each rounded twice; a
    division of two tensors on one device rounds once, as IEEE and XLA do.
    """
    return torch.full((), value, dtype=torch.float32, device=like.device)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python number ``b``, rounded once as IEEE and XLA
    divide (see :func:`full`)."""
    return torch.div(a, full(b, a))


def sum3(a, b, c):
    """``(a + b) + c``: a three-term sum in the order XLA reduces it."""
    return (a + b) + c


NAN_ORDER = 0x7FC00000


def order(val: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 whose signed order is the floats' order, with -0.0 just
    below +0.0 and every NaN at one place above +inf.  An integer max over
    these picks the same bits in any grouping."""
    bits = val.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(val), NAN_ORDER, key)


def unorder(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`order` (a NaN comes back as 0x7FC00000)."""
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)
