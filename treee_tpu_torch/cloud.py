"""Fixed-capacity structure-of-arrays point store, as torch tensors.

The layout of ``treee_tpu/cloud.py``:

- ``pos``            f32[N, 3]   point positions, y-up
- ``segment``        i32[N]      segment id per point; 0 == deleted / unassigned
- ``classification`` i32[N]      0 Ground / 1 Trunk / 2 Crown
- ``valid``          bool[N]     capacity-padding mask (False = padding slot)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve

DELETED_SEGMENT = 0

CLASS_GROUND = 0
CLASS_TRUNK = 1
CLASS_CROWN = 2

# class filters for hull, RBV and export selection (IncludeMode)
INCLUDE_MODES = ("all", "crown", "trunk", "ground", "tree", "nocrown")


def include_mask(classification: torch.Tensor, mode: str) -> torch.Tensor:
    """bool[N] class filter for ``mode``, one of :data:`INCLUDE_MODES`."""
    if mode == "all":
        return torch.ones_like(classification, dtype=torch.bool)
    if mode == "crown":
        return classification == CLASS_CROWN
    if mode == "trunk":
        return classification == CLASS_TRUNK
    if mode == "ground":
        return classification == CLASS_GROUND
    if mode == "tree":
        return (classification == CLASS_CROWN) | (classification == CLASS_TRUNK)
    if mode == "nocrown":
        return (classification == CLASS_TRUNK) | (classification == CLASS_GROUND)
    raise ValueError(f"unknown include mode {mode!r} (one of {INCLUDE_MODES})")


@dataclasses.dataclass
class PointCloud:
    """Fixed-capacity SoA point store on one device."""

    pos: torch.Tensor             # f32[N, 3]
    segment: torch.Tensor         # i32[N]
    classification: torch.Tensor  # i32[N]
    valid: torch.Tensor           # bool[N]

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def count(self) -> int:
        """Number of valid points (a property, as in the JAX package)."""
        return int(self.valid.sum())

    def replace(self, **kw) -> "PointCloud":
        return dataclasses.replace(self, **kw)

    @classmethod
    def empty(cls, capacity: int,
              device: str | torch.device = DEFAULT_DEVICE) -> "PointCloud":
        """``capacity`` padding rows and no point."""
        device = resolve(device)
        return cls(
            pos=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            segment=torch.zeros(capacity, dtype=torch.int32, device=device),
            classification=torch.zeros(capacity, dtype=torch.int32,
                                       device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device))

    @property
    def alive(self) -> torch.Tensor:
        """Valid and not deleted."""
        return self.valid & (self.segment != DELETED_SEGMENT)

    def masked_pos(self, fill: float = float("inf")) -> torch.Tensor:
        """Positions with the padding rows replaced by ``fill``."""
        return torch.where(self.valid[:, None], self.pos, fill)

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) f32[3] over the alive points; zeros if none."""
        alive = self.alive
        m = alive[:, None]
        lo = torch.where(m, self.pos, 3.0e38).amin(dim=0)
        hi = torch.where(m, self.pos, -3.0e38).amax(dim=0)
        any_alive = alive.any()
        return (torch.where(any_alive, lo, 0.0),
                torch.where(any_alive, hi, 0.0))

    @classmethod
    def from_numpy(
        cls,
        pos: np.ndarray,
        capacity: int | None = None,
        segment: np.ndarray | None = None,
        classification: np.ndarray | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "PointCloud":
        """Copy host arrays to ``device``, padded to ``capacity`` rows.

        Capacity defaults to the next multiple of 1024, as in the JAX package.
        """
        n = pos.shape[0]
        if capacity is None:
            capacity = max(1024, ((n + 1023) // 1024) * 1024)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < point count {n}")
        device = resolve(device)

        def pad(a: np.ndarray, fill) -> torch.Tensor:
            out = np.full((capacity,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return torch.from_numpy(out).to(device)

        seg = segment if segment is not None else np.ones(n, np.int32)
        cls_ = (classification if classification is not None
                else np.zeros(n, np.int32))
        return cls(
            pos=pad(np.asarray(pos, np.float32), 0.0),
            segment=pad(np.asarray(seg, np.int32), DELETED_SEGMENT),
            classification=pad(np.asarray(cls_, np.int32), CLASS_GROUND),
            valid=torch.from_numpy(np.arange(capacity) < n).to(device),
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Valid rows on the host: ``pos``, ``segment``, ``classification``."""
        v = self.valid
        return {
            "pos": self.pos[v].cpu().numpy(),
            "segment": self.segment[v].cpu().numpy(),
            "classification": self.classification[v].cpu().numpy(),
        }
