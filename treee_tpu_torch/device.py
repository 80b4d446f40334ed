"""The port's default device.

Every entry point that places tensors (``Session``, ``PointCloud.from_numpy``,
``SegmentTable.from_numpy``, the ``Camera`` constructors, the palettes) runs
on the CUDA card unless the caller passes ``device="cpu"``.  Nothing falls
back: on a machine without a card the default raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when torch
    sees no card, rather than running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA card; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
