"""``RefSession``: what the benchmark's traffic asks of the port's
``Session`` (``segment(d)``, then the ids, classes and table; ``render`` of
the segmented stand from a camera), answered by the plain reference.

``bf16=True`` stores the positions rounded to bfloat16 (and computes on
them as f32): the control, the step below the f32 that the configuration
states, which the benchmark's comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import torch

from . import frame, segment


class RefSession:
    def __init__(self, pos: np.ndarray, sections: dict, device="cpu",
                 bf16: bool = False):
        pos = torch.from_numpy(np.ascontiguousarray(pos, np.float32)).to(
            device)
        if bf16:
            pos = pos.to(torch.bfloat16).float()
        self.pos = pos
        self.valid = torch.ones(len(pos), dtype=torch.bool, device=device)
        self.sections = sections
        self.ids = torch.zeros(len(pos), dtype=torch.int32, device=device)
        self.classes = torch.zeros_like(self.ids)
        self.table = None

    def segment(self, max_distance: float) -> None:
        seg_cfg = self.sections["segmentation"]
        self.ids = segment.segment(self.pos, self.valid, max_distance,
                                   seg_cfg)
        self.table, self.classes = segment.segment_table(
            self.pos, self.ids, self.valid, seg_cfg["max_segments"] + 1,
            self.sections["characteristics"])

    def answers(self) -> dict:
        return {"segment": self.ids.cpu().numpy(),
                "classification": self.classes.cpu().numpy(),
                "table": self.table}

    def render(self, camera) -> np.ndarray:
        """``camera``: the f32[4,4] camera-to-world transform."""
        return frame.frame(self.pos, self.valid, self.ids, camera,
                           self.sections["render"])
