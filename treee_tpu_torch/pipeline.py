"""The main path of the port: segmentation + characteristics, the full-cloud
frame, and the part of ``Session`` that drives them
(``treee_tpu/pipeline.py``).

LOD, edits, the focused view, ingest previews, checkpoints and exports are
not ported yet.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import characteristics as ch
from .cloud import DELETED_SEGMENT, PointCloud
from .config import Config, DEFAULT_CONFIG, RenderConfig
from .render import Camera, palettes, splat
from .segmentation import SegmentationResult, segment_points


def full_pipeline(pos: torch.Tensor, valid: torch.Tensor, max_distance: float,
                  cfg: Config = DEFAULT_CONFIG):
    """Segment + characteristics + classification.

    Returns (segment i32[N], classification i32[N], SegmentTable,
    SegmentationResult).
    """
    res = segment_points(pos, valid, max_distance, cfg.segmentation)
    table, classification = ch.compute_segments(
        pos, res.segment, valid, cfg.segmentation.max_segments + 1,
        cfg.characteristics, full_bbox=False)
    return res.segment, classification, table, res


def _height_preview(pos: torch.Tensor, valid: torch.Tensor, cam: Camera,
                    palette: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Un-segmented cloud coloured by normalized height (Session.preview_frame)."""
    y = pos[:, 1]
    big = 3.0e38
    any_v = valid.any()
    ylo = torch.where(any_v, torch.where(valid, y, big).amin(), 0.0)
    yhi = torch.where(any_v, torch.where(valid, y, -big).amax(), 1.0)
    prop = torch.clamp((y - ylo) / torch.clamp(yhi - ylo, min=1e-6), 0.0, 1.0)
    return splat.render_frame(pos, prop, valid, cam, palette, cfg)


def _u8(img: torch.Tensor) -> np.ndarray:
    return splat.to_u8(img).cpu().numpy()


class Session:
    """One point cloud on one device and the results computed from it."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 device: str | torch.device = "cpu"):
        self.config = config
        self.device = torch.device(device)
        self.cloud: PointCloud | None = None
        self.table: ch.SegmentTable | None = None
        self.camera = Camera.orbital(device=self.device)
        self.palette = palettes.get(config.render.palette, device=self.device)
        self.max_distance = config.segmentation.max_distance

    @classmethod
    def from_points(cls, pos: np.ndarray, config: Config = DEFAULT_CONFIG,
                    device: str | torch.device = "cpu") -> "Session":
        """A session on ``device`` holding the f32[N,3] y-up points ``pos``,
        padded to a multiple of 1024 rows."""
        s = cls(config, device=device)
        s.cloud = PointCloud.from_numpy(np.asarray(pos, np.float32),
                                        device=s.device)
        return s

    def preview_frame(self, camera: Camera | None = None) -> np.ndarray:
        """Height-coloured frame of the raw cloud, before segmentation;
        u8[H,W,3]."""
        cam = camera if camera is not None else self.camera
        return _u8(_height_preview(self.cloud.pos, self.cloud.valid, cam,
                                   self.palette, self.config.render))

    def segment(self, max_distance: float | None = None, preview_cb=None,
                preview_stride: int = 64) -> SegmentationResult:
        """Segment the cloud (re-callable with a new distance), then compute
        the segment table and each point's class.

        ``preview_cb(img)``: before the full cloud, every
        ``preview_stride``-th point is segmented and rendered segment-coloured
        with the session's camera, and the callback receives that u8[H,W,3]
        frame.
        """
        if max_distance is not None:
            self.max_distance = max_distance
        if preview_cb is not None:
            sub_pos = self.cloud.pos[::preview_stride].contiguous()
            sub_valid = self.cloud.valid[::preview_stride].contiguous()
            sub_seg, _, _, _ = full_pipeline(sub_pos, sub_valid,
                                             self.max_distance, self.config)
            img = splat.render_frame(
                sub_pos, splat.prop_from_segment(sub_seg),
                sub_valid & (sub_seg != DELETED_SEGMENT), self.camera,
                self.palette, self.config.render)
            preview_cb(_u8(img))
        seg, classification, table, res = full_pipeline(
            self.cloud.pos, self.cloud.valid, self.max_distance, self.config)
        self.cloud = self.cloud.replace(segment=seg,
                                        classification=classification)
        self.table = table
        if bool(res.occupied_overflow):
            logging.getLogger(__name__).warning(
                "segmentation occupied-cell compaction overflowed "
                "cc_occupied_cap=%d; cluster counts/centroids truncated — "
                "raise SegmentationConfig.cc_occupied_cap",
                self.config.segmentation.cc_occupied_cap,
            )
        return res

    def render(self, camera: Camera | None = None,
               prop: torch.Tensor | None = None, show_deleted: bool = False,
               palette: torch.Tensor | None = None) -> np.ndarray:
        """Full-cloud frame, u8[H,W,3]: segment-coloured unless ``prop``
        (f32[N] in [0,1]) is given; deleted points (segment 0) hidden unless
        ``show_deleted``."""
        cam = camera if camera is not None else self.camera
        pal = palette if palette is not None else self.palette
        cloud = self.cloud
        if prop is None:
            prop = splat.prop_from_segment(cloud.segment)
        mask = cloud.valid
        if not show_deleted:
            mask = mask & (cloud.segment != DELETED_SEGMENT)
        img = splat.render_frame(cloud.pos, prop.to(self.device), mask, cam,
                                 pal.to(self.device), self.config.render)
        return _u8(img)
