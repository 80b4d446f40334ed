"""The main path of the port: segmentation + characteristics, the full-cloud
frame, the whole-forest inventory, and the part of ``Session`` that drives
them (``treee_tpu/pipeline.py``).

LOD, edits, the focused view, ingest previews, checkpoints, exports and the
forest summary are not ported yet.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import characteristics as ch
from . import rbv as rbv_mod
from . import trunk_axis
from .cloud import CLASS_TRUNK, DELETED_SEGMENT, PointCloud
from .config import Config, DEFAULT_CONFIG, RenderConfig
from .device import DEFAULT_DEVICE, resolve
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


def _segment_class_counts(segment, classification, mask,
                          n_segments: int) -> torch.Tensor:
    """i32[S,3] point counts per (segment, ground/trunk/crown class)."""
    t = torch.where(mask, segment * 3 + torch.clamp(classification, 0, 2),
                    n_segments * 3)
    counts = torch.zeros(n_segments * 3 + 1, dtype=torch.int32,
                         device=segment.device)
    counts.index_add_(0, t.long(), torch.ones_like(t, dtype=torch.int32))
    return counts[:-1].view(n_segments, 3)


class Session:
    """One point cloud on one device and the results computed from it."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve(device)
        self.cloud: PointCloud | None = None
        # shift from the cloud's frame to the scan's map frame (y-up)
        self.world_offset = np.zeros(3, np.float64)
        self.table: ch.SegmentTable | None = None
        # segment() stores a table whose x/z bounds are zero placeholders
        # (full_bbox=False); full_table() recomputes it when this is False
        self._bbox_full = True
        self.camera = Camera.orbital(device=self.device)
        self.palette = palettes.get(config.render.palette, device=self.device)
        self.max_distance = config.segmentation.max_distance

    @classmethod
    def from_points(cls, pos: np.ndarray, config: Config = DEFAULT_CONFIG,
                    world_offset: np.ndarray | None = None,
                    device: str | torch.device = DEFAULT_DEVICE) -> "Session":
        """A session on ``device`` holding the f32[N,3] y-up points ``pos``,
        padded to a multiple of 1024 rows; ``world_offset`` f64[3] shifts
        them to the map frame (the inventory's easting and northing)."""
        s = cls(config, device=device)
        s.cloud = PointCloud.from_numpy(np.asarray(pos, np.float32),
                                        device=s.device)
        if world_offset is not None:
            s.world_offset = np.asarray(world_offset, np.float64)
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
        self._bbox_full = False
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

    def characteristics(self) -> ch.SegmentTable:
        """Recompute the table, with full boxes, and the classes of the
        current segments; deleted points keep their classes."""
        cloud = self.cloud
        table, classification = ch.compute_segments(
            cloud.pos, cloud.segment, cloud.valid,
            self.config.segmentation.max_segments + 1,
            self.config.characteristics)
        live = cloud.valid & (cloud.segment != DELETED_SEGMENT)
        self.cloud = cloud.replace(classification=torch.where(
            live, classification, cloud.classification))
        self.table = table
        self._bbox_full = True
        return table

    def full_table(self) -> ch.SegmentTable:
        """The table with real x/z bounds: ``segment()`` keeps zero
        placeholders there, so this recomputes the characteristics first
        when needed (calculations.rs:136-147)."""
        if self.table is None or not self._bbox_full:
            self.characteristics()
        return self.table

    def inventory(self, method: str = "max", symmetric: bool = False,
                  crown_slices: int = 26, crown_sectors: int = 32,
                  trunk_slices: int = 5, trunk_sectors: int = 32,
                  axis_algo: str = "average") -> dict[str, np.ndarray]:
        """Whole-forest per-tree inventory: every segment's trunk axis, split
        RBVs and forestry traits in one batched pass on the device.

        Returns a dict of equal-length numpy columns, one row per present
        segment with points: segment id, per-class point counts, the box
        centre (local x/z and map easting/northing), the stem position (the
        trunk axis's origin, else the box centre), heights and separators
        from the table, ``axis_found``, and the eight hull.rs traits.
        ``method`` "max" or "mean" picks the RBV cell value, ``axis_algo``
        "average" or "lowhigh" the trunk-axis algorithm.
        """
        table = self.full_table()
        n_seg = int(table.present.shape[0])
        cloud = self.cloud
        seg, cls_ = cloud.segment, cloud.classification
        live = (cloud.valid & (seg != DELETED_SEGMENT) & (seg >= 0)
                & (seg < n_seg))
        axis_fn = (trunk_axis.batched_low_high_layer if axis_algo == "lowhigh"
                   else trunk_axis.batched_average_direction)
        axes = axis_fn(cloud.pos, live & (cls_ == CLASS_TRUNK), seg, n_seg)
        transforms = trunk_axis.batched_axis_transform(axes)
        crown, trunk = rbv_mod.batched_split_rbv(
            cloud.pos, cls_, live, seg, n_seg, transforms,
            crown_slices=crown_slices, crown_sectors=crown_sectors,
            trunk_slices=trunk_slices, trunk_sectors=trunk_sectors,
            method=(rbv_mod.METHOD_MEAN if method == "mean"
                    else rbv_mod.METHOD_MAX),
            symmetric=symmetric)
        tr = rbv_mod.batched_traits(crown, trunk)
        cnts = _segment_class_counts(seg, cls_, live, n_seg).cpu().numpy()

        present = table.present.cpu().numpy()
        total = cnts.sum(axis=1)
        ids = np.flatnonzero(present & (total > 0)
                             & (np.arange(n_seg) != DELETED_SEGMENT))
        lo, hi = table.lo.cpu().numpy(), table.hi.cpu().numpy()
        cx = (lo[ids, 0] + hi[ids, 0]) / 2.0
        cz = (lo[ids, 2] + hi[ids, 2]) / 2.0
        found = axes.found.cpu().numpy()[ids]
        origin = axes.origin.cpu().numpy()[ids]
        wo = self.world_offset
        out = {
            "segment": ids.astype(np.int32),
            "n_points": total[ids].astype(np.int32),
            "n_ground": cnts[ids, 0],
            "n_trunk": cnts[ids, 1],
            "n_crown": cnts[ids, 2],
            "x": cx.astype(np.float64),
            "z": cz.astype(np.float64),
            # map frame: easting = x + off_x, northing = -(z + off_z)
            "easting": cx + wo[0],
            "northing": -(cz + wo[2]),
            "stem_easting": np.where(found, origin[:, 0], cx) + wo[0],
            "stem_northing": -(np.where(found, origin[:, 2], cz) + wo[2]),
            "tree_height": (hi[ids, 1] - lo[ids, 1]).astype(np.float64),
            "ground_sep": table.ground_sep.cpu().numpy()[ids],
            "crown_sep": table.crown_sep.cpu().numpy()[ids],
            "trunk_height": table.trunk_height.cpu().numpy()[ids],
            "crown_height": table.crown_height.cpu().numpy()[ids],
            "axis_found": found,
        }
        for name in rbv_mod.TRAITS:
            out[name] = (getattr(tr, name).cpu().numpy()[ids]
                         .astype(np.float64))
        return out
