"""The port's ``Session`` (``treee_tpu/pipeline.py``): one point cloud and
everything the front ends (``app.py``, ``repl.py``, ``serve.py``) drive on
it — segmentation + characteristics, the full-cloud frame, the octree LOD
and screen-adaptive frames, the sphere edits with ray picking, the
whole-forest inventory, the focused single-tree view, the terrain and
canopy rasters with the height above ground (the ``hag`` display) and the
forest summary, LAS/LAZ ingest with its preview frames and the scan's
source attributes (the attribute displays), checkpoints and merges, and the
point exports.

**Mesh mode.** ``Session(config, mesh=...)`` (a ``parallel.sharding.Mesh``,
or ``"auto"``: every CUDA card when there are several, else no mesh) holds
its cloud as a ``ShardedCloud``.  Ingest orders the rows by Morton key once
(the unpadded points' box, a stable sort; the attributes follow) and splits
them contiguously into shards of equal rows, the capacity rounded to blocks
of 1024 x D.  Every method then runs over the shards through
``parallel/sharding.py`` and equals a one-device session fed the same rows
at the same capacity: ids, classes, tables, LOD indices, picks, rasters,
frames and the integer inventory columns bit for bit, the inventory's float
columns within float rounding (sums added in shard order).  The edits run
on each shard (``ShardedCloud.map``); a segment's member rows (the focused
view, ``segment_rows``) are compacted shard by shard and concatenated in
shard order, the rows one device compacts.  Per-point results over the
whole cloud (``curvature``, ``normals``, ``properties``,
``height_above_ground``, ``hag_prop``, ``attribute_prop``) come back as a
list of one tensor a shard (``sharding.gather`` makes one tensor of them),
and ``render(prop=...)`` takes that list or one tensor in row order.

Gathers on the mesh: two paths copy whole columns to the first device and
run the one-device function there — ``properties()`` (one sort over every
row) and the grid path (a segment past ``NeighborConfig.brute_force_max``
points: its k-NN, and its focused view, which reads it; also the live
cloud's curvature of ``export_points_ply``).
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from . import characteristics as ch
from . import geo
from . import hull3d
from . import interactive as edit
from . import rasters as rs
from . import rbv as rbv_mod
from . import trunk_axis
from .cloud import CLASS_TRUNK, DELETED_SEGMENT, PointCloud, include_mask
from .config import Config, DEFAULT_CONFIG, RenderConfig
from .device import DEFAULT_DEVICE, resolve
from .io import exports, ipc, las
from .ops import octree as octree_mod
from .ops.f32 import full
from .parallel import sharding
from .parallel.program import run_alone
from .render import Camera, lines, palettes, splat
from .segmentation import SegmentationResult, scene_bounds, segment_points
from .utils.profiling import span, waited

# the focused view's displays besides the scan's source attributes
# (``Session.attributes``, io/las.decode_attributes)
FOCUS_DISPLAYS = ("classification", "hag", "expansion", "height", "curve",
                  "shaded")
# Lambert light of the shaded display, unit, y-up
SHADE_LIGHT = (0.45, 0.76, 0.47)


def _evict_oldest(d: dict, cap: int) -> None:
    """Bound a cache dict to ``cap`` entries, dropping the least recently
    used (``_lru_get`` refreshes an entry on a hit; dicts keep insertion
    order).  The focused view's caches hold device tensors, which browsing
    many segments would otherwise pile up."""
    while len(d) > cap:
        d.pop(next(iter(d)))


def _lru_get(d: dict, key):
    """``d.get(key)`` that re-inserts a hit, so ``_evict_oldest`` drops the
    least recently used entry, not the oldest."""
    val = d.get(key)
    if val is not None:
        d[key] = d.pop(key)
    return val


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


def _height_prop(pos: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Each point's height in [0, 1] between the bounds' y (the preview's
    colouring)."""
    ylo, yhi = lo[1].to(pos.device), hi[1].to(pos.device)
    return torch.clamp((pos[:, 1] - ylo) / torch.clamp(yhi - ylo, min=1e-6),
                       0.0, 1.0)


def _lod_frame(pos_c: torch.Tensor, seg_c: torch.Tensor,
               valid_c: torch.Tensor, count: torch.Tensor, cam: Camera,
               palette: torch.Tensor, cfg: RenderConfig,
               prop_c: torch.Tensor | None = None) -> torch.Tensor:
    """One frame of the LOD subset, with the cloud's current segments and
    validity (``seg_c``, ``valid_c``) read through the cached indices.

    Edits between frames only rewrite ``cloud.segment`` and ``cloud.valid``;
    a frame re-reads them with subset-sized gathers, so an edit needs no
    compaction of the full cloud.  ``prop_c`` (the subset's rows of a
    property) colours the points in place of their segment ids.
    """
    slot = torch.arange(seg_c.shape[0], dtype=torch.int32,
                        device=seg_c.device)
    mask_c = valid_c & (seg_c != DELETED_SEGMENT) & (slot < count)
    if prop_c is None:
        prop_c = splat.prop_from_segment(seg_c)
    return splat.render_frame(pos_c, prop_c, mask_c, cam, palette, cfg)


def _px_scale(cam: Camera, cfg: RenderConfig) -> np.float32:
    """f_proj * height/2 in f32: world size to pixels at distance 1."""
    p11 = cam.projection_entries(cfg.width / cfg.height)[1, 1]
    return np.float32(p11) * np.float32(cfg.height / 2.0)


def _u8(img: torch.Tensor) -> np.ndarray:
    """A frame as u8 on the host."""
    with span("render.readback", img.device):
        waited("render.readback")
        return splat.to_u8(img).cpu().numpy()


class Session:
    """One point cloud, on one device or over a mesh (module docstring),
    and the results computed from it."""

    def __init__(self, config: Config = DEFAULT_CONFIG,
                 device: str | torch.device = DEFAULT_DEVICE, mesh=None):
        self.config = config
        if mesh == "auto":
            mesh = sharding.auto_mesh(device)
        self.mesh: sharding.Mesh | None = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve(device)
        self.cloud: PointCloud | sharding.ShardedCloud | None = None
        # shift from the cloud's frame to the scan's map frame (y-up)
        self.world_offset = np.zeros(3, np.float64)
        self.table: ch.SegmentTable | None = None
        # segment() stores a table whose x/z bounds are zero placeholders
        # (full_bbox=False); full_table() recomputes it when this is False
        self._bbox_full = True
        self.camera = Camera.orbital(device=self.device)
        self.palette = palettes.get(config.render.palette, device=self.device)
        self.max_distance = config.segmentation.max_distance
        # set by membership edits; cleared when the table is recomputed
        self._counts_stale = False
        self._next_id: int | None = None    # host mirror of the id counter
        # the octree of the cloud's positions (over a mesh, one a shard),
        # kept across edits (they never move a point), and the LOD subset
        # (pos_c, idx, count) on the session's device
        self._tree: octree_mod.Octree | list | None = None
        self._lod: tuple | None = None
        # the proj string that geo-references the map frame
        self.source_location = config.interactive.source_location
        # the focused view's caches; membership-derived, so every edit of
        # membership, segment() and characteristics() clear them
        self._clear_focus()
        # hag_prop per raster cell size; the DTM follows the live set and
        # the ground class, so segment(), characteristics(), membership
        # edits and reclassify_sphere drop it
        self._hag_cache: dict[float, torch.Tensor | list] = {}
        # the scan's source point-record attributes (intensity, rgb, ...,
        # io/las.decode_attributes): host arrays padded to the cloud's
        # capacity, row-aligned with it (edits never reorder rows); their
        # display properties on the device, per name (attribute_prop)
        self.attributes: dict[str, np.ndarray] = {}
        self._attr_dev: dict[str, tuple] = {}
        # the focused view's second stream of the card (_beside)
        self._side: torch.cuda.Stream | None = None

    # ---- the two forms of a per-point value ----------------------------------

    def _col(self, name: str):
        """A field of the cloud: a tensor, or over a mesh its shards."""
        if self.mesh is not None:
            return self.cloud.column(name)
        return getattr(self.cloud, name)

    def _whole(self, x) -> torch.Tensor:
        """A per-point value as one tensor (a mesh's shards gathered to the
        session's device)."""
        return sharding.gather(x) if isinstance(x, list) else x

    def _split(self, x):
        """A per-point value in the session's form: over a mesh its shards
        (one tensor in row order is split), else one tensor on the
        session's device."""
        if self.mesh is not None:
            return x if isinstance(x, list) else sharding.split(self.mesh, x)
        return x.to(self.device)

    def _take(self, x, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of a per-point value, on the session's device."""
        return sharding.take(x, idx) if isinstance(x, list) else x[idx]

    def _each(self, fn, *xs):
        """``fn`` of per-point values, elementwise: on each shard's tensors
        over a mesh."""
        if self.mesh is None:
            return fn(*xs)
        return [fn(*a) for a in zip(*xs)]

    def _host(self, x) -> np.ndarray:
        """A per-point value on the host, every row in row order."""
        if isinstance(x, list):
            return np.concatenate([t.cpu().numpy() for t in x])
        return x.cpu().numpy()

    def _count(self, mask) -> int:
        if isinstance(mask, list):
            return int(torch.stack([m.sum().to(self.device)
                                    for m in mask]).sum())
        return int(mask.sum())

    def _clear_focus(self) -> None:
        """Drop the focused view's caches:

        - ``_counts_np``: a host copy of ``table.count`` (brute or grid);
        - ``_focus_cnt_cache``: member counts synced while the table is
          stale, per segment (at most 64);
        - ``_focus_idx_cache``: a segment's member rows compacted to a snug
          buffer, (idx, sub_valid) (at most 8);
        - ``_focus_prop_cache``: brute-path curvature and normals of those
          rows, per (kind, segment, k) (at most 16);
        - ``_focus_grid_cache``: grid-path results of the full cloud, per
          (kind, segment, k) (at most 2).
        """
        self._counts_np: np.ndarray | None = None
        self._focus_cnt_cache: dict[int, int] = {}
        self._focus_idx_cache: dict[int, tuple] = {}
        self._focus_prop_cache: dict[tuple, torch.Tensor] = {}
        self._focus_grid_cache: dict[tuple, torch.Tensor | list] = {}

    def _install_cloud(self, pos, segment=None, classification=None,
                       attrs: dict | None = None,
                       capacity: int | None = None) -> None:
        """Put the points (and their source attributes) on the session's
        device, padded to ``capacity`` rows (a multiple of 1024 by
        default).  Over a mesh the rows are first ordered by Morton key
        (``sharding.morton_order`` over the points' box, a stable sort; the
        other columns and the attributes follow), and the capacity is
        rounded up to blocks of 1024 x D, so that each shard is a run of
        ascending keys and a multiple of the anchor histogram's stride
        (treee_tpu/pipeline.py:251-281)."""
        pos = np.asarray(pos, np.float32)
        self._tree = None
        if self.mesh is None:
            self.cloud = PointCloud.from_numpy(
                pos, capacity=capacity, segment=segment,
                classification=classification, device=self.device)
        else:
            n = len(pos)
            if n:
                p = torch.from_numpy(pos).to(self.device)
                order = sharding.morton_order(
                    p, torch.ones(n, dtype=torch.bool, device=self.device))
                order = order.cpu().numpy()
                del p
                pos = pos[order]
                if segment is not None:
                    segment = np.asarray(segment)[order]
                if classification is not None:
                    classification = np.asarray(classification)[order]
                if attrs is not None:
                    attrs = {k: np.asarray(v)[order] for k, v in attrs.items()}
            block = 1024 * self.mesh.size
            cap = max(block, -(-n // block) * block)
            if capacity is not None:
                cap = max(cap, -(-capacity // block) * block)
            self.cloud = sharding.ShardedCloud.from_numpy(
                self.mesh, pos, cap, segment=segment,
                classification=classification)
        self._attach_attributes(attrs if attrs is not None else {})

    def _drop_derived(self) -> None:
        """Forget everything computed from the cloud that was replaced: the
        table, the id counter, the octree and LOD subset, the height above
        ground and the focused view's caches."""
        self.table = None
        self._counts_stale = False
        self._next_id = None
        self._tree = None
        self._lod = None
        self._hag_cache = {}
        self._clear_focus()

    # ---- loading (the Loading phase, treee/src/loading.rs) ----------------

    @classmethod
    def from_las(cls, source, config: Config = DEFAULT_CONFIG,
                 max_points: int | None = None, preview_cb=None,
                 preview_points: int = 1 << 20,
                 slab_points: int = 4_000_000,
                 device: str | torch.device = DEFAULT_DEVICE,
                 mesh=None) -> "Session":
        """A session on ``device`` (or over ``mesh``) holding a LAS/LAZ scan
        (a path or bytes), recentred on its header bounds' centre
        (``world_offset``).

        With ``preview_cb``, coarse height-coloured frames stream during the
        decode, as the reference draws chunks while loading
        (loading.rs:91-115): each decoded slab (about ``slab_points``,
        aligned to .laz chunks) adds to a fixed ``preview_points``
        subsample, and ``preview_cb(img u8[H,W,3])`` receives its frame."""
        s = cls(config, device=device, mesh=mesh)
        if preview_cb is None:
            scan = las.load(source, max_points=max_points)
        else:
            scan = las.load_streaming(
                source, s._ingest_preview_cb(preview_cb, preview_points),
                max_points=max_points, slab_points=slab_points)
        s.world_offset = scan.world_offset
        s._install_cloud(scan.pos, attrs=scan.attributes)
        return s

    def _ingest_preview_cb(self, preview_cb, preview_points: int):
        """``slab_cb`` for ``las.load_streaming``: a fixed-size subsample of
        the points decoded so far, drawn after every slab."""
        sub = np.zeros((preview_points, 3), np.float32)
        state = {"fill": 0}

        def slab_cb(p, done, total):
            stride = max(1, -(-total // preview_points))
            take = p[::stride]
            k = min(len(take), preview_points - state["fill"])
            if k:
                sub[state["fill"]:state["fill"] + k] = take[:k]
                state["fill"] += k
            pos = torch.from_numpy(sub).to(self.device)
            valid = torch.arange(preview_points,
                                 device=self.device) < state["fill"]
            img = splat.render_frame(
                pos, _height_prop(pos, *scene_bounds(pos, valid)), valid,
                self.camera, self.palette, self.config.render)
            # the host copy of the frame also waits for the frame's reads
            # of ``sub``, which the next slab overwrites
            preview_cb(_u8(img))

        return slab_cb

    @classmethod
    def from_points(cls, pos: np.ndarray, config: Config = DEFAULT_CONFIG,
                    world_offset: np.ndarray | None = None,
                    device: str | torch.device = DEFAULT_DEVICE,
                    capacity: int | None = None, mesh=None) -> "Session":
        """A session on ``device`` (or over ``mesh``) holding the f32[N,3]
        y-up points ``pos``, padded to ``capacity`` rows (a multiple of 1024
        by default); ``world_offset`` f64[3] shifts them to the map frame
        (the inventory's easting and northing)."""
        s = cls(config, device=device, mesh=mesh)
        s._install_cloud(pos, capacity=capacity)
        if world_offset is not None:
            s.world_offset = np.asarray(world_offset, np.float64)
        return s

    def _attach_attributes(self, attrs: dict) -> None:
        """Pad the source attributes to the cloud's capacity, row-aligned
        with it, and drop their cached display properties."""
        cap = self.cloud.capacity
        out = {}
        for k, v in attrs.items():
            a = np.asarray(v)
            padded = np.zeros((cap,) + a.shape[1:], a.dtype)
            padded[: len(a)] = a[:cap]
            out[k] = padded
        self.attributes = out
        self._attr_dev = {}

    def attribute_prop(self, name: str):
        """A source attribute as a display property: ``(prop f32[N] in
        [0, 1] on the device, palette or None)`` for ``render(prop=...,
        palette=...)`` and the focused view.

        Computed on the host in numpy, as the JAX package does, then moved
        to the device once and cached.  ``rgb`` packs the file colour into
        the 3-3-2 cube index (``palettes.rgb_cube``); ``gps_time`` spans the
        f64 range of the valid nonzero rows (merged rows that lack the field
        are zero and fall below it); everything else is divided by its
        maximum, like the reference's u32 lookup (lookup.rs:22-24).  Over a
        mesh the property is the shards' list."""
        if name not in self.attributes:
            avail = ", ".join(sorted(self.attributes)) or "none in this scan"
            raise ValueError(f"no attribute {name!r} (available: {avail})")
        if name not in self._attr_dev:
            a = self.attributes[name]
            pal = None
            if name == "rgb":
                # files with an 8-bit payload store 0-255 in the u16 fields:
                # stretch them so the top-3-bit quantizer sees full scale
                shift = 8 if a.max(initial=0) <= 255 else 0
                a32 = a.astype(np.int32) << shift
                r, g, b = a32[:, 0] >> 13, a32[:, 1] >> 13, a32[:, 2] >> 14
                idx = (r << 5) | (g << 2) | b
                prop = (idx.astype(np.float32) + 0.5) / 256.0
                pal = palettes.rgb_cube(device=self.device)
            elif name == "gps_time":
                # the offset (~3e8 s for adjusted standard time) comes off
                # in f64 before the cast; min/max and the normalisation run
                # in chunks, with no [N]-sized f64 temporaries
                a64 = np.asarray(a, np.float64)
                valid = self._host(self._col("valid"))
                step = 1 << 22
                vlo, vhi = np.inf, -np.inf
                for i in range(0, len(a64), step):
                    c = a64[i:i + step]
                    m = valid[i:i + step] & (c != 0.0)
                    if m.any():
                        sel = c[m]
                        vlo = min(vlo, float(sel.min()))
                        vhi = max(vhi, float(sel.max()))
                if not np.isfinite(vlo):
                    vlo = 0.0
                ext = max(vhi - vlo, 1e-12)
                prop = np.empty(len(a64), np.float32)
                for i in range(0, len(a64), step):
                    prop[i:i + step] = (a64[i:i + step] - vlo) / ext
            else:
                v = a.astype(np.float32)
                ext = max(float(v.max(initial=0.0)), 1e-12)
                prop = v / ext
            self._attr_dev[name] = (self._split(torch.from_numpy(prop)), pal)
        return self._attr_dev[name]

    def add_las(self, source, preview_cb=None,
                preview_points: int = 1 << 20,
                slab_points: int = 4_000_000) -> None:
        """Merge another scan as one new segment, recentred on this
        session's offset (Loading::add, loading.rs:79-88;
        Interactive::add_points, mod.rs:340-371).  ``preview_cb`` streams
        the incoming scan's preview frames, as in :meth:`from_las`."""
        if preview_cb is None:
            scan = las.load(source, center=self.world_offset)
        else:
            scan = las.load_streaming(
                source, self._ingest_preview_cb(preview_cb, preview_points),
                center=self.world_offset, slab_points=slab_points)
        valid = self._host(self._col("valid"))
        data = self.cloud.to_numpy()
        n_new = len(scan.pos)
        pos = np.concatenate([data["pos"], scan.pos])
        seg = np.concatenate(
            [data["segment"], np.full(n_new, self._alloc_id(), np.int32)])
        cls_ = np.concatenate(
            [data["classification"], np.zeros(n_new, np.int32)])
        base_attrs = {k: v[valid] for k, v in self.attributes.items()}
        self._install_cloud(pos, seg, cls_, attrs=ipc.merge_attributes(
            base_attrs, len(data["pos"]), scan.attributes, n_new))
        self._drop_derived()

    def preview_frame(self, camera: Camera | None = None) -> np.ndarray:
        """Height-coloured frame of the raw cloud, before segmentation;
        u8[H,W,3]."""
        cam = camera if camera is not None else self.camera
        pos, valid = self._col("pos"), self._col("valid")
        lo, hi = (sharding.live_bounds(pos, valid) if self.mesh is not None
                  else scene_bounds(pos, valid))
        return _u8(self._frame(pos, self._each(
            lambda p: _height_prop(p, lo, hi), pos), valid, cam, self.palette))

    def _frame(self, pos, prop, mask, cam: Camera,
               palette: torch.Tensor) -> torch.Tensor:
        """``splat.render_frame`` of per-point values (over a mesh
        ``sharding.sharded_render``)."""
        if self.mesh is not None:
            return sharding.sharded_render(self.mesh, self.config)(
                pos, prop, mask, cam, palette)
        return splat.render_frame(pos, prop, mask, cam, palette,
                                  self.config.render)

    def _strided(self, name: str, stride: int) -> torch.Tensor:
        """Every ``stride``-th row of a field, from row 0, on the session's
        device (over a mesh, each shard's rows at those global rows)."""
        x = self._col(name)
        if self.mesh is None:
            return x[::stride].contiguous()
        rows = x[0].shape[0]
        return torch.cat([t[(-k * rows) % stride::stride].to(self.device)
                          for k, t in enumerate(x)])

    def segment(self, max_distance: float | None = None, preview_cb=None,
                preview_stride: int = 64) -> SegmentationResult:
        """Segment the cloud (re-callable with a new distance), then compute
        the segment table and each point's class.

        ``preview_cb(img)``: before the full cloud, every
        ``preview_stride``-th point is segmented and rendered segment-coloured
        with the session's camera, and the callback receives that u8[H,W,3]
        frame (over a mesh on the session's device: the subsample is small).
        Over a mesh the step is ``sharding.sharded_session_step``; the
        result's ``segment`` is then the shards' list.
        """
        with span("Session.segment", self.device):
            if max_distance is not None:
                self.max_distance = max_distance
            if preview_cb is not None:
                sub_pos = self._strided("pos", preview_stride)
                sub_valid = self._strided("valid", preview_stride)
                sub_seg, _, _, _ = full_pipeline(
                    sub_pos, sub_valid, self.max_distance, self.config)
                img = splat.render_frame(
                    sub_pos, splat.prop_from_segment(sub_seg),
                    sub_valid & (sub_seg != DELETED_SEGMENT), self.camera,
                    self.palette, self.config.render)
                preview_cb(_u8(img))
            if self.mesh is not None:
                step = sharding.sharded_session_step(self.mesh, self.config)
                seg, classification, table, res = step(
                    self._col("pos"), self._col("valid"), self.max_distance)
            else:
                seg, classification, table, res = full_pipeline(
                    self.cloud.pos, self.cloud.valid, self.max_distance,
                    self.config)
            self.cloud = self.cloud.replace(segment=seg,
                                            classification=classification)
            self.table = table
            self._bbox_full = False
            self._counts_stale = False
            self._clear_focus()
            self._hag_cache = {}    # ground classification re-derived
            self._next_id = None
            # the subset's colours and membership follow ids
            self._lod = None
            waited("Session.segment.overflow")
            if bool(res.occupied_overflow):
                logging.getLogger(__name__).warning(
                    "segmentation occupied-cell compaction overflowed "
                    "cc_occupied_cap=%d; cluster counts/centroids "
                    "truncated — raise SegmentationConfig.cc_occupied_cap",
                    self.config.segmentation.cc_occupied_cap,
                )
            return res

    def _lod_tree(self):
        """The cached octree, built at first use over ALL valid points,
        deleted ones included: a restored point must find its place.  Over
        a mesh, the shards' octrees (``sharding.sharded_octree``)."""
        if self.mesh is not None:
            if self._tree is None:
                self._tree = sharding.sharded_octree(self.mesh)(
                    self._col("pos"), self._col("valid"))
        elif self._tree is None or self._tree.capacity != self.cloud.capacity:
            self._tree = octree_mod.build(self.cloud.pos, self.cloud.valid)
        return self._tree

    def build_lod(self, level: int = 7, points_per_node: int = 1,
                  capacity: int | None = None,
                  camera: Camera | None = None,
                  adaptive_tau_px: float | None = None) -> None:
        """The LOD subset for ``render(use_lod=True)``, kept as
        ORIGINAL-ORDER INDICES padded to a snug capacity.

        Positions are gathered once here; a frame re-reads the segments and
        the deletion mask through the indices, so an edit needs no
        rebuild.  The octree is cached across edits.  ``camera`` culls the
        nodes outside its view; with ``adaptive_tau_px`` the subset is the
        screen-error cut for that camera in place of the fixed ``level``.
        A deleted representative is masked out per frame; its node hands
        over to a live sibling at the next rebuild.  ``capacity`` defaults
        to ``snug_capacity`` of the subset's true size (one host sync).
        Over a mesh the cut is the shards' (``sharding.sharded_lod_mask`` /
        ``sharded_adaptive_mask``) and the indices their compaction with
        row offsets: the one-device indices.
        """
        if adaptive_tau_px is not None and camera is None:
            raise ValueError("adaptive_tau_px requires a camera")
        cloud, rcfg = self.cloud, self.config.render
        mask = cloud.alive
        tree = self._lod_tree()
        frustum = None
        if camera is not None:
            frustum = camera.frustum_planes(rcfg.width / rcfg.height)
        if self.mesh is not None:
            if adaptive_tau_px is not None:
                lod = sharding.sharded_adaptive_mask(
                    self.mesh, _px_scale(camera, rcfg), adaptive_tau_px)(
                        tree, mask, camera.position, frustum)
            else:
                lod = sharding.sharded_lod_mask(
                    self.mesh, level, points_per_node)(tree, mask, frustum)
            compact = sharding.compact_indices
        else:
            if adaptive_tau_px is not None:
                lod = octree_mod.adaptive_mask(
                    tree, camera.position, _px_scale(camera, rcfg),
                    tau_px=adaptive_tau_px, live=mask, frustum=frustum)
            else:
                lod = octree_mod.lod_mask(tree, level, points_per_node,
                                          live=mask, frustum=frustum)
            compact = octree_mod.compact_indices
        cap = capacity if capacity is not None else min(
            cloud.capacity, octree_mod.snug_capacity(self._count(lod)))
        count, idx = compact(lod, cap)
        self._lod = (self._take(self._col("pos"), idx), idx, count)

    #: candidate screen-error cuts for the auto-tau solver, finest first
    TAU_LADDER = (0.75, 1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0)

    def solve_adaptive_tau(self, budget_rows: int | None = None,
                           match_floor: float | None = None,
                           camera: Camera | None = None) -> float:
        """The screen-error tau for ``build_lod(adaptive_tau_px=...)``.

        - ``budget_rows``: the smallest ladder tau whose cut fits the row
          budget, from one pass over the ladder (``adaptive_counts``; over
          a mesh ``sharding.sharded_adaptive_counts`` on the cached shards'
          octrees); the coarsest tau when none fits.
        - ``match_floor``: the largest ladder tau whose frame matches at
          least this share of the full frame's pixels, by bisecting the
          ladder with real frames; the finest tau when none does.  The
          session's LOD subset is left as it was.
        """
        if (budget_rows is None) == (match_floor is None):
            raise ValueError("pass exactly one of budget_rows / match_floor")
        cam = camera if camera is not None else self.camera
        rcfg = self.config.render
        if budget_rows is not None:
            frustum = cam.frustum_planes(rcfg.width / rcfg.height)
            if self.mesh is not None:
                counts = sharding.sharded_adaptive_counts(
                    self.mesh, _px_scale(cam, rcfg), self.TAU_LADDER)(
                        self._lod_tree(), self.cloud.alive, cam.position,
                        frustum)
            else:
                counts = octree_mod.adaptive_counts(
                    self._lod_tree(), cam.position, _px_scale(cam, rcfg),
                    self.TAU_LADDER, live=self.cloud.alive, frustum=frustum)
            fits = np.nonzero(counts.cpu().numpy() <= budget_rows)[0]
            return (self.TAU_LADDER[int(fits[0])] if len(fits)
                    else self.TAU_LADDER[-1])
        full = self.render(camera=cam)
        lod_state = self._lod
        lo_i, hi_i = 0, len(self.TAU_LADDER) - 1
        best = self.TAU_LADDER[0]
        while lo_i <= hi_i:
            mid = (lo_i + hi_i) // 2
            self.build_lod(camera=cam, adaptive_tau_px=self.TAU_LADDER[mid])
            img = self.render(camera=cam, use_lod=True)
            if float((img == full).all(axis=-1).mean()) >= match_floor:
                best = self.TAU_LADDER[mid]   # good enough: try coarser
                lo_i = mid + 1
            else:
                hi_i = mid - 1
        self._lod = lod_state
        return best

    def render(self, camera: Camera | None = None, prop=None,
               show_deleted: bool = False, use_lod: bool = False,
               palette: torch.Tensor | None = None) -> np.ndarray:
        """Frame, u8[H,W,3]: segment-coloured unless ``prop`` (f32[N] in
        [0,1]; over a mesh also the shards' list) is given; deleted points
        (segment 0) hidden unless ``show_deleted``.  ``use_lod`` draws the
        LOD subset (built at level 7 if absent); with ``show_deleted`` the
        full cloud is drawn, since the subset leaves deleted points out.
        Over a mesh the full frame is ``sharding.sharded_render``."""
        with span("Session.render", self.device):
            cam = camera if camera is not None else self.camera
            pal = (palette if palette is not None
                   else self.palette).to(self.device)
            cloud = self.cloud
            if prop is not None:
                prop = self._split(prop)
            if use_lod and not show_deleted:
                if self._lod is None:
                    self.build_lod()
                pos_c, idx, count = self._lod
                return _u8(_lod_frame(
                    pos_c, self._take(self._col("segment"), idx),
                    self._take(self._col("valid"), idx), count, cam, pal,
                    self.config.render,
                    None if prop is None else self._take(prop, idx)))
            if prop is None:
                prop = self._each(splat.prop_from_segment,
                                  self._col("segment"))
            mask = self._col("valid") if show_deleted else cloud.alive
            return _u8(self._frame(self._col("pos"), prop, mask, cam, pal))

    def characteristics(self) -> ch.SegmentTable:
        """Recompute the table, with full boxes, and the classes of the
        current segments; deleted points keep their classes.  Over a mesh
        through ``sharding.sharded_characteristics``."""
        pos, seg, valid = (self._col(k) for k in ("pos", "segment", "valid"))
        if self.mesh is not None:
            table, classification = sharding.sharded_characteristics(
                self.mesh, self.config)(pos, seg, valid)
        else:
            table, classification = ch.compute_segments(
                pos, seg, valid, self.config.segmentation.max_segments + 1,
                self.config.characteristics)
        self.cloud = self.cloud.replace(classification=self._each(
            lambda v, s, c, old: torch.where(v & (s != DELETED_SEGMENT), c,
                                             old),
            valid, seg, classification, self._col("classification")))
        self.table = table
        self._bbox_full = True
        self._counts_stale = False
        self._clear_focus()
        self._hag_cache = {}    # ground classification re-derived
        return table

    def full_table(self) -> ch.SegmentTable:
        """The table with real x/z bounds: ``segment()`` keeps zero
        placeholders there, so this recomputes the characteristics first
        when needed (calculations.rs:136-147).  After a membership edit
        (spawn, combine, delete, draw) it recomputes too: the table's rows
        would describe the forest before the edit."""
        if self.table is None or not self._bbox_full or self._counts_stale:
            self.characteristics()
        return self.table

    # ---- the focused view ----------------------------------------------------

    def properties(self):
        """Per-point (expansion, height) of the whole cloud, f32[N] each
        (CalculationProperties, on demand).  Over a mesh the columns are
        gathered to the session's device for the one sort over every row,
        and the results come back as the shards' lists."""
        if self.table is None:
            self.characteristics()
        cloud = self.cloud if self.mesh is None else self.cloud.gather()
        exp, hgt = ch.segment_properties(
            cloud.pos, cloud.segment, cloud.valid, cloud.classification,
            self.table, self.config.segmentation.max_segments + 1,
            self.config.characteristics)
        return self._split(exp), self._split(hgt)

    def _member_mask(self, segment_id: int):
        """The full-cloud member mask of a segment (the shards' masks over
        a mesh)."""
        return self._each(lambda v, s: v & (s == segment_id),
                          self._col("valid"), self._col("segment"))

    def _member_and_grid(self, segment_id: int):
        """(member mask or None, member count, use_grid): segments up to
        ``NeighborConfig.brute_force_max`` points take the exact brute
        force, larger ones the grid hash.  The count comes from a host copy
        of the table's counts; while those are stale (no table, or edited
        membership) it is synced once per segment and cached.  The
        full-cloud mask is built only when the count needs it (else None),
        so a cached focused frame makes no pass over the cloud."""
        member = None
        cnt = None
        if self.table is not None and not self._counts_stale:
            if self._counts_np is None:
                waited("focus.counts")
                self._counts_np = self.table.count.cpu().numpy()
            if 0 <= segment_id < len(self._counts_np):
                cnt = int(self._counts_np[segment_id])
        if cnt is None:
            cnt = _lru_get(self._focus_cnt_cache, segment_id)
        if cnt is None:
            member = self._member_mask(segment_id)
            waited("focus.count")
            cnt = self._count(member)
            self._focus_cnt_cache[segment_id] = cnt
            _evict_oldest(self._focus_cnt_cache, 64)
        return member, cnt, cnt > self.config.neighbors.brute_force_max

    def _compact_member(self, segment_id: int, member, cnt: int):
        """(idx, sub_valid): the segment's member rows compacted into a snug
        buffer, cached per segment (over a mesh each shard's rows with its
        row offset, in shard order: the same rows).  The brute-force k-NN
        runs among these rows (a [tile, N] distance tile over the whole
        cloud would not fit), and a focused frame draws them."""
        cached = _lru_get(self._focus_idx_cache, segment_id)
        if cached is not None:
            return cached
        if member is None:
            member = self._member_mask(segment_id)
        cap = min(octree_mod.snug_capacity(max(int(cnt), 1), headroom=1.0),
                  self.cloud.capacity)
        compact = (sharding.compact_indices if self.mesh is not None
                   else octree_mod.compact_indices)
        count, idx = compact(member, cap)
        sub_valid = torch.arange(cap, dtype=torch.int32,
                                 device=idx.device) < count
        self._focus_idx_cache[segment_id] = (idx, sub_valid)
        _evict_oldest(self._focus_idx_cache, 8)
        return idx, sub_valid

    def _focus_rows(self, segment_id: int, member, cnt: int):
        """(idx, segment, member, pos, classification) of the compacted
        member rows, on the session's device; ``member`` masks out the
        padding slots and rows that left the segment."""
        idx, sub_valid = self._compact_member(segment_id, member, cnt)
        seg_sub = self._take(self._col("segment"), idx)
        f_member = (sub_valid & self._take(self._col("valid"), idx)
                    & (seg_sub == segment_id))
        return (idx, seg_sub, f_member, self._take(self._col("pos"), idx),
                self._take(self._col("classification"), idx))

    def segment_rows(self, segment_id: int):
        """A segment's member rows on the session's device, in either mode:
        (pos f32[M,3], classification i32[M], member bool[M]), M a snug
        capacity whose slots past the members ``member`` masks out.  The
        front ends' single-tree axis, RBVs, traits and hull take them."""
        member, cnt, _ = self._member_and_grid(segment_id)
        _, _, f_member, f_pos, f_cls = self._focus_rows(segment_id, member,
                                                        cnt)
        return f_pos, f_cls, f_member

    def _focus_sub(self, kind: str, segment_id: int, member, cnt: int):
        """(sub, idx, sub_valid): the brute-path curvature ("curve") or
        normals ("normals") of the compacted member rows, cached per
        (kind, segment, k) so that repeated focused frames skip the k-NN."""
        k = self.config.characteristics.neighbors
        idx, sub_valid = self._compact_member(segment_id, member, cnt)
        key = (kind, segment_id, k)
        sub = _lru_get(self._focus_prop_cache, key)
        if sub is None:
            fn = (ch.segment_curvature if kind == "curve"
                  else ch.segment_normals)
            sub = fn(self._take(self._col("pos"), idx), sub_valid, k=k,
                     use_grid=False)
            self._focus_prop_cache[key] = sub
            _evict_oldest(self._focus_prop_cache, 16)
        return sub, idx, sub_valid

    def _focus_grid(self, kind: str, segment_id: int, member=None):
        """The grid-path result of a large segment over the whole cloud,
        cached per (kind, segment, k) (at most 2: each is f32[N] or
        f32[N,3]).  The member mask is built only on a miss.  Over a mesh
        the positions and the mask are gathered to the session's device
        for the grid hash, and the result comes back as the shards'
        list."""
        k = self.config.characteristics.neighbors
        key = (kind, segment_id, k)
        hit = _lru_get(self._focus_grid_cache, key)
        if hit is not None:
            return hit
        if member is None:
            member = self._member_mask(segment_id)
        fn = ch.segment_curvature if kind == "curve" else ch.segment_normals
        res = self._split(fn(self._whole(self._col("pos")),
                             self._whole(member), k=k, use_grid=True))
        self._focus_grid_cache[key] = res
        _evict_oldest(self._focus_grid_cache, 2)
        return res

    def _scatter_sub(self, sub: torch.Tensor, idx, sub_valid, fill):
        """``fill`` with the compacted rows' values put back at their cloud
        rows; padding slots drop out."""
        if self.mesh is not None:
            return sharding.put(fill, idx, sub_valid, sub)
        out = torch.cat([fill, fill[:1]])
        out[torch.where(sub_valid, idx, fill.shape[0]).long()] = sub
        return out[:fill.shape[0]]

    def _fill(self, width: int | None, value=0.0):
        """A per-point f32 value of the session's form, ``value`` everywhere
        (``width`` channels, or none)."""
        shape = () if width is None else (width,)
        return self._each(
            lambda v: torch.full((v.shape[0],) + shape, value,
                                 dtype=torch.float32, device=v.device),
            self._col("valid"))

    def curvature(self, segment_id: int):
        """Per-point curvature of a segment, f32[N] (0 off the segment)."""
        member, cnt, use_grid = self._member_and_grid(segment_id)
        if use_grid:
            return self._focus_grid("curve", segment_id, member)
        sub, idx, sub_valid = self._focus_sub("curve", segment_id, member,
                                              cnt)
        return self._scatter_sub(sub, idx, sub_valid, self._fill(None))

    def normals(self, segment_id: int):
        """Per-point unit surface normals of a segment, f32[N,3] (+y off the
        segment): the smallest eigenvector of the curvature neighbourhoods'
        covariance, a capability beyond the reference viewer."""
        member, cnt, use_grid = self._member_and_grid(segment_id)
        if use_grid:
            return self._focus_grid("normals", segment_id, member)
        sub, idx, sub_valid = self._focus_sub("normals", segment_id, member,
                                              cnt)
        up = self._each(lambda f: f.index_fill(1, torch.tensor(
            [1], device=f.device), 1.0), self._fill(3))
        return self._scatter_sub(sub, idx, sub_valid, up)

    def segment_coords(self, segment_id: int):
        """(longitude, latitude) in radians of a segment's box centre through
        the session's proj string (mod.rs:235-243); None where the string
        does not parse."""
        table = self.full_table()
        try:
            return geo.segment_coords(self.world_offset,
                                      table.lo[segment_id].cpu().numpy(),
                                      table.hi[segment_id].cpu().numpy(),
                                      self.source_location)
        except geo.ProjError:
            return None

    def render_focus(self, segment_id: int, camera: Camera | None = None,
                     display: str = "classification", show_hull: bool = False,
                     show_rbv: bool = False, show_axis: bool = False,
                     hull_include: str = "crown",
                     rbv_slices: int | None = None,
                     rbv_sectors: int | None = None, rbv_method: str = "max",
                     rbv_symmetric: bool = False,
                     axis_algo: str = "average") -> np.ndarray:
        """The focused single-tree view (the reference's View mode,
        interactive/mod.rs:770-800), u8[H,W,3]: the segment's points
        coloured by ``display`` (one of ``FOCUS_DISPLAYS`` or a source
        attribute of ``attributes``), with the crown
        hull (``hull_include`` is the class filter, hull.rs:15-67), the RBV
        cage and the trunk axis as optional overlays (the reference's
        widgets, hull.rs:248-285, trunk_axis.rs:267-293).

        A segment on the brute path is drawn from its cached compacted rows,
        so the frame and its overlays cost the segment's size, not the
        cloud's; the scatter-min z-buffer and the overlays' reductions do
        not depend on the rows' order or padding, so the frame equals the
        full cloud's.  A grid-path segment draws from the full cloud (over
        a mesh its columns gathered to the session's device).
        """
        if display not in FOCUS_DISPLAYS and display not in self.attributes:
            raise ValueError(f"unknown display {display!r}")
        dev = self.device
        rcfg = self.config.render
        with span("Session.render_focus", dev):
            kimg, cam, pal, rows_ready, f_pos, f_member, f_cls = (
                self._focus_keys(segment_id, camera, display))
            ep = None
            if show_hull or show_rbv or show_axis:
                # the overlays take no curvature: on a card they run on a
                # second stream while the first computes it
                with self._beside(rows_ready) as main:
                    # each overlay's lines, drawn in one pass: they share
                    # their colour, and each line's pixels depend on the
                    # splat's depth alone
                    host_lines, dev_lines = [], []
                    tf = None
                    if show_rbv or show_axis:
                        with span("focus.axis", dev):
                            axis_fn = (trunk_axis.low_high_layer
                                       if axis_algo == "lowhigh"
                                       else trunk_axis.average_direction)
                            axis = axis_fn(f_pos,
                                           f_member & (f_cls == CLASS_TRUNK))
                            tf = trunk_axis.axis_transform(axis)
                            if show_axis:
                                waited("focus.axis.found")
                                if bool(axis.found):
                                    y = f_pos[:, 1]
                                    extent = (
                                        torch.where(f_member, y, -3e38).amax()
                                        - torch.where(f_member, y,
                                                      3e38).amin())
                                    dev_lines.append(
                                        trunk_axis.axis_lines(axis, extent))
                    if show_hull:
                        with span("focus.hull", dev):
                            h = hull3d.convex_hull(f_pos, f_member & (
                                include_mask(f_cls, hull_include)))
                            if h is not None:
                                host_lines.append(
                                    h.vertices[hull3d.hull_edges(h.faces)])
                    if show_rbv:
                        with span("focus.rbv", dev):
                            kw = dict(transform=tf, symmetric=rbv_symmetric,
                                      method=(rbv_mod.METHOD_MEAN
                                              if rbv_method == "mean"
                                              else rbv_mod.METHOD_MAX))
                            if rbv_slices is not None:
                                kw.update(crown_slices=rbv_slices,
                                          trunk_slices=rbv_slices)
                            if rbv_sectors is not None:
                                kw.update(crown_sectors=rbv_sectors,
                                          trunk_sectors=rbv_sectors)
                            crown, trunk = rbv_mod.split_rbv(
                                f_pos, f_cls, f_member, **kw)
                            host_lines += [rbv_mod.rbv_lines(crown),
                                           rbv_mod.rbv_lines(trunk)]
                    host_lines = [e for e in host_lines if len(e)]
                    if host_lines:
                        waited("focus.lines")        # a copy to the device
                        dev_lines.insert(0, torch.as_tensor(
                            np.concatenate(host_lines), device=dev))
                    if dev_lines:
                        ep = torch.cat(dev_lines)
                        if main is not None:
                            ep.record_stream(main)
            color, z01, _ = splat.resolve_keys(kimg, cam, pal, rcfg)
            if ep is not None:
                with span("focus.lines", dev):
                    color = lines.overlay(color, z01, ep, cam, rcfg)
            return _u8(splat.eye_dome(color, z01, rcfg))

    @contextlib.contextmanager
    def _beside(self, ready):
        """Run the block on the session's second stream of its card, from
        ``ready`` (an event of the current stream) on, and have the current
        stream wait for the block's work; yields the current stream.  With
        no event (on the CPU) the block runs as it is and yields None."""
        if ready is None:
            yield None
            return
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_event(ready)
        with torch.cuda.stream(self._side):
            yield main
        main.wait_stream(self._side)

    def _focus_keys(self, segment_id: int, camera: Camera | None,
                    display: str):
        """The focused view's splat pass up to its key image: (keys
        i32[H,W], camera, palette, an event of the current stream once the
        rows are gathered (None off a card), and the pos, member and
        classification of the rows drawn), in spans ``focus.rows`` and
        ``focus.property``."""
        cam = camera if camera is not None else self.camera
        pal = self.palette
        if display in ("expansion", "height") and self.table is None:
            # before any gather: characteristics() replaces the classes,
            # which the expansion's crown filter and the overlays read
            self.characteristics()
        with span("focus.rows", self.device):
            member, cnt, use_grid = self._member_and_grid(segment_id)
            if use_grid:
                if member is None:
                    member = self._member_mask(segment_id)
                f_pos = self._whole(self._col("pos"))
                f_member = self._whole(member)
                f_cls = self._whole(self._col("classification"))

                def rows(x):
                    return self._whole(x)
            else:
                idx, seg_sub, f_member, f_pos, f_cls = self._focus_rows(
                    segment_id, member, cnt)

                def rows(x):
                    return self._take(x, idx)
            rows_ready = None
            if f_pos.is_cuda:
                rows_ready = torch.cuda.Event()
                rows_ready.record(torch.cuda.current_stream(self.device))

        with span("focus.property", self.device):
            if display in self.attributes:
                # the cached full-cloud property; rgb brings its own palette
                prop, pal_over = self.attribute_prop(display)
                if pal_over is not None:
                    pal = pal_over
                f_prop = rows(prop)
            elif display == "hag":
                f_prop = rows(self.hag_prop())  # the cached full property
            elif display == "classification":
                # Ground, Trunk, Crown -> 1/8, 3/8, 6/8 of the palette
                # (mod.rs:1031-1039)
                f_prop = torch.tensor([1 / 8, 3 / 8, 6 / 8],
                                      dtype=torch.float32,
                                      device=self.device)[f_cls.long()]
            elif display in ("expansion", "height"):
                if use_grid:
                    exp, hgt = (self._whole(x) for x in self.properties())
                else:
                    # the slice areas are segment-local and the rows hold
                    # all of the segment's points, so member rows get the
                    # values of the full cloud's run
                    exp, hgt = ch.segment_properties(
                        f_pos, seg_sub, f_member, f_cls, self.table,
                        self.config.segmentation.max_segments + 1,
                        self.config.characteristics)
                f_prop = exp if display == "expansion" else hgt
                if display == "expansion":
                    f_prop = torch.div(f_prop, torch.clamp(
                        torch.where(f_member, f_prop, 0.0).amax(), min=1e-6))
            elif display == "curve":
                f_prop = (self._whole(self.curvature(segment_id)) if use_grid
                          else self._focus_sub("curve", segment_id, member,
                                               cnt)[0])
            else:   # shaded: Lambert brightness from the k-NN normals
                nrm = (self._whole(self.normals(segment_id)) if use_grid
                       else self._focus_sub("normals", segment_id, member,
                                            cnt)[0])
                light = torch.tensor(SHADE_LIGHT, dtype=torch.float32,
                                     device=self.device)
                lam = nrm * light
                lam = torch.clamp((lam[:, 0] + lam[:, 1]) + lam[:, 2],
                                  min=0.0)
                f_prop = 0.15 + 0.85 * lam
        kimg = splat.rasterize_keys(f_pos, f_prop, f_member, cam,
                                    self.config.render)
        return kimg, cam, pal, rows_ready, f_pos, f_member, f_cls

    def inventory(self, method: str = "max", symmetric: bool = False,
                  crown_slices: int = 26, crown_sectors: int = 32,
                  trunk_slices: int = 5, trunk_sectors: int = 32,
                  axis_algo: str = "average") -> dict[str, np.ndarray]:
        """Whole-forest per-tree inventory: every segment's trunk axis, split
        RBVs and forestry traits in one batched pass on the device (over a
        mesh ``sharding.sharded_inventory``).

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
        method = (rbv_mod.METHOD_MEAN if method == "mean"
                  else rbv_mod.METHOD_MAX)
        rbv_kw = dict(crown_slices=crown_slices, crown_sectors=crown_sectors,
                      trunk_slices=trunk_slices, trunk_sectors=trunk_sectors)
        cols = [self._col(k)
                for k in ("pos", "segment", "classification", "valid")]
        if self.mesh is not None:
            tr, counts, found, origin = sharding.sharded_inventory(
                self.mesh, self.config, method, symmetric, axis_algo,
                **rbv_kw)(*cols)
        else:
            tr, counts, found, origin = run_alone(rbv_mod.inventory_shard(
                *cols, n_seg, method, symmetric, axis_algo, rbv_kw,
                across=False))
        cnts = counts.cpu().numpy()

        present = table.present.cpu().numpy()
        total = cnts.sum(axis=1)
        ids = np.flatnonzero(present & (total > 0)
                             & (np.arange(n_seg) != DELETED_SEGMENT))
        lo, hi = table.lo.cpu().numpy(), table.hi.cpu().numpy()
        cx = (lo[ids, 0] + hi[ids, 0]) / 2.0
        cz = (lo[ids, 2] + hi[ids, 2]) / 2.0
        found = found.cpu().numpy()[ids]
        origin = origin.cpu().numpy()[ids]
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

    def forest_summary(self, inventory: dict | None = None,
                       chm_cell: float = 0.5,
                       cover_threshold: float = 2.0) -> dict:
        """Stand-level aggregates from the per-tree inventory and the CHM:
        stems/ha, basal area/ha, canopy cover, quadratic mean diameter.

        A "tree" is a segment with trunk-classified points; ``area_ha`` is
        the live points' bounding rectangle (an approximation for irregular
        stands).  Canopy cover is the share of CHM cells at least
        ``cover_threshold`` m above the hole-filled DTM."""
        inv = inventory if inventory is not None else self.inventory()
        _, lo, hi = self._live_bounds()
        area_m2 = float(hi[0] - lo[0]) * float(hi[2] - lo[2])
        area_ha = max(area_m2 / 1e4, 1e-12)

        tree = inv["n_trunk"] > 0
        n_trees = int(tree.sum())
        dbh = inv["diameter_breast_height"][tree]
        heights = inv["tree_height"][tree]
        basal = float(inv["trunk_cross_area"][tree].sum())

        grids, _, _ = self.rasters(chm_cell)
        chm = grids["chm"]
        valid_cells = chm != rs.NODATA
        cover = (float((chm[valid_cells] >= cover_threshold).mean())
                 if valid_cells.any() else 0.0)

        return {
            "n_trees": n_trees,
            "area_ha": area_ha,
            "stems_per_ha": n_trees / area_ha,
            "mean_dbh": float(dbh.mean()) if n_trees else 0.0,
            # quadratic mean diameter: the DBH of the tree of mean basal area
            "quadratic_mean_dbh": (
                float(np.sqrt((dbh**2).mean())) if n_trees else 0.0),
            "mean_height": float(heights.mean()) if n_trees else 0.0,
            "max_height": float(heights.max()) if n_trees else 0.0,
            "basal_area_per_ha": basal / area_ha,
            "canopy_cover": cover,
            "total_crown_volume": float(inv["crown_volume"][tree].sum()),
            "total_stem_volume": float(inv["stem_volume"][tree].sum()),
            "total_wood_volume": float(inv["wood_volume"][tree].sum()),
        }

    # ---- rasters -----------------------------------------------------------

    def _live_bounds(self) -> tuple[object, np.ndarray, np.ndarray]:
        """(live mask, lo, hi): the live points (the shards' masks over a
        mesh) and their bounds on the host (the unit box when no point is
        live)."""
        live = self.cloud.alive
        if self.mesh is not None:
            lo, hi = sharding.live_bounds(self._col("pos"), live)
        else:
            lo, hi = scene_bounds(self.cloud.pos, live)
        return live, lo.cpu().numpy(), hi.cpu().numpy()

    def _raster_grids(self, lo, hi, cell: float, cap: int = 4096,
                     y_offset: float = 0.0):
        """``rasters.compute_rasters`` of the live points over the box
        ``lo``-``hi`` (over a mesh ``sharding.sharded_rasters``, bit-equal):
        (grids dict of host arrays, (rows, cols), cell)."""
        cols = (self._col("pos"), self._col("classification"),
                self.cloud.alive)
        if self.mesh is not None:
            return sharding.sharded_rasters(self.mesh, *cols, lo, hi, cell,
                                            cap=cap, y_offset=y_offset)
        return rs.compute_rasters(*cols, lo, hi, cell, cap=cap,
                                  y_offset=y_offset)

    def rasters(self, cell: float = 0.5, cap: int = 4096):
        """DTM / DSM / CHM height rasters over the live cloud
        (:func:`rasters.compute_rasters`).  Returns (grids dict of host
        arrays, (xll, yll) LAS map corner, cell)."""
        _, lo, hi = self._live_bounds()
        grids, (rows, _), cell = self._raster_grids(
            lo, hi, cell, cap=cap, y_offset=float(self.world_offset[1]))
        # lower-left corner in LAS map coords: easting = x + off_x, northing
        # = -(z + off_z), so yll comes from the GRID's max-z edge, not the
        # point bounds' (the grid over-covers by up to one cell)
        xll = float(lo[0]) + float(self.world_offset[0])
        yll = -(float(lo[2]) + rows * cell) - float(self.world_offset[2])
        return grids, (xll, yll), cell

    def height_above_ground(self, cell: float = 1.0, cap: int = 4096):
        """Per-point height above the hole-filled DTM, f32[N] on the
        session's device (:func:`rasters.height_above_ground`; over a mesh
        the shards' list, ``sharding.sharded_height_above_ground``)."""
        live, lo, hi = self._live_bounds()
        pos, cls_ = self._col("pos"), self._col("classification")
        if self.mesh is not None:
            return sharding.sharded_height_above_ground(
                self.mesh, pos, cls_, live, lo, hi, cell, cap=cap)
        (rows, cols), shape, cell = rs.grid_dims(lo, hi, cell, cap=cap)
        return rs.height_above_ground(
            pos, cls_, live, full(lo[0], pos), full(lo[2], pos),
            full(1.0 / cell, pos), shape, (rows, cols))

    def hag_prop(self, cell: float = 1.0):
        """The height above ground divided by its maximum (at least 1e-6),
        f32[N] in [0, 1] for ``render(prop=...)`` and the ``hag`` focus
        display; cached per cell size until an edit or a re-segmentation."""
        if cell not in self._hag_cache:
            hag = self.height_above_ground(cell)
            top = (sharding.all_max([h.amax() for h in hag])
                   if self.mesh is not None else hag.amax())
            self._hag_cache[cell] = self._each(
                lambda h, m: torch.div(h, torch.clamp(m, min=1e-6)), hag, top)
        return self._hag_cache[cell]

    def export_raster(self, path, which: str = "chm", cell: float = 0.5,
                      cap: int = 4096) -> tuple[int, int]:
        """Write one raster as an ESRI ASCII grid; returns (rows, cols)."""
        grids, (xll, yll), cell = self.rasters(cell, cap=cap)
        if which not in grids:
            raise ValueError(f"unknown raster {which!r} (dtm|dsm|chm)")
        with open(path, "w") as fh:
            exports.save_ascii_grid(fh, grids[which], xll, yll, cell)
        return grids[which].shape

    # ---- point exports -----------------------------------------------------

    def _export_keep(self, segment_id: int | None, include: str):
        """The rows an export writes: the live points, or one segment's,
        through the ``include`` class filter (the shards' masks over a
        mesh)."""
        member = (self.cloud.alive if segment_id is None
                  else self._member_mask(segment_id))
        return self._each(lambda m, c: m & include_mask(c, include), member,
                          self._col("classification"))

    def _kept(self, keep, *cols) -> list[np.ndarray]:
        """The kept rows of per-point values on the host, in row order;
        only those rows leave the device."""
        if self.mesh is None:
            rows = torch.nonzero(keep).flatten()
            return [c[rows].cpu().numpy() for c in cols]
        rows = [torch.nonzero(k).flatten() for k in keep]
        return [np.concatenate([x[r].cpu().numpy() for x, r in zip(c, rows)])
                for c in cols]

    def export_points_ply(self, path, segment_id: int | None = None,
                          include: str = "all") -> int:
        """Write a .ply of the points with their expansion, height and
        curvature, optionally one segment's and/or one class's (the focused
        view's Crown/Trunk/Ground export buttons, mod.rs:629-660,
        1069-1107); returns the number of points written.  Curvature is
        the k-NN value: exact for one segment, through the grid hash over
        the whole live cloud otherwise (over a mesh on the gathered
        columns).  The rows are selected on the device and only they are
        copied to the host."""
        exp, hgt = self.properties()
        if segment_id is not None:
            curve = self.curvature(segment_id)
        else:
            curve = self._split(ch.segment_curvature(
                self._whole(self._col("pos")), self._whole(self.cloud.alive),
                k=self.config.characteristics.neighbors, use_grid=True))
        pos, e, h, c = self._kept(self._export_keep(segment_id, include),
                                  self._col("pos"), exp, hgt, curve)
        with open(path, "w") as fh:
            exports.save_points_ply(fh, pos, e, h, c)
        return int(pos.shape[0])

    #: ASPRS classification codes of export_las: ground, trunk as medium
    #: vegetation, crown as high vegetation
    _ASPRS_BY_CLASS = {0: 2, 1: 4, 2: 5}

    def export_las(self, path: str, segment_id: int | None = None,
                   include: str = "all") -> int:
        """Write the live (edited) cloud as a LAS 1.4 file of point format 6,
        or 7 when the scan carried RGB; a ``.laz`` path compresses through
        the native codec.  Each point carries its ASPRS class
        (``_ASPRS_BY_CLASS``), its segment id in ``point_source_id`` and the
        scan's intensity, GPS time and RGB; positions return to the source
        frame through the header offset.  ``segment_id`` / ``include``
        filter as in :meth:`export_points_ply`.  Returns the number of
        points written."""
        keep_dev = self._export_keep(segment_id, include)
        pos, cls, seg = self._kept(keep_dev, self._col("pos"),
                                   self._col("classification"),
                                   self._col("segment"))
        n = int(pos.shape[0])
        if n == 0:
            raise ValueError("export_las: no points match the filter")
        # the attributes live on the host, row-aligned with the cloud
        keep = self._host(keep_dev)

        fmt = 7 if "rgb" in self.attributes else 6
        rec = np.zeros((n, las.POINT_LENGTHS[fmt]), np.uint8)
        if "intensity" in self.attributes:
            inten = self.attributes["intensity"][keep].astype("<u2")
            rec[:, 12:14] = inten.view(np.uint8).reshape(n, 2)
        rec[:, 14] = 0x11  # return 1 of 1
        asprs = np.full(n, 1, np.uint8)  # unclassified fallback
        for cval, code in self._ASPRS_BY_CLASS.items():
            asprs[cls == cval] = code
        rec[:, 16] = asprs
        psid = np.minimum(seg, 0xFFFF).astype("<u2")
        rec[:, 20:22] = psid.view(np.uint8).reshape(n, 2)
        if "gps_time" in self.attributes:
            t = self.attributes["gps_time"][keep].astype("<f8")
            rec[:, 22:30] = t.view(np.uint8).reshape(n, 8)
        if fmt == 7:
            rgb = self.attributes["rgb"][keep].astype("<u2")
            rec[:, 30:36] = rgb.view(np.uint8).reshape(n, 6)

        # world_offset is in the y-up frame; the writer swizzles positions
        # back to LAS (x, -z, y), so the header shift follows suit
        wo = self.world_offset
        las_off = np.array([wo[0], -wo[2], wo[1]], np.float64)
        writer = (las.write_laz if path.lower().endswith(".laz")
                  else las.write_las)
        writer(path, pos, point_format=fmt, records=rec, las_offset=las_off)
        return n

    # ---- edits -------------------------------------------------------------

    def _alloc_id(self) -> int:
        if self._next_id is None:
            top = self._each(lambda s: s.max(), self._col("segment"))
            if isinstance(top, list):
                top = sharding.all_max(top)[0]
            self._next_id = int(top) + 1
        nid = self._next_id
        self._next_id += 1
        return nid

    def _edit(self, fn, *args) -> None:
        """An elementwise edit of ``interactive`` on the cloud (on each
        shard over a mesh: no value crosses the shards)."""
        if self.mesh is not None:
            self.cloud = self.cloud.map(fn, *args)
        else:
            self.cloud = fn(self.cloud, *args)

    def _mark_edited(self) -> None:
        """Segment membership changed: the table's rows no longer describe
        the cloud, so ``full_table()`` must recompute, and the focused
        view's routing must not trust the table's counts (a combine() that
        folds a large segment into a small id would otherwise send it to
        the O(N^2) brute force).  The live set may have changed, and with
        it the DTM, so the height-above-ground cache goes too."""
        self._counts_stale = True
        self._clear_focus()
        self._hag_cache = {}

    def _radius(self, radius) -> float:
        return (radius if radius is not None
                else self.config.interactive.draw_radius)

    def delete_sphere(self, center, radius=None) -> None:
        """Delete every alive point within ``radius`` of ``center``."""
        self._edit(edit.remove_points, center, self._radius(radius),
                   DELETED_SEGMENT)
        self._mark_edited()

    def draw_sphere(self, center, target: int, radius=None,
                    include_deleted: bool = False) -> None:
        """Move every alive point in the sphere to segment ``target``, and
        the deleted ones too with ``include_deleted``."""
        r = self._radius(radius)
        self._edit(edit.remove_points, center, r, target)
        if include_deleted:
            self._edit(edit.restore_deleted, center, r, target)
        self._mark_edited()

    def reclassify_sphere(self, center, classification: int, segment: int,
                          radius=None) -> None:
        """Reclassify the segment's points in the sphere, then re-derive the
        segment's separators from its classes, as the reference does after
        every stroke (mod.rs:182-221)."""
        self._edit(edit.change_classification, center, self._radius(radius),
                   classification, segment)
        self._clear_focus()
        self._hag_cache = {}    # ground membership drives the DTM
        if self.table is not None:
            self.update_separators_from_classes(segment)

    def update_separators_from_classes(self, segment_id: int) -> None:
        """Refresh one segment's separators and heights from its (edited)
        classes (SegmentData::changed, mod.rs:199-221); over a mesh from the
        segment's compacted member rows (min, max and a count: the same
        values)."""
        if self.table is None:
            self.characteristics()
            return
        if self.mesh is not None:
            pos, cls_, member = self.segment_rows(segment_id)
            seg = torch.full_like(cls_, segment_id)
        else:
            cloud = self.cloud
            pos, seg, member, cls_ = (cloud.pos, cloud.segment, cloud.valid,
                                      cloud.classification)
        self.table = ch.update_separators_from_classes(
            pos, seg, member, cls_, self.table, segment_id)
        self._counts_np = None

    def combine(self, a: int, b: int) -> None:
        """Merge segment ``a`` into ``b``."""
        self._edit(edit.combine_segments, a, b)
        self._mark_edited()

    def spawn(self, center, radius=None) -> int:
        """A new segment of the alive points in the sphere; returns its id."""
        nid = self._alloc_id()
        self._edit(edit.spawn_segment, center, self._radius(radius), nid)
        self._mark_edited()
        return nid

    def pick(self, pixel_x: float, pixel_y: float,
             include_deleted: bool = False) -> tuple[int, float, bool]:
        """Ray-pick through a pixel of the session's camera -> (segment id,
        distance along the ray, hit).  ``include_deleted`` makes deleted
        points targetable (the reference's show_deleted brush).  Over a
        mesh ``sharding.sharded_pick``: the same winner."""
        rcfg = self.config.render
        cam = self.camera
        direction = cam.ray_direction(pixel_x, pixel_y, rcfg.width,
                                      rcfg.height)
        if self.mesh is not None:
            seg, dist, found = sharding.sharded_pick(
                self.mesh, include_deleted)(self.cloud, cam.position,
                                            direction, rcfg.point_size)
        else:
            seg, dist, found = edit.pick(self.cloud, cam.position, direction,
                                         rcfg.point_size,
                                         include_deleted=include_deleted)
        return int(seg), float(dist), bool(found)

    # ---- persistence -------------------------------------------------------

    def _table_info(self) -> dict:
        """The reference's SegmentInformation per present segment (trunk
        and crown heights, ground and crown separators), from the table."""
        t = self.table
        cols = [c.cpu().numpy() for c in
                (t.trunk_height, t.crown_height, t.ground_sep, t.crown_sep)]
        present = t.present.cpu().numpy()
        return {int(s): tuple(float(c[s]) for c in cols)
                for s in np.nonzero(present)[0]}

    def save(self, path, segment_id: int | None = None) -> None:
        """Checkpoint the session as ``.ipc`` (the reference's format) or
        ``.npz``; ``segment_id`` saves that segment alone (the focused
        view's "Segment" export, mod.rs:655-668), which opens and merges
        like any checkpoint."""
        valid = self._host(self._col("valid"))
        info = None
        if self.table is not None and str(path).lower().endswith(".ipc"):
            # so that the reference's focused-view sliders open filled in
            info = self._table_info()
        if segment_id is None:
            ipc.save(path, self.cloud, self.world_offset,
                     self.source_location,
                     attributes={k: v[valid]
                                 for k, v in self.attributes.items()},
                     info=info)
            return
        member = self._member_mask(segment_id)
        pos, seg, cls_ = self._kept(member, self._col("pos"),
                                    self._col("segment"),
                                    self._col("classification"))
        sub = PointCloud.from_numpy(pos, segment=seg, classification=cls_,
                                    device="cpu")
        keep = self._host(member)
        ipc.save(path, sub, self.world_offset, self.source_location,
                 attributes={k: v[keep] for k, v in self.attributes.items()},
                 info=info)

    @classmethod
    def open(cls, path, config: Config = DEFAULT_CONFIG,
             device: str | torch.device = DEFAULT_DEVICE,
             mesh=None) -> "Session":
        """A session on ``device`` (or over ``mesh``) from a checkpoint
        (``.ipc`` or ``.npz``)."""
        arrays, offset, loc = ipc.load(path)
        s = cls(config, device=device, mesh=mesh)
        s.world_offset = offset
        s.source_location = loc
        s._install_cloud(
            arrays["pos"], arrays["segment"], arrays["classification"],
            attrs={k[len("attr_"):]: v for k, v in arrays.items()
                   if k.startswith("attr_")})
        return s

    def add_session(self, path) -> None:
        """Merge another checkpoint into this one (mod.rs:300-338): its
        points are recentred on this session's offset and its segments
        renumbered past this session's (``ipc.merge``)."""
        arrays, offset, _ = ipc.load(path)
        valid = self._host(self._col("valid"))
        base = self.cloud.to_numpy()
        for k, v in self.attributes.items():
            base[f"attr_{k}"] = v[valid]
        merged = ipc.merge(base, self.world_offset, arrays, offset)
        self._install_cloud(
            merged["pos"], merged["segment"], merged["classification"],
            attrs={k[len("attr_"):]: v for k, v in merged.items()
                   if k.startswith("attr_")})
        self._drop_derived()
