"""Configuration of the PyTorch port.

The same frozen dataclasses as ``treee_tpu/config.py``, with the same field
names and defaults, minus the fields that only choose between TPU and XLA
implementations.  The port runs the algorithm the TPU runs by default (CC
sweep kernel to the fixpoint, sorted cluster extraction, match kernel,
brute-force Voronoi, segmented-cummax kernel), and keeps the JAX package's
choice of Voronoi:

- ``use_bruteforce_voronoi=True`` (the default): the exact nearest tracked
  centroid at the occupied cells, through the ``nearest_slot`` kernel on a
  CUDA tensor (``voronoi_chunk`` is its plain version's).
- ``use_bruteforce_voronoi=False, use_packed_jfa=False``: the unpacked
  jump flood, through the ``jump_flood`` kernel on a CUDA tensor.  This is
  what the JAX package computes with ``use_pallas=True`` (its Pallas jump
  flood), or with ``use_pallas=False, use_packed_jfa=False``.
- ``use_bruteforce_voronoi=False, use_packed_jfa=True``: the packed jump
  flood (seed positions on an s/64 lattice in one i32 plane), for grids up
  to 512; the JAX package has no kernel for it, so it is plain torch on
  every device.  Above 512 the unpacked flood runs, as in JAX.

Fields left out, and why:

- ``use_pallas``, ``use_pallas_cc``, ``use_pallas_match``,
  ``use_pallas_scan``, ``pallas_scan_block``: on a CUDA tensor the kernel
  always runs; on a CPU tensor its plain PyTorch version does.
- ``use_sorted_extract``: the sorted extraction is the only one.
- ``cc_iters``, ``cc_pallas_bodies``: CC runs until its labels stop changing,
  so neither bound applies.
- ``score_chunk``: the support scans run unchunked (peak memory at 15M
  points is a few GB of the card's 80 GB).
- ``RenderConfig.use_pallas``: the splat dilation and eye-dome kernels
  always run on a CUDA tensor, their plain versions on a CPU tensor.
- ``RenderConfig.raster_tile``: nothing in the JAX package reads it.

``cc_pallas_sweeps`` is called ``cc_sweeps`` here, with the same meaning.
``NeighborConfig`` and ``InteractiveConfig`` carry the JAX package's
defaults: the focused view routes a segment by ``brute_force_max``, and
the brute force's plain (CPU) version tiles its queries by ``query_tile``
(the card's kernel stages as shared memory allows); ``source_location`` is the
session's proj string and ``draw_radius`` the edits' default radius.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Tree segmentation parameters (treee/src/segmenting.rs)."""

    max_distance: float = 0.75          # segmenting.rs:16 DEFAULT_MAX_DISTANCE
    band_height: float = 1.0            # loading.rs:98-101 1m y-slices
    min_area_factor: float = 0.25       # segmenting.rs:472 (kept for parity)
    match_radius_factor: float = 2.0    # segmenting.rs:499 match within 2*d
    min_points: int = 4                 # clusters with fewer points are dropped
    # --- static capacities ---
    max_bands: int = 64                 # height bands (64 m of canopy)
    max_trees_per_band: int = 256       # clusters kept per band
    max_segments: int = 2048            # tracked segment slots in a scene
    # CC occupancy grid cells per axis; above 480 the CC kernel's band rows
    # no longer fit in its cluster's shared memory and it runs slower
    grid_size: int = 384
    # compacted occupied-cell capacity for the CC pointer jumps, cluster
    # aggregation and the Voronoi; cells beyond it set occupied_overflow
    cc_occupied_cap: int = 1 << 19
    match_rounds: int = 4               # mutual-nearest matching rounds per band
    use_packed_jfa: bool = True         # packed jump flood (when not brute force)
    use_bruteforce_voronoi: bool = True  # exact Voronoi at occupied cells
    voronoi_chunk: int = 256            # slots per running-min chunk (plain)
    cc_sweeps: int = 64                 # min-pool sweeps per CC body


@dataclasses.dataclass(frozen=True)
class CharacteristicsConfig:
    """Per-segment characteristics parameters (treee/src/calculations.rs)."""

    slice_width: float = 0.1            # calculations.rs:17 SLICE_WIDTH
    ground_max_search_height: float = 1.0   # calculations.rs:204
    ground_min_area_scale: float = 1.5      # calculations.rs:205
    min_crown_diameter: float = 2.0         # calculations.rs:206
    neighbors: int = 31                 # calculations.rs:279 (curvature k)
    min_area_floor: float = 0.5         # calculations.rs:227 `.max(0.5)`
    max_slices: int = 384               # 38.4 m of tree at 0.1 m slices
    hull_directions: int = 8            # support directions of the slice hulls


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Grid-hash k-NN parameters (replaces the k-nearest KD-tree crate)."""

    k: int = 31
    # candidate cap per neighboring cell; 27 cells * cap = candidate pool
    cell_capacity: int = 16
    # brute-force threshold: segments smaller than this use exact tiled
    # brute force (the JAX package's value, tuned on its TPU)
    brute_force_max: int = 131072
    query_tile: int = 1024              # queries a plain brute-force tile


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Splat renderer parameters (render/src/*.wgsl semantics)."""

    width: int = 1280
    height: int = 720
    fov_y: float = 45.0 * math.tau / 360.0  # camera.rs:7
    near: float = 0.1                   # camera.rs:24
    far: float = 10_000.0               # camera.rs:25
    point_size: float = 0.1             # program.rs:156 (view-space splat radius)
    background: tuple[float, float, float] = (0.3, 0.5, 0.7)  # program.rs:200
    eye_dome_strength: float = 0.7      # program.rs:160
    eye_dome_color: tuple[float, float, float] = (0.0, 0.0, 0.0)  # eye_dome.rs:93
    palette: str = "turbo"              # program.rs:174
    # splat dilation passes: max splat footprint half-extent in pixels
    max_splat_radius: int = 3
    # property range filter (point_cloud.wgsl:44-49); u32 range semantics
    prop_min: int = 0
    prop_max: int = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class InteractiveConfig:
    """Interactive editing parameters (treee/src/interactive/mod.rs)."""

    draw_radius: float = 0.5            # mod.rs:259
    # default proj string (UTM zone 32, Europe) mod.rs:53
    source_location: str = "+proj=utm\n+ellps=GRS80\n+zone=32"


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level configuration of the port."""

    segmentation: SegmentationConfig = dataclasses.field(
        default_factory=SegmentationConfig)
    characteristics: CharacteristicsConfig = dataclasses.field(
        default_factory=CharacteristicsConfig)
    neighbors: NeighborConfig = dataclasses.field(
        default_factory=NeighborConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    interactive: InteractiveConfig = dataclasses.field(
        default_factory=InteractiveConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()
