#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``treee_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; it exits non-zero without them.
Phases, each of which raises on failure:

0. The device: the card's name and power limit, the toolchain, the build
   of the port's CUDA kernels (the eight TPU kernels', the rasters' grid
   flood, the step's Voronoi and the focused view's k-NN) from ``treee_tpu_torch/ops/kernels/csrc``
   (into ``build/treee_tpu_torch/``).
1-7. Each kernel of a path on the card at the shapes its path gives it (its
   inputs are recorded from one run of the main path, one ``Session.render``,
   both inventory forms and one flood-fill segmentation on the 15M-point
   scan; for ``cc_sweep``, each of the step's bodies),
   held bit for bit against its plain PyTorch version on the same inputs,
   with both times from CUDA events and the least time the card could take
   for the same work (its bound).  The two segmented scans also take, at
   their widest recorded value, one run that spans all 15M rows and keys
   that are all distinct.  The frame's two kernels (phases 4, 5) also give
   their device time a call (``torch.profiler``) beside the CUDA-event time
   through the wrapper; the dilation also takes a 720p key image with a
   splat on every pixel at r=3 and r=8 (three launches), and logs the share
   of its tiles that each exact shortcut took.
7b. The step's occupied-cell Voronoi, ``nearest_slot`` (no TPU kernel: the
   JAX package runs XLA ops there), the same way at the main path's
   recorded call, with its device time a call from calls queued back to
   back.
7c. The focused view's exact k-NN, ``knn_select`` (no TPU kernel: the JAX
   package selects with ``lax.top_k``), the same way at the recorded call
   of the largest tree's curvature and at a 40,000-point tree snug in
   40,960 rows (k = 31), where one call must count one launch.
8. The main path as a user drives it: ``Session.from_points(...).segment()``
   and ``.table``, then ``octree.build_keys``, on the 15M-point synthetic
   forest that ``bench.py`` times (937 trees of 12,000 points, 7 m apart,
   seed 0).  The kernels' launch counters are zeroed just before and read
   just after; every kernel of the path must have run.  The same path with
   the plain versions swapped in, and every repeated kernel run, must give
   every point the same segment id.  For each ``cc_sweep`` call of the run,
   how many sweeps each band took to stop changing (the plain version, one
   sweep at a time, on the call's recorded input).
9. The frame: ``Session.render`` of the segmented 15M scan at 1280x720 for
   8 orbit cameras (``bench.py``'s frame sweep), with the counters zeroed
   before and read after each frame; both frame kernels must run in every
   frame, and the same frames with the plain versions swapped in must be
   byte-equal.
10. The inventory of the segmented scan, ``Session.inventory()`` (average
   axis, max RBVs) and ``inventory(axis_algo="lowhigh", method="mean",
   symmetric=True)``, with the counters zeroed before and read after each;
   both scan kernels must run.  A second kernel run and a run with the plain
   versions swapped in must give identical columns; the columns must hold
   the inventory's invariants.
11. The flood-fill Voronoi: ``Session.from_points(...,
   config=<use_bruteforce_voronoi=False, use_packed_jfa=False>)
   .segment(0.75)``; the ``jump_flood`` kernel must run, and the plain run
   must give the same ids.  Its route, the clusters the card holds at once
   and the bands that hold a seed are logged.  The packed flood runs once.
12. A small scene on the card against the port's CPU run: ids, Morton keys,
   a frame, and the inventory's columns wherever the ids agree; then, from
   the same ids on both, the octree, ``lod_mask`` (levels 0, 5, 7, 10, with
   and without frustum planes, 1 and 4 points a node), ``adaptive_mask``
   and ``adaptive_counts`` over the tau ladder, node tables, ``snug_capacity``
   and ``compact_indices``, the edit sequence of phase 14 and its LOD
   subset, all bit-equal; ``pick`` with equal ids and distances within
   PICK_RTOL.
13. The gather probe, on no path of the system: the four gathers of
   ``treee_tpu_torch.tools.probe_extract`` (the Mosaic probe's shapes) through
   ``take_along_axis``, with the counters zeroed before and read after; then
   the kernel against its plain version and ``torch.take_along_dim`` /
   ``tab[idx]``, and at how many shapes the kernel was no slower.
14. The interactive view of the segmented 15M scan, the counters zeroed
   before and read after each call: ``Session.build_lod()`` (level 7) and
   the 8 orbit frames with ``render(use_lod=True)``; ``solve_adaptive_tau``
   for a budget of half the points and the adaptive frame, then the
   screen-adaptive frame at tau 1; ``bench.py``'s 8 ``delete_sphere``
   strokes, each with its LOD frame (the cached octree and subset must
   survive); ``spawn``, ``combine``, ``draw_sphere``, ``reclassify_sphere``
   and ``pick``; then ``full_table()`` (it must recompute) and
   ``inventory()``.  Every frame launches both frame kernels and equals the
   plain versions' byte for byte; ``full_table()`` launches
   ``segmented_cummax`` and ``inventory()`` ``segmented_cumsum``, each
   identical to the plain run.  Times of each call and of its stages, and
   ``BENCH_r05.json``'s counts beside the port's as a cross-check.

15. The focused view of the segmented 15M scan's largest tree, the counters
   zeroed before and read after each call: ``Session.properties()`` (it
   launches ``segmented_cummax`` and equals the plain run bit for bit);
   ``curvature`` uncached and cached and ``normals`` (a fresh k-NN repeats
   them bit for bit; the port's CPU run on the same compacted rows gives
   the same neighbours and curvatures and normals within FOCUS_ATOL);
   ``render_focus`` for the 5 displays over the 8 orbit cameras and one
   frame with all three overlays under each axis algorithm and RBV method,
   each launching both frame kernels (and the cummax for expansion and
   height) and byte-equal to the plain versions'; ``split_rbv`` +
   ``traits`` of the tree against its ``inventory()`` row;
   ``segment_coords``; a ``delete_sphere`` through the tree, after which
   ``curvature`` recomputes; then the grid path: the tree combined with its
   nearest trees past ``brute_force_max`` points, ``curvature`` through
   the grid hash against the brute force on the same members (time, the
   share of points with the same neighbours, the largest curvature
   difference) and a second call from the cache.  Times of each call and
   stage, ``torch.profiler``'s top device ops, the peak memory.

16. The rasters of the segmented 15M scan, the counters zeroed before and
   read after each call: ``Session.rasters`` at 0.5 m (512x512 padded cells)
   and 0.1 m (2304x2304, the flood's first step 2048), whose floods launch
   the grid entry of ``jump_flood.cu``; every raster flood of the phase is
   held byte for byte against the plain flood on its input, then timed
   against it with its bound and device time; each flood's CUDA launches
   a call, counted by the CUDA driver (the kernel nodes of one call
   captured into a CUDA graph) and held to the design's count;
   the DTM, DSM and CHM equal a second card run
   and the plain run bit for bit; ``height_above_ground`` (1 m) and
   ``hag_prop`` (cached), the ``hag`` focus frame of the largest tree over
   the 8 orbit cameras, byte-equal to the plain versions'; ``export_raster``
   of each raster to a temporary directory; ``forest_summary()``.  Then a
   second epoch built as tests/test_change.py:121-151 builds it, at full
   scale (canopy 15% higher, tree 0 felled, a tree planted, another world
   offset): ``chm_change`` (growth on average, a felled patch; a null
   self-compare), ``tree_changes`` (the felled tree lost, the planted tree
   new, every matched tree that keeps its points within SAME_TREE_POINTS
   grown; a null self-compare) and ``stand_changes``.  Times of each call and stage, the
   floods' CUDA launches.

17. Ingest: the 15M scan written as a LAS 1.4 PDRF 7 file (intensity, RGB,
   GPS time), ``Session.from_las`` through the native codec with and
   without preview frames, the source attributes' properties and frames,
   ``export_las`` to .las and .laz, ``save`` / ``open`` as .npz,
   ``add_session`` of one tree's .ipc, ``export_points_ply`` of a tree and
   of the live cloud; each read back and held against its source.

18. The front ends on phase 17's scan file, the counters zeroed before and
   read after each call: the CLI (``treee_tpu_torch.app.main``: the scan,
   8 orbit frames and the info, inventory, summary, CHM, traits, hull and
   RBV exports of the largest tree) must print the segment count of a
   ``Session.from_las`` + ``segment(0.75)`` built the same way, its PNG
   frames must equal ``Session.render`` at the same cameras, its inventory
   CSV and CHM the session's own, byte for byte; ``--demo --save`` and the
   checkpoint reopened with ``--no-segment --frames 1`` must draw the same
   frame.  A ``Repl`` over the session takes a scripted command stream
   (the auto view's adaptive cut, a click, a combine, right-drag deletes, a
   left-drag, LOD levels, the hag and intensity displays, a focus frame
   with the hull, a re-segment at 0.5 with its preview, the panels, a .ply
   export): no command may print an error, and the ids after the edits,
   the dragged camera and the re-segment's ids must equal the same
   ``Session`` and ``Camera`` calls made directly.  The browser viewer
   (``serve.ViewerServer``) over the session: its page, ``/info``, and
   frames that equal ``Session.render`` / ``render_focus`` byte for byte;
   a burst of 20 drag commands must cost fewer renders than commands;
   ``shutdown()`` must end its threads.  Each command's host-clock time.

19. Surveys beyond one card, the counters zeroed before and read after each
   call: ``parallel.sharding.sharded_session_step`` over a mesh of four
   shards of the one card (``make_mesh(["cuda:0"] * 4)``) on the 15M scan,
   whose ids, classes and table must equal the one-device step's bit for
   bit, and ``sharded_rasters(0.5)`` equal to ``Session.rasters(0.5)``;
   ``parallel.tiles.tiled_pipeline`` in 2 tiles over that mesh equal to 2
   tiles without it on the scan widened in x; ``tools/bench_tiled.py``'s
   100M survey in 4 tiles through the port's ``tools.bench_tiled`` (times
   of generation, sort, each tile, the reconcile and the wall clock; each
   tile's ``n_alloc`` and overflow; peak memory), its rasters at 1 m in 6
   slabs equal to one ``compute_rasters`` of the survey on the card, and the
   survey untiled through ``Session.from_points(...).segment(0.75)``; the
   tiled ids against the survey's trees (``tools.survey_trees``: every
   point labelled, no tile at a cap, the ids within [0.75, 1] x the trees,
   trees cut by a core edge sharing ids across it); then
   ``segmented_cummax`` against its plain version at the largest tile's and
   a shard's shapes.

20. One ``Session`` over a mesh, the counters zeroed before and read after
   each call: ``Session.from_points(pts, mesh=make_mesh(["cuda:0"] * 4))``
   on the 15M scan beside a one-device ``Session`` fed its rows (Morton
   order) at its capacity; ``segment(0.75)`` twice, ``characteristics()``
   and ``full_table()`` (ids, classes, every table column bit for bit); the
   8 orbit frames (byte-equal); ``build_lod()``, ``solve_adaptive_tau``
   (budget of half the points), the adaptive cut and its 8 LOD frames (the
   same indices, tau and frames); 8 strokes of ``delete_sphere`` /
   ``draw_sphere`` / ``spawn`` / ``combine``, each with its LOD frame (ids
   equal after each, the shards' octrees kept); ``pick`` at 4 hit pixels
   (segments, hits, distance bits); ``rasters(0.5)`` (bit for bit); both
   ``inventory()`` forms (integer and table columns exact, stem positions
   within rtol 1e-4; the axes over the shards within 1e-4 of one device's,
   and the traits equal to the one-device RBVs' and traits through the
   mesh's axes: bit for bit for max grids, rtol 1e-3 for mean grids; their
   distance from one device's own traits logged); the largest tree's ``curvature``,
   ``normals`` and ``render_focus`` with hull and axis (equal); a ``Repl``
   of 9 commands (the same text, the summary's decimals within rtol 1e-4)
   and a loopback ``ViewerServer``; every call's host-clock time, the peak
   memory.  Over ``make_mesh()`` too where torch sees several cards.

Phase 12 also holds the small scene's focused view card against CPU:
eigen, both k-NNs, properties, curvature, normals, the axes, RBVs, hull
candidates and frames.

The last lines are the card's name and power limit, a JSON object of
per-kernel results and the JSON result line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

N_POINTS = 15_000_000            # bench.py's default target
POINTS_PER_TREE = 12_000
N_TREES = int(N_POINTS * 0.75) // POINTS_PER_TREE   # 937
MAX_DISTANCE = 0.75
# card against CPU: the CPU adds the centroid sums in row order (as XLA
# does), the card in a fixed tree order, so a point equidistant to two
# centroids within an ulp may go either way
MIN_CPU_AGREEMENT = 0.999
TIMING_REPS = 5
# the gather probe's calls take tens of microseconds, mostly host work whose
# spread is of the same size: more turns for their medians
PROBE_TIMING_REPS = 51
MAIN_PATH_REPS = 3
N_FRAMES = 8
ORBIT_DISTANCE = 120.0
ORBIT_STEP = 40.0
# the two inventory forms: average axis + max RBVs, low-high axis + mean
INVENTORY_CALLS = ({}, {"axis_algo": "lowhigh", "method": "mean",
                        "symmetric": True})
# card against CPU for the inventory's float columns: the two add in other
# orders (torch's reductions over grid cells) and CUDA's atan2 may differ
# from the CPU's in the last bit, which moves a point only if it lies on a
# sector edge
INVENTORY_RTOL = 1e-4
# the card's peak rates (NVIDIA H100 SXM data sheet): device memory, and
# f32 operations outside the tensor cores; the kernels' integer compares
# and selects are counted at the f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
IBIG = 0x7FFFFFFF                # an empty cell of the CC labels

# (wrapper name, CUDA source, the TPU kernel it replaces)
KERNELS = (
    ("cc_sweep", "treee_tpu_torch/ops/kernels/csrc/cc_sweep.cu",
     "treee_tpu/ops/pallas_kernels.py:244"),
    ("match_scan", "treee_tpu_torch/ops/kernels/csrc/match_scan.cu",
     "treee_tpu/ops/pallas_kernels.py:302"),
    ("segmented_cummax", "treee_tpu_torch/ops/kernels/csrc/seg_cummax.cu",
     "treee_tpu/ops/pallas_kernels.py:565"),
    ("dilate", "treee_tpu_torch/ops/kernels/csrc/dilate.cu",
     "treee_tpu/ops/pallas_kernels.py:90"),
    ("eye_dome", "treee_tpu_torch/ops/kernels/csrc/eye_dome.cu",
     "treee_tpu/ops/pallas_kernels.py:180"),
    ("segmented_cumsum", "treee_tpu_torch/ops/kernels/csrc/seg_cumsum.cu",
     "treee_tpu/ops/pallas_kernels.py:485"),
    ("jump_flood", "treee_tpu_torch/ops/kernels/csrc/jump_flood.cu",
     "treee_tpu/ops/pallas_kernels.py:32"),
    ("take_along_axis", "treee_tpu_torch/ops/kernels/csrc/take_along.cu",
     "tools/probe_extract.py:97"),
    # the rasters' flood: the grid entry of jump_flood.cu (the JAX package
    # floods its rasters with XLA rolls, treee_tpu/rasters.py:85, the same
    # jump flood as _jfa_kernel)
    ("jump_flood_grid", "treee_tpu_torch/ops/kernels/csrc/jump_flood.cu",
     "treee_tpu/ops/pallas_kernels.py:32"),
    # the step's occupied-cell Voronoi: no TPU kernel (the JAX package runs
    # XLA ops there, treee_tpu/segmentation.py:465 _bruteforce_voronoi)
    ("nearest_slot", "treee_tpu_torch/ops/kernels/csrc/nearest_slot.cu",
     "no TPU kernel: treee_tpu/segmentation.py:465"),
    # the focused view's exact k-NN: no TPU kernel (the JAX package selects
    # with lax.top_k, treee_tpu/ops/neighbors.py:67)
    ("knn_select", "treee_tpu_torch/ops/kernels/csrc/knn_select.cu",
     "no TPU kernel: treee_tpu/ops/neighbors.py:67"),
)
# the phases of the kernels that replace no TPU kernel
SIDE_PHASES = {"nearest_slot": "7b", "knn_select": "7c"}
# phase 7c's snug tree: the focus cell's largest, 40,000 members in 40,960
# rows, the port's snug capacity
KNN_SNUG = (40_000, 40_960)
# the kernels that phases 1-7c hold against their plain versions on the
# paths' recorded inputs; the gather probe's kernel has only the probe
# tool's path (phase 13), the rasters' flood phase 16
PATH_KERNELS = tuple(k for k, _, _ in KERNELS
                     if k not in ("take_along_axis", "jump_flood_grid"))
# the card's centroid sums run through segmented_cumsum on every path
STEP_KERNELS = ("cc_sweep", "match_scan", "segmented_cummax",
                "segmented_cumsum")
MAIN_PATH_KERNELS = STEP_KERNELS + ("nearest_slot",)
FRAME_KERNELS = ("dilate", "eye_dome")
INVENTORY_KERNELS = ("segmented_cummax", "segmented_cumsum")
FLOOD_KERNELS = STEP_KERNELS + ("jump_flood",)
# the interactive view (phase 14): bench.py's 8 edit strokes (bench.py:611-613)
EDIT_CENTERS = tuple(np.array([0.0, 5.0, 0.0], np.float32) + i
                     for i in range(8))
EDIT_RADIUS = 2.0
# a tree of the 15M scan (its grid puts one at x = -7, z = 0) and of the
# small scene (x = z = -4), for the membership edits
EDIT_TREE = (-7.0, 0.0, 0.0)
SMALL_EDIT_TREE = (-4.0, 0.0, -4.0)
# the JAX package's counts on the same 15M scan, printed by bench.py on a
# TPU v5e (BENCH_r05.json): another device's arithmetic, so a cross-check
# that is logged, not a gate.  bench.py cuts without a frustum, over every
# valid point (deleted ones included).
BENCH_R05 = {"lod_points": 51_934, "adaptive_tau": 2.0,
             "adaptive_points": 7_098_581, "adaptive_pixel_match": 0.9888,
             "screen_adaptive_points": 12_913_000,
             "screen_adaptive_pixel_match": 0.9999,
             "curvature_points": 39_102, "curvature_grid": False}
# pick's distance, card against CPU: each device normalises its ray with
# its own vector_norm, which may differ in the last bit
PICK_RTOL = 1e-5
# the focused view (phase 15): one frame of all three overlays under each
# axis algorithm and RBV method
FOCUS_OVERLAYS = tuple(dict(show_hull=True, show_rbv=True, show_axis=True,
                            axis_algo=a, rbv_method=m)
                       for a in ("average", "lowhigh") for m in ("max", "mean"))
# card against CPU in the focused view: the 31 neighbours' covariances sum
# in another order on each device and CUDA's acos and cos may differ from
# the CPU's in the last bits, so curvature and normals agree within
# FOCUS_ATOL on at least FOCUS_MIN_SHARE of the members (an ill-conditioned
# neighbourhood's normal may turn further); the k-NN, heights and hull
# candidates are elementwise f32 arithmetic and must be bit-equal; an
# RBV grid may differ in RBV_EDGE_CELLS cells, where CUDA's atan2 moves a
# point across a sector edge
FOCUS_ATOL = 1e-4
FOCUS_MIN_SHARE = 0.99
RBV_EDGE_CELLS = 2
# one tree's traits against its inventory row (tests/test_analytics.py:163)
TRAITS_RTOL, TRAITS_ATOL = 2e-3, 1e-5
# the grid path: the k-NN cell size that Session.curvature uses
GRID_CELL = 0.5
# the focus camera's distance in front of the tree
FOCUS_DISTANCE = 30.0
# the rasters (phase 16): forest_summary's 0.5 m CHM, a 0.1 m raster (2304
# cells a side, 4096 the flood's first step) and the hag display's 1 m DTM
RASTER_CELLS = (0.5, 0.1)
HAG_CELL = 1.0
# epoch B, as tests/test_change.py:121-151 builds it at full scale: canopy
# points (tree points above 0.3 m) 15% higher, tree 0 felled, tree 1 planted
# again 63 m east and 210 m south (grid cell 10 of the last row, which the
# 937 trees leave empty), the scan recentred by another world offset
GROWTH = 1.15
PLANT_SHIFT = (63.0, 0.0, 210.0)
EPOCH_B_OFFSET = (10.0, 0.0, 5.0)
CHANGE_MAX_DIST = 2.0
# a felled or planted tree must show up within this many metres of its stem
# (tests/test_change.py:184-193)
STEM_TOLERANCE = 4.0
# a matched pair whose point count changed by at most this share holds the
# same tree in both epochs, and must have grown; where crowns touch, the
# two epochs' segmentations may split them otherwise (on the 15M scan
# every pair that did not grow had changed by >= 12.9%), and at least half
# of the matched pairs must be such pairs
SAME_TREE_POINTS = 0.10
# ingest (phase 17): the scan as a LAS 1.4 PDRF 7 file in a UTM-like map
# frame, with intensity, RGB and GPS time (adjusted standard time, one hour
# of survey) from seed 0; decoded in slabs of SLAB_POINTS for the previews
LAS_OFFSET = (500000.0, 5600000.0, 300.0)
GPS_EPOCH, GPS_SPAN = 3.0e8, 3600.0
SLAB_POINTS = 4_000_000
# the .laz export takes the whole live cloud if its compression is expected
# to take at most this many seconds (from the largest tree's rate), else
# that tree alone
LAZ_BUDGET_S = 30.0
# the ASPRS classes export_las writes for ground, trunk and crown
ASPRS = (2, 4, 5)
# the front ends (phase 18): the REPL's orbit distance, outside the 15M
# stand (about 214 m a side, centred on the origin)
REPL_ORBIT = 250.0
# surveys beyond one card (phase 19): four shards of the one card; the 15M
# scan's first half moved 40 m west for the tiles over that mesh
# (__graft_entry__.py:136-139); tools/bench_tiled.py's survey in 4 tiles;
# its rasters at 1 m in slabs of 2^24 points (6 slabs)
SHARDS = 4
WIDEN_X = 40.0
SURVEY_POINTS = 100_000_000
SURVEY_TILES = 4
SURVEY_CELL = 1.0
SURVEY_SLAB = 1 << 24
# one session over a mesh (phase 20): the inventory's columns that add
# per-shard sums (the axes' band and layer sums, the mean grids) within the
# JAX package's mesh tolerances (tests/test_sharding.py:537-547, 669-672):
# stem positions rtol 1e-4 / atol 1e-5, axis directions 1e-4, mean RBV
# grids 1e-3; pick at a few hit pixels; a short REPL script
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_AXIS_TOL = 1e-4
MESH_RBV_TOL = 1e-3
MESH_PICKS = 4
MESH_REPL = ("mode view", "click 640 360", "info", "traits", "lod adaptive",
             "display hag", "render {png}", "summary", "status")


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def swapped(kernels, **fns):
    """Replace wrappers of ``treee_tpu_torch.ops.kernels`` for the duration;
    the port's modules look them up there at each call."""
    old = {name: getattr(kernels, name) for name in fns}
    for name, fn in fns.items():
        setattr(kernels, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(kernels, name, fn)


def recorder(fn, calls: list, by_value: bool = False):
    """``fn`` that also keeps the arguments of its first call at each
    distinct set of input shapes (with ``by_value``, of each distinct set of
    inputs)."""
    def same(a, b):
        return all(not torch.is_tensor(x) or torch.equal(x, y)
                   for x, y in zip(a, b))

    def record(*args):
        sig = tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
        if all(s != sig or (by_value and not same(args, a))
               for s, a in calls):
            calls.append((sig, tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args)))
        return fn(*args)
    return record


def cuda_ms(fn, reps: int) -> list[float]:
    """Times of ``reps`` calls of ``fn`` in ms, each between CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def work(name: str, args: tuple, kernels) -> tuple[int, int]:
    """(bytes, operations) the function must spend on one call's inputs:
    each input read once and each output written once; the operations its
    algorithm performs on these inputs (per element: cc_sweep 8 mins and a
    select per sweep, over the sweeps each band needs to reach its fixpoint
    and see it, at most ``sweeps``; match_scan 5 per centroid-slot distance
    per round;
    the scans one per value; dilate ~12 per pixel, direction and pass;
    eye_dome ~40 per pixel; jump_flood 8 per cell and direction in the
    bands that hold a seed (a band without one is its input copied), and
    jump_flood_grid likewise over its one grid;
    take_along_axis one per output; nearest_slot 5 per valid row and
    active slot of its band, the bytes of its -1 fill included;
    knn_select 8 per pair of rows, 13 bytes a row in and 8 k out)."""
    if name == "cc_sweep":
        lbl, sweeps = args[:2]
        fix = sweeps_to_fixpoint(kernels.cc_sweep_plain, lbl, sweeps)
        needed = int(torch.clamp(fix + 1, max=sweeps).sum())
        return 8 * lbl.numel(), 9 * needed * lbl[0].numel()
    if name == "match_scan":
        cents, cmask, _, rounds, t_cap = args[:5]
        b, c = cmask.shape
        return (4 * cents.numel() + cmask.numel() + b * t_cap * 9 + 4,
                5 * b * rounds * c * t_cap)
    if name in ("segmented_cummax", "segmented_cumsum"):
        key, val = args[:2]
        return 4 * key.numel() + 8 * val.numel(), val.numel()
    if name == "dilate":
        kimg, radius = args[:2]
        return 8 * kimg.numel(), 12 * 8 * radius * kimg.numel()
    if name == "eye_dome":
        color, z01 = args[:2]
        return 4 * (2 * color.numel() + z01.numel()), 40 * z01.numel()
    if name == "jump_flood":
        slot, pos, cc = args[:3]
        n_dirs = 8 * len(kernels.jump_flood_steps(slot.shape[-1]))
        seeded = int((slot >= 0).flatten(1).any(1).sum())
        return (4 * (2 * slot.numel() + pos.numel() + cc.numel()),
                8 * n_dirs * seeded * slot[0].numel())
    if name == "take_along_axis":
        tab, idx = args[:2]
        return 4 * (tab.numel() + 2 * idx.numel()), idx.numel()
    if name == "jump_flood_grid":
        # the rasters' form (no positions) reads the slots alone
        slot, pos, cc, steps = args[:4]
        seeded = int(bool((slot >= 0).any()))
        given = 0 if pos is None else pos.numel() + cc.numel()
        return (4 * (2 * slot.numel() + given),
                8 * 8 * len(steps) * seeded * slot.numel())
    if name == "nearest_slot":
        occ_idx, occ_valid, pos, act, _, _, n_bands, g = args[:8]
        band = (occ_idx[occ_valid] // (g * g)).long()
        pairs = int(act.sum(1)[band].sum())
        return (5 * occ_idx.numel() + 9 * act.numel() + 4 * n_bands * g * g,
                5 * pairs)
    if name == "knn_select":
        pos, _, k = args[:3]
        n = pos.shape[0]
        return 13 * n + 8 * k * n, 8 * n * n
    raise KeyError(name)


def bound_ms(name: str, args: tuple, kernels) -> tuple[float, str]:
    """The least time the card could take for one call, and what sets it."""
    nbytes, ops = work(name, args, kernels)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, ref) -> float:
    """Largest |got - ref| over all outputs; equal entries count 0 (so
    matching -3e38 fills give 0, not inf - inf)."""
    err = 0.0
    for a, b in zip(as_tuple(got), as_tuple(ref)):
        a, b = a.double(), b.double()
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_kernel(name: str, kernels, calls: list, library=None,
                 extra=(), reps: int = TIMING_REPS,
                 device: bool = False) -> dict:
    """The kernel against its plain version on every recorded input: bit
    equality, both median times (kernel and plain in turns), and the
    bound, each summed over the recorded shapes.  ``library(*args)``, where
    given, returns a call of one PyTorch function that computes the same
    thing, timed in the same turns.  ``extra``: (label, args) inputs that no
    path gives the kernel, checked and timed the same way but kept out of
    the sums.  With ``device``, also the device time of the wrapper's
    launches (``torch.profiler``; with ``device="queued"`` the time a call
    of calls queued back to back between CUDA events), summed as
    ``device_ms``."""
    wrapper, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    shapes, ms, plain_ms, err, bound, by = [], 0.0, 0.0, 0.0, 0.0, {}
    dev_ms = 0.0 if device else None
    per_shape = []          # (kernel ms, library ms) of each recorded input
    lib_ms = None if library is None else 0.0
    n_recorded = len(calls)
    # the scans' order of signed zeros and their NaN are part of what they
    # compute; the other kernels are held to torch.equal as before
    equal = same_bits if name.startswith("segmented_") else torch.equal
    for i, (sig, args) in enumerate(list(calls) + list(extra)):
        got = as_tuple(wrapper(*args))
        ref = as_tuple(plain(*args))
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.dtype != r.dtype or g.shape != r.shape or not equal(g, r):
                raise AssertionError(
                    f"{name} at {sig}: kernel output differs from the plain "
                    f"version (max abs err {max_abs_err(got, ref)})")
        err = max(err, max_abs_err(got, ref))
        del got, ref
        lib_call = None if library is None else library(*args)
        k_t, p_t, l_t = [], [], []
        turns = [(k_t, lambda: wrapper(*args)), (p_t, lambda: plain(*args))]
        if lib_call is not None:
            turns.append((l_t, lib_call))
        for rep in range(reps):
            # every other rep in reverse, so that no call always runs right
            # after the same other one (the plain gather warms the library's
            # host path)
            for times, fn in (turns if rep % 2 == 0 else turns[::-1]):
                times += cuda_ms(fn, 1)
        k_ms, p_ms = statistics.median(k_t), statistics.median(p_t)
        b_ms, b_by = bound_ms(name, args, kernels)
        lib_txt = ""
        if lib_call is not None:
            lib_ms += statistics.median(l_t)
            lib_txt = f", library {statistics.median(l_t):.4f} ms"
        what = sig if isinstance(sig, str) else list(map(list, sig))
        dev_txt = ""
        if device == "queued":
            d_ms = queued_ms(lambda: wrapper(*args), 4 * reps)
            dev_txt = (f"; device {d_ms:.4f} ms a call ({4 * reps} calls "
                       "queued back to back between CUDA events)")
        elif device:
            d_ms = device_ms(lambda: wrapper(*args), reps)
            dev_txt = f"; device {d_ms:.4f} ms a call (torch.profiler)"
        log(f"  {name} {what}: bit-equal; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms{lib_txt} (median of "
            f"{reps}); bound {b_ms:.4f} ms ({b_by}){dev_txt}")
        if i >= n_recorded:
            continue
        if device:
            dev_ms += d_ms
        per_shape.append((k_ms, statistics.median(l_t) if l_t else None))
        shapes.append([list(s) for s in sig])
        ms += k_ms
        plain_ms += p_ms
        bound += b_ms
        by[b_by] = by.get(b_by, 0.0) + b_ms
    return {"shapes": shapes, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "max_abs_err": err, "bound_ms": bound,
            "bound_by": max(by, key=by.get), "per_shape": per_shape,
            "device_ms": dev_ms}


def queued_ms(fn, reps: int = TIMING_REPS) -> float:
    """ms a call of ``fn`` with ``reps`` calls queued back to back between
    two CUDA events (after a warm-up): the card's time a call wherever the
    host enqueues faster than the card runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def captured_kernels(fn) -> int:
    """Kernel launches one call of ``fn`` makes, counted by the CUDA
    driver: after a warm-up call on a stream of its own, one call captured
    into a CUDA graph there (relaxed mode), the graph's kernel nodes
    counted and the graph dropped unlaunched."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    stream = torch.cuda.Stream()
    handle = ctypes.c_void_p(stream.cuda_stream)
    graph = ctypes.c_void_p()
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        ok(cu.cuStreamBeginCapture_v2(handle, 2), "cuStreamBeginCapture")
        try:
            fn()
        finally:
            ok(cu.cuStreamEndCapture(handle, ctypes.byref(graph)),
               "cuStreamEndCapture")
    try:
        n = ctypes.c_size_t()
        ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * max(1, n.value))()
        ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
        kinds = []
        for k in range(n.value):
            kind = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[k]),
                                     ctypes.byref(kind)), "cuGraphNodeGetType")
            kinds.append(kind.value)
    finally:
        cu.cuGraphDestroy(graph)
    return kinds.count(0)                       # CU_GRAPH_NODE_TYPE_KERNEL


def grid_flood_launches(kernels, calls: list) -> None:
    """Each recorded raster flood's CUDA launches a call, counted by the
    CUDA driver (:func:`captured_kernels`) and held to the design's
    count (``jump_flood_grid_launches``)."""
    for _, (slot, pos, cc, steps) in calls:
        h, w = slot.shape
        n = captured_kernels(lambda: kernels.jump_flood_grid(slot, pos, cc,
                                                             steps))
        want = kernels.jump_flood_grid_launches(h, w, steps)
        if n != want:
            raise AssertionError(f"jump_flood_grid {h}x{w}: {n} CUDA "
                                 f"launches a call, the design makes {want}")
        log(f"  jump_flood_grid {h}x{w}: {len(steps)} steps over tiles, {n} "
            f"CUDA launch{'es' if n > 1 else ''} a call (kernel nodes of one "
            "call captured into a CUDA graph)")


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of the CUDA kernels ``fn`` launches, ms a call:
    ``torch.profiler`` over ``reps`` calls after one warm-up.  Raises where
    the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        # the kernels themselves, not the aten ops or runtime calls that
        # launched them
        if t > 0 and not e.key.startswith(("aten::", "cuda")):
            total += t
    if total <= 0:
        raise AssertionError("torch.profiler reported no device time")
    return total / reps / 1e3


def top_device_ops(fn, k: int = 4) -> str:
    """The device time of one call of ``fn`` and the ``k`` kernels that take
    most of it (``torch.profiler``, one call after a warm-up), as text."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if t > 0 and not e.key.startswith(("aten::", "cuda")):
            rows.append((t / 1e3, e.count, e.key))
    if not rows:
        raise AssertionError("torch.profiler reported no device time")
    rows.sort(reverse=True)
    return (f"device {sum(r[0] for r in rows):.3f} ms; top: " + "; ".join(
        f"{name[:72]} x{n} {ms:.3f} ms" for ms, n, name in rows[:k]))


def dense_keys(h: int, w: int, seed: int, device) -> torch.Tensor:
    """An i32[h,w] key image with a splat on every pixel, made on the
    device: one in ten near (3-10 m, 9-29 px at the render defaults), the
    rest far (60-150 m, 0.6-1.5 px), random palette bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((3, h, w), device=device, generator=gen,
                   dtype=torch.float64)
    depth = torch.where(u[0] < 0.1, 3.0 + 7.0 * u[1], 60.0 + 90.0 * u[1])
    zq = ((1.00001 - 0.1 / depth) * ((1 << 23) - 1)).to(torch.int64)
    return ((zq << 8) | (u[2] * 256).to(torch.int64)).to(torch.int32)


def frame_extras(calls: list, device) -> list:
    """Inputs for the dilation that the frame does not give it: the dense
    720p key image at r=3 and r=8 (three launches), with the recorded
    call's camera constants."""
    kimg, _, *params = calls[0][1]
    dense = dense_keys(*kimg.shape, 0, device)
    return [(f"dense {list(kimg.shape)}, r={r}", (dense, r, *params))
            for r in (3, 8)]


def knn_extras(las, device) -> list:
    """The k-NN at phase 7c's snug shape: a synthetic tree's members, then
    the invalid tail of its snug buffer (zeros, as compaction leaves it)."""
    members, rows = KNN_SNUG
    rng = np.random.default_rng(21)
    pos = np.zeros((rows, 3), np.float32)
    pos[:members] = las.synthetic_tree(rng, np.array([30.0, 2.0, -40.0]),
                                       n_points=members)
    valid = torch.arange(rows, device=device) < members
    return [(f"a {members}-point tree snug in {rows} rows, k=31",
             (torch.from_numpy(pos).to(device), valid, 31, 1024))]


def log_tile_stats(calls: list, extra: list) -> None:
    """The dilation's exact shortcuts at each input: the share of tiles
    with no key in their span, and of tiles stopped after a still pass."""
    from treee_tpu_torch.ops.kernels.dilate import tile_stats
    for sig, args in list(calls) + list(extra):
        st = tile_stats(*args)
        where = sig if isinstance(sig, str) else "the frame input"
        log(f"  dilate tiles at {where}: {st['tiles']} run, {st['empty']} "
            f"empty ({st['empty'] / st['tiles']:.3f}), {st['stopped']} "
            f"stopped after a still pass ({st['stopped'] / st['tiles']:.3f}), "
            f"{st['passes']} passes run")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: floats by their bit patterns, so that +0.0 and
    -0.0 differ and equal NaNs agree."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def synthetic_scans(calls: list, device) -> list:
    """Two inputs for a scan kernel that the paths' keys do not hold, at the
    recorded row count and the widest recorded value: one run that spans the
    whole array, and keys that are all distinct."""
    key, val = max((a[:2] for _, a in calls),
                   key=lambda kv: kv[1].numel())
    rest = next(a[2:] for _, a in calls if a[1] is val)
    n = key.shape[0]
    return [(f"{list(val.shape)}, one run over all rows",
             (torch.zeros(n, dtype=torch.int32, device=device), val, *rest)),
            (f"{list(val.shape)}, all keys distinct",
             (torch.arange(n, dtype=torch.int32, device=device), val, *rest))]


def sweeps_to_fixpoint(plain, lbl: torch.Tensor, cap: int) -> torch.Tensor:
    """i64[B]: per band, the number of sweeps after which one more sweep
    leaves it unchanged (cap + 1 where it still changes after cap)."""
    fix = torch.full((lbl.shape[0],), cap + 1, dtype=torch.int64,
                     device=lbl.device)
    x = lbl
    for k in range(cap + 1):
        y = plain(x, 1)
        still = (y != x).flatten(1).any(1)
        fix = torch.where(~still & (fix > cap), k, fix)
        x = y
    return fix


def run_main_path(pts, pipeline, octree, device, config=None):
    """The port's main path as a user calls it; returns (session, result,
    sorted keys), synchronized."""
    kw = {} if config is None else {"config": config}
    session = pipeline.Session.from_points(pts, device=device, **kw)
    res = session.segment(MAX_DISTANCE)
    keys = octree.build_keys(session.cloud.pos, session.cloud.valid)
    if device != "cpu":
        torch.cuda.synchronize()
    return session, res, keys


def orbit_cameras(camera_cls, device) -> list:
    """bench.py's frame sweep: an orbital camera 120 m out, then each next
    one rotated 40 px of mouse travel around the pivot."""
    cams = [camera_cls.orbital(distance=ORBIT_DISTANCE, device=device)]
    for _ in range(N_FRAMES - 1):
        cams.append(cams[-1].rotate_orbital(ORBIT_STEP, 0.0))
    return cams


def stage_timer(stages: dict, reps: int):
    """``timed(name, fn)``: runs ``fn`` ``reps`` times, each ended by a
    synchronize, records the median host-clock ms under ``name`` in
    ``stages``, and returns ``fn``'s output."""
    def timed(name, fn):
        out = []
        stages[name] = timed_ms(lambda: out.append(fn()), reps)[0]
        return out[-1]
    return timed


def frame_stages(session, cam, splat, pos=None, select=None) -> dict:
    """Host-clock ms of each stage of one frame (median of TIMING_REPS):
    of the full cloud, or of the rows ``pos`` whose (prop, mask)
    ``select()`` gives (the LOD subset's gathers through its indices)."""
    cloud, cfg = session.cloud, session.config.render
    stages = {}
    timed = stage_timer(stages, TIMING_REPS)
    if pos is None:
        pos = cloud.pos
        select = lambda: (splat.prop_from_segment(cloud.segment),
                          cloud.valid & (cloud.segment != 0))

    prop = timed("prop_from_segment + mask", select)
    timed("_project alone", lambda: splat._project(pos, cam, cfg.width,
                                                    cfg.height))
    kimg = timed("rasterize_keys (project + pack + scatter-min)",
                 lambda: splat.rasterize_keys(pos, prop[0], prop[1], cam,
                                              cfg))
    color, z01, _ = timed("resolve_keys (dilate + palette)",
                          lambda: splat.resolve_keys(kimg, cam,
                                                     session.palette, cfg))
    img = timed("eye_dome", lambda: splat.eye_dome(color, z01, cfg))
    timed("to_u8 + copy to host", lambda: splat.to_u8(img).cpu().numpy())
    return stages


def step_stages(session, kernels, sg, ch, octree) -> dict:
    """Host-clock ms of each stage of the step on the session's cloud, as
    ``full_pipeline`` and ``build_keys`` run them (median of
    MAIN_PATH_REPS).  Raises unless the stages end in the session's own
    segment ids and classes, so that they time what the step runs."""
    cloud, cfg = session.cloud, session.config
    scfg = cfg.segmentation
    pos, valid = cloud.pos, cloud.valid
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)

    def geometry():
        d = torch.tensor(MAX_DISTANCE, dtype=torch.float32, device=pos.device)
        lo, hi = sg.scene_bounds(pos, valid)
        s = sg.cell_size(lo, hi, d, scfg)
        top = sg.band_anchor(sg.anchor_histogram(pos, valid, lo[1], hi[1]),
                             lo[1], hi[1], scfg)
        return lo, s, sg.point_cells(pos, lo, s, top, scfg)

    lo, s, (band, cx, cz) = timed("bounds + anchor + point_cells", geometry)
    cnt = timed("moment_grids", lambda: sg.moment_grids(valid, band, cx, cz,
                                                        scfg))
    labels, occ_idx, occ_valid = timed(
        "_connected_components (cc_sweep bodies + pointer jumps)",
        lambda: sg._connected_components(cnt > 0, scfg.cc_occupied_cap,
                                         scfg.cc_sweeps))
    cents, cmask = timed("_extract_clusters", lambda: sg._extract_clusters(
        labels, cnt, lo, s, scfg.max_trees_per_band, scfg.min_points,
        occ_idx, occ_valid))
    radius = float(np.float32(scfg.match_radius_factor)
                   * np.float32(MAX_DISTANCE))
    tp, act, _ = timed("match_scan", lambda: kernels.match_scan(
        cents, cmask, radius, scfg.match_rounds, scfg.max_segments))
    grids = timed("nearest_slot (the Voronoi)", lambda: kernels.nearest_slot(
        occ_idx, occ_valid, tp, act, lo, s, cnt.shape[0], scfg.grid_size,
        scfg.voronoi_chunk))
    seg = timed("assign_points",
                lambda: sg.assign_points(grids, band, cx, cz, valid))
    _, cls_ = timed("compute_segments (full_bbox=False)",
                    lambda: ch.compute_segments(
                        pos, seg, valid, scfg.max_segments + 1,
                        cfg.characteristics, full_bbox=False))
    timed("build_keys", lambda: octree.build_keys(pos, valid))
    if not (torch.equal(seg, cloud.segment)
            and torch.equal(cls_, cloud.classification)):
        raise AssertionError("the timed stages give other segment ids or "
                             "classes than the step")
    return stages


def check_outputs(session, res, keys, n: int, n_trees: int,
                  max_segments: int) -> None:
    """The main path's outputs: shapes, finiteness and invariants."""
    cloud, table = session.cloud, session.table
    seg = cloud.segment[cloud.valid]
    n_seg = int(res.n_segments)
    if bool(res.occupied_overflow):
        raise AssertionError("occupied-cell compaction overflowed")
    if not 0.9 * n_trees <= n_seg <= max_segments:
        raise AssertionError(f"n_segments {n_seg} outside "
                             f"[{0.9 * n_trees}, {max_segments}]")
    if seg.shape != (n,) or int(seg.min()) < 0 or int(seg.max()) > n_seg:
        raise AssertionError("segment ids out of range")
    counted, assigned = int(table.count.sum()), int((seg > 0).sum())
    if counted != assigned:
        raise AssertionError(f"table counts {counted} points, "
                             f"{assigned} are assigned")
    cls_ = cloud.classification[cloud.valid]
    if int(cls_.min()) < 0 or int(cls_.max()) > 2:
        raise AssertionError("classification outside {0, 1, 2}")
    for f in ("lo", "hi", "areas", "ground_sep", "crown_sep",
              "trunk_height", "crown_height"):
        if not bool(torch.isfinite(getattr(table, f)).all()):
            raise AssertionError(f"table.{f} is not finite")
    if keys.shape != (cloud.capacity,) or not bool((keys[1:] >= keys[:-1]).all()):
        raise AssertionError("octree keys are not sorted")
    log(f"  outputs ok: {n_seg} segments, {assigned} of {n} points assigned, "
        f"{int(table.present.sum())} table rows present")


def dbh_slice_filled(session, kw: dict, trunk_axis, rbv) -> np.ndarray:
    """bool[S]: whether the trunk grid of each segment, as ``inventory(**kw)``
    builds it, holds a point in the slice that DBH reads (1.3 m up)."""
    cloud, n_seg = session.cloud, int(session.full_table().present.shape[0])
    seg = cloud.segment
    live = cloud.valid & (seg != 0) & (seg < n_seg)
    axis_fn = (trunk_axis.batched_low_high_layer
               if kw.get("axis_algo") == "lowhigh"
               else trunk_axis.batched_average_direction)
    axes = axis_fn(cloud.pos, live & (cloud.classification == 1), seg, n_seg)
    _, trunk = rbv.batched_split_rbv(
        cloud.pos, cloud.classification, live, seg, n_seg,
        trunk_axis.batched_axis_transform(axes),
        method=rbv.METHOD_MEAN if kw.get("method") == "mean" else
        rbv.METHOD_MAX, symmetric=kw.get("symmetric", False))
    grid = trunk.distances.view(n_seg, trunk.slices, trunk.sectors)
    sl = torch.clamp(torch.div(torch.full_like(trunk.slice_height, 1.3),
                               trunk.slice_height).to(torch.int32),
                     0, trunk.slices - 1)
    rows = grid[torch.arange(n_seg, device=grid.device), sl.long()]
    return (rows > 0).any(dim=1).cpu().numpy()


def check_inventory(inv: dict, n_trees: int, max_segments: int,
                    n_live: int, filled: np.ndarray) -> None:
    """The inventory's invariants: one row per tree, counts that add up to
    the live points, finite columns, and a positive DBH exactly where the
    trunk grid's 1.3 m slice holds a point (``filled``, by segment)."""
    n = len(inv["segment"])
    if not 0.9 * n_trees <= n <= max_segments:
        raise AssertionError(f"{n} inventory rows outside "
                             f"[{0.9 * n_trees}, {max_segments}]")
    for k, col in inv.items():
        if len(col) != n or not np.isfinite(col).all():
            raise AssertionError(f"inventory column {k} is not {n} finite "
                                 "values")
    if not (inv["n_points"] == inv["n_ground"] + inv["n_trunk"]
            + inv["n_crown"]).all():
        raise AssertionError("per-class counts do not add up")
    if int(inv["n_points"].sum()) != n_live:
        raise AssertionError(f"inventory counts {int(inv['n_points'].sum())} "
                             f"points, {n_live} are live")
    # a segment whose trunk-class points all lie away from 1.3 m (one point
    # above the ground separator, the rest below the crown's, the trunk
    # itself in a neighbouring segment) has DBH 0, in the JAX package too
    has_axis = inv["axis_found"] & (inv["n_trunk"] > 0)
    dbh = inv["diameter_breast_height"]
    if not ((dbh > 0) == filled[inv["segment"]]).all():
        raise AssertionError("DBH is positive other than where the trunk "
                             "grid's 1.3 m slice holds a point")
    if not (dbh[has_axis] > 0).mean() > 0.9:
        raise AssertionError("fewer than 90% of the trunks have a DBH")
    zero = has_axis & ~(dbh > 0)
    n_zero = inv["n_trunk"][zero]
    log(f"  {int(has_axis.sum())} rows with a trunk axis; DBH 0 in "
        f"{int(zero.sum())} of them, each with an empty 1.3 m trunk slice"
        + (f" ({int(n_zero.min())}-{int(n_zero.max())} trunk points)"
           if zero.any() else ""))


def same_columns(a: dict, b: dict) -> list[str]:
    """Names of the columns in which two inventories differ at all."""
    if list(a) != list(b):
        return ["<column names>"]
    return [k for k in a if a[k].shape != b[k].shape
            or a[k].tobytes() != b[k].tobytes()]


def timed_ms(fn, reps: int) -> tuple[float, list[float]]:
    """Median host-clock ms of ``reps`` calls, each ended by a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def inventory_stages(session, trunk_axis, rbv) -> dict:
    """Host-clock ms of each stage of the inventory on its full table
    (median of MAIN_PATH_REPS)."""
    cloud, n_seg = session.cloud, int(session.full_table().present.shape[0])
    seg = cloud.segment
    live = cloud.valid & (seg != 0) & (seg < n_seg)
    trunk = live & (cloud.classification == 1)
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)

    axes = timed("batched_average_direction", lambda: (
        trunk_axis.batched_average_direction(cloud.pos, trunk, seg, n_seg)))
    timed("batched_low_high_layer", lambda: (
        trunk_axis.batched_low_high_layer(cloud.pos, trunk, seg, n_seg)))
    tfs = timed("batched_axis_transform",
                lambda: trunk_axis.batched_axis_transform(axes))
    grids = timed("batched_split_rbv (max)", lambda: rbv.batched_split_rbv(
        cloud.pos, cloud.classification, live, seg, n_seg, tfs))
    timed("batched_split_rbv (mean, symmetric)", lambda: (
        rbv.batched_split_rbv(cloud.pos, cloud.classification, live, seg,
                              n_seg, tfs, method=rbv.METHOD_MEAN,
                              symmetric=True)))
    timed("batched_traits", lambda: rbv.batched_traits(*grids))
    return stages


def build_lod_stages(session, octree, mask_fn) -> dict:
    """Host-clock ms of each stage of ``Session.build_lod`` on its cloud
    (median of MAIN_PATH_REPS), the tree built anew; ``mask_fn(tree,
    live)`` is the cut."""
    cloud = session.cloud
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)
    tree = timed("octree.build (bounds, keys, stable sort, ranks)",
                 lambda: octree.build(cloud.pos, cloud.valid))
    lod = timed("the cut (mask)", lambda: mask_fn(tree, cloud.alive))
    cap = timed("snug_capacity (count to the host)", lambda: min(
        cloud.capacity, octree.snug_capacity(int(lod.sum()))))
    _, idx = timed("compact_indices", lambda: octree.compact_indices(lod,
                                                                     cap))
    timed("position gather", lambda: cloud.pos[idx])
    return stages


def lod_select(session, splat):
    """The LOD frame's (prop, mask) of the session's subset, read through
    its indices as ``pipeline._lod_frame`` reads them."""
    _, idx, count = session._lod
    cloud = session.cloud
    seg_c = cloud.segment[idx]
    slot = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    return (splat.prop_from_segment(seg_c),
            cloud.valid[idx] & (seg_c != 0) & (slot < count))


def membership_edits(session, tree_at, pair) -> dict:
    """A user finishing a tree by hand: spawn a segment in its trunk, merge
    segment ``pair[0]`` into ``pair[1]``, draw the crown (deleted points
    too) into the new segment, reclassify its lower part as crown."""
    at = np.asarray(tree_at, np.float32)
    nid = session.spawn(at + [0.0, 4.0, 0.0], radius=EDIT_RADIUS)
    session.combine(*pair)
    session.draw_sphere(at + [0.0, 6.0, 0.0], nid, radius=1.5,
                        include_deleted=True)
    session.reclassify_sphere(at + [0.0, 2.0, 0.0], 2, nid, radius=1.0)
    return {"spawned": nid, "combined": pair}


def interactive_card_vs_cpu(pts, cfg, segment, cam, pipeline, octree,
                            dev) -> None:
    """The small scene's octree, LOD and screen-error cuts, node tables,
    compaction, the edit sequence of phase 14 and ``pick``, on the card and
    on the CPU from the same ids: bit-equal, and pick's distance within
    PICK_RTOL.  The same frustum planes go to both."""
    sessions = []
    for d in ("cpu", dev):
        s = pipeline.Session.from_points(pts, cfg, device=d)
        s.cloud = s.cloud.replace(segment=segment.to(d))
        s.camera = cam.to(d)
        sessions.append(s)
    n_checks = 0

    def same(what, got, ref):
        nonlocal n_checks
        for g, r in zip(as_tuple(got), as_tuple(ref)):
            g = g.cpu() if torch.is_tensor(g) else torch.as_tensor(g)
            r = r if torch.is_tensor(r) else torch.as_tensor(r)
            if g.dtype != r.dtype or g.shape != r.shape or not same_bits(g, r):
                raise AssertionError(f"{what}: the card and the CPU differ")
        n_checks += 1

    def both(fn):
        """(CPU result, card result) of ``fn(session, tree, live, to)``."""
        return [fn(s, t, s.cloud.alive, lambda x, d=s.device: None
                   if x is None else x.to(d))
                for s, t in zip(sessions, trees)]

    trees = [octree.build(s.cloud.pos, s.cloud.valid) for s in sessions]
    for f in ("keys", "order", "rank", "inv", "lo", "hi"):
        same(f"build {f}", getattr(trees[1], f), getattr(trees[0], f))
    rcfg = cfg.render
    planes = cam.frustum_planes(rcfg.width / rcfg.height)
    px = pipeline._px_scale(cam, rcfg)
    for level in (0, 5, 7, 10):
        for ppn in (1, 4):
            for fr in (None, planes):
                cpu, gpu = both(lambda s, t, live, to: octree.lod_mask(
                    t, level, ppn, live, to(fr)))
                same(f"lod_mask level {level} x{ppn}", gpu, cpu)
    taus = pipeline.Session.TAU_LADDER
    for fr in (None, planes):
        cpu, gpu = both(lambda s, t, live, to: octree.adaptive_counts(
            t, to(cam.position), px, taus, live=live, frustum=to(fr)))
        same("adaptive_counts", gpu, cpu)
        for tau in taus:
            cpu, gpu = both(lambda s, t, live, to: octree.adaptive_mask(
                t, to(cam.position), px, tau, live=live, frustum=to(fr)))
            same(f"adaptive_mask tau {tau}", gpu, cpu)
    for level in (3, 7, 10):
        n_nodes = int(octree.node_table(trees[0], level, 1).n)
        for m in (n_nodes // 2 + 1, n_nodes, n_nodes + 64):
            tabs = [octree.node_table(t, level, m) for t in trees]
            for f in ("prefix", "start", "count", "n"):
                same(f"node_table {f}", getattr(tabs[1], f),
                     getattr(tabs[0], f))
            same("node_bounds", octree.node_bounds(tabs[1], trees[1], level),
                 octree.node_bounds(tabs[0], trees[0], level))
    masks = both(lambda s, t, live, to: octree.lod_mask(t, 7, live=live))
    kept = [int(m.sum()) for m in masks]
    snug = [octree.snug_capacity(k) for k in kept]
    same("snug_capacity", snug[1], snug[0])
    for cap in (kept[0] // 2 + 1, kept[0], kept[0] + 100, snug[0]):
        same(f"compact_indices cap {cap}",
             octree.compact_indices(masks[1], cap),
             octree.compact_indices(masks[0], cap))
    pair = tuple(int(i) for i in np.unique(segment.numpy())[1:3])
    for s in sessions:
        s.build_lod()
        for c in EDIT_CENTERS:
            s.delete_sphere(c, radius=EDIT_RADIUS)
        membership_edits(s, SMALL_EDIT_TREE, pair)
    cpu, gpu = sessions
    same("the edited segments", gpu.cloud.segment, cpu.cloud.segment)
    same("the edited classes", gpu.cloud.classification,
         cpu.cloud.classification)
    same("the LOD subset", gpu._lod, cpu._lod)
    f_gpu, f_cpu = gpu.render(use_lod=True), cpu.render(use_lod=True)
    diff = int(abs(f_gpu.astype(int) - f_cpu.astype(int)).max())
    if diff > 1:
        raise AssertionError("the card's LOD frame after the edits differs "
                             "from the CPU's by more than 1 per channel")
    hits = 0
    for x, y in ((rcfg.width / 2, rcfg.height / 2), (600.5, 300.0),
                 (700.0, 420.0)):
        got, ref = gpu.pick(x, y), cpu.pick(x, y)
        if (got[0], got[2]) != (ref[0], ref[2]) or not np.isclose(
                got[1], ref[1], rtol=PICK_RTOL, atol=0.0):
            raise AssertionError(f"pick at {x, y}: card {got}, CPU {ref}")
        hits += got[2]
    log(f"  small scene, interactive view: {n_checks} card-vs-CPU checks "
        f"bit-equal (octree, masks, counts, tables, indices, edits, LOD "
        f"subset); LOD frame after the edits within {diff} per channel; "
        f"{hits} of 3 picks hit, ids equal, distances within rtol "
        f"{PICK_RTOL}")


def launch_counter(kernels, totals: dict):
    """``counted(fn, needed, what)``: ``fn()`` and its host-clock ms, with
    the launch counters zeroed before and read after (and added to
    ``totals``); each kernel of ``needed`` must have run."""
    def counted(fn, needed, what):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = kernels.launches()
        for k in needed:
            if got[k] <= 0:
                raise AssertionError(f"{what} launched no {k} kernel")
        for k in totals:
            totals[k] += got[k]
        return out, ms
    return counted


def share_close(got, ref, atol: float) -> tuple[float, float]:
    """(share of rows within ``atol``, largest difference) of two tensors
    whose rows are compared by their largest element difference."""
    d = (got.double().cpu() - ref.double().cpu()).abs()
    if d.dim() > 1:
        d = d.amax(dim=1)
    if not d.numel():
        return 1.0, 0.0
    return float((d <= atol).double().mean()), float(d.max())


def same_neighbours(got, ref) -> tuple[int, int]:
    """(rows whose k-NN index rows differ, of those, rows where the two
    distance rows do not both hold a tie within 4 ulps) for (idx, dist)
    pairs from two runs; a row may differ only at such a tie."""
    (gi, gd), (ri, rd) = [(i.cpu(), d.cpu()) for i, d in (got, ref)]
    rows = torch.nonzero((gi != ri).any(dim=1)).flatten()
    bad = 0
    for r in rows.tolist():
        d = torch.sort(torch.cat([gd[r], rd[r]])).values.double()
        gaps = torch.diff(d[d < 3e38])
        if not gaps.numel() or float(gaps.min()) > 4 * 2.0**-23 * float(d.max()):
            bad += 1
    return len(rows), bad


def rbv_cells_apart(got, ref) -> int:
    """Cells of two RBV distance grids that differ by more than 1e-5 of the
    grid's largest distance."""
    scale = max(float(ref.distances.abs().max()), 1e-6)
    return int(((got.distances.cpu() - ref.distances.cpu()).abs()
                > 1e-5 * scale).sum())


def focus_card_vs_cpu(pts, cfg, segment, cam, pipeline, dev) -> None:
    """The small scene's focused view on the card and on the CPU from the
    same ids: eigen, both k-NNs (bit-equal), ``properties`` (heights
    bit-equal), curvature and normals (FOCUS_ATOL), both axes, the RBVs
    (RBV_EDGE_CELLS), the hull's candidates (equal) and the five displays'
    frames and an overlay frame (within 1 per channel)."""
    from treee_tpu_torch import hull3d, rbv, trunk_axis
    from treee_tpu_torch.ops import eigen, neighbors
    sessions = []
    for d in ("cpu", dev):
        s = pipeline.Session.from_points(pts, cfg, device=d)
        s.cloud = s.cloud.replace(segment=segment.to(d))
        s.characteristics()
        s.camera = cam.to(d)
        sessions.append(s)
    cpu, gpu = sessions
    counts = cpu.table.count.numpy().astype(np.int64)
    counts[0] = 0
    sid = int(np.argmax(counts))
    notes = []

    def both(fn):
        return [fn(s.cloud, s.device) for s in sessions]

    rng = np.random.default_rng(5)
    a = rng.normal(size=(4096, 3, 3)).astype(np.float32)
    mats = torch.from_numpy(np.concatenate([
        a @ a.transpose(0, 2, 1),
        np.einsum("ni,ij->nij", np.abs(a[:, 0]), np.eye(3, dtype=np.float32)),
        a[:, :, :1] @ a[:, :, :1].transpose(0, 2, 1)]))
    scale = mats.abs().amax(dim=(1, 2))
    ev_c, ev_g = eigen.eigvals_sym3(mats), eigen.eigvals_sym3(mats.to(dev))
    if not torch.equal(ev_g[4096:8192].cpu(), ev_c[4096:8192]):
        raise AssertionError("eigen's diagonal branch: card and CPU differ")
    if ((ev_g.cpu() - ev_c).abs().amax(dim=1) > 5e-4 * scale).any():
        raise AssertionError("eigenvalues: card and CPU differ")
    nv = share_close(eigen.smallest_eigenvector(mats.to(dev)),
                     eigen.smallest_eigenvector(mats), FOCUS_ATOL)
    notes.append(f"eigen: diagonal branch bit-equal, eigenvalues within "
                 f"5e-4 of the scale, normals within {FOCUS_ATOL} on "
                 f"{nv[0]:.4f}")

    member = [c.valid & (c.segment == sid) for c in (cpu.cloud, gpu.cloud)]
    rows = torch.nonzero(member[0]).flatten()
    for what, fn in (("knn_bruteforce", neighbors.knn_bruteforce),
                     ("knn_grid", lambda p, v: neighbors.knn_grid(
                         p, v, GRID_CELL))):
        ref = fn(cpu.cloud.pos[rows], torch.ones(len(rows), dtype=torch.bool))
        got = fn(gpu.cloud.pos[rows.to(dev)],
                 torch.ones(len(rows), dtype=torch.bool, device=dev))
        if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
            raise AssertionError(f"{what}: the card and the CPU differ")
    notes.append(f"k-NN of the {len(rows)} points of segment {sid}: brute "
                 "force and grid bit-equal")

    (e_c, h_c), (e_g, h_g) = cpu.properties(), gpu.properties()
    ok, worst = share_close(e_g, e_c, 1e-5)
    if not torch.equal(h_g.cpu(), h_c) or ok < 0.999 or worst > 1e-3:
        raise AssertionError("properties: the card and the CPU differ")
    notes.append(f"properties: heights bit-equal, expansion within 1e-5 on "
                 f"{ok:.5f} (largest {worst:.2g})")
    m = member[0]
    for kind in ("curvature", "normals"):
        got, ref = (getattr(s, kind)(sid) for s in (gpu, cpu))
        ok, worst = share_close(got[m.to(dev)], ref[m], FOCUS_ATOL)
        if ok < FOCUS_MIN_SHARE:
            raise AssertionError(f"{kind}: card and CPU within {FOCUS_ATOL} "
                                 f"on only {ok:.4f} of the members")
        notes.append(f"{kind} within {FOCUS_ATOL} on {ok:.4f} (largest "
                     f"{worst:.3g})")

    axes = {}
    for algo, fn in (("average", trunk_axis.average_direction),
                     ("lowhigh", trunk_axis.low_high_layer)):
        axes[algo] = both(lambda c, d: fn(c.pos, c.valid & (c.segment == sid)
                                          & (c.classification == 1)))
        for f in ("origin", "direction"):
            g, r = (getattr(x, f).cpu() for x in axes[algo][::-1])
            if not torch.allclose(g, r, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{algo} axis {f}: card and CPU differ")
    tfs = [trunk_axis.axis_transform(x) for x in axes["average"]]
    apart = 0
    for method in (rbv.METHOD_MAX, rbv.METHOD_MEAN):
        for frame in (False, True):
            grids = [rbv.split_rbv(c.pos, c.classification,
                                   c.valid & (c.segment == sid),
                                   transform=tf if frame else None,
                                   method=method, symmetric=frame)
                     for c, tf in zip((cpu.cloud, gpu.cloud), tfs)]
            for r, g in zip(*grids):
                n_apart = rbv_cells_apart(g, r)
                apart = max(apart, n_apart)
                if n_apart > RBV_EDGE_CELLS:
                    raise AssertionError(f"RBV (method {method}, frame "
                                         f"{frame}): {n_apart} cells apart")
    notes.append(f"axes within 1e-5; RBVs at most {apart} cells apart")

    crown = [c.valid & (c.segment == sid) & (c.classification == 2)
             for c in (cpu.cloud, gpu.cloud)]
    dirs = torch.from_numpy(hull3d._fibonacci_sphere(512))
    cand = [hull3d.support_candidates(c.pos, m_, dirs.to(c.pos.device))
            for c, m_ in zip((cpu.cloud, gpu.cloud), crown)]
    hulls = [hull3d.convex_hull(c.pos, m_)
             for c, m_ in zip((cpu.cloud, gpu.cloud), crown)]
    if (not torch.equal(cand[1].cpu(), cand[0])
            or hulls[0].volume != hulls[1].volume):
        raise AssertionError("hull candidates: card and CPU differ")
    notes.append(f"hull candidates equal, volume {hulls[0].volume:.3f}")

    worst = 1.0
    for kw in [dict(display=d) for d in pipeline.FOCUS_DISPLAYS] + [
            dict(show_hull=True, show_rbv=True, show_axis=True)]:
        f_c, f_g = cpu.render_focus(sid, **kw), gpu.render_focus(sid, **kw)
        ok = float((np.abs(f_c.astype(int) - f_g.astype(int)).max(-1)
                    <= 1).mean())
        worst = min(worst, ok)
        if ok < 0.999:
            raise AssertionError(f"render_focus({kw}): card and CPU within 1 "
                                 f"on only {ok:.5f} of the pixels")
    notes.append(f"{len(pipeline.FOCUS_DISPLAYS) + 1} focus frames within 1 "
                 f"per channel on >= {worst:.5f} of "
                 "the pixels")
    log(f"  small scene, focused view of segment {sid}: " + "; ".join(notes))


def focus_stages(session, sid, cam, neighbors, eigen, splat) -> dict:
    """Host-clock ms of each stage of an uncached brute-path ``curvature``
    and of a classification focus frame (median of MAIN_PATH_REPS)."""
    from treee_tpu_torch.ops import octree
    cloud = session.cloud
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)
    member = timed("member mask", lambda: session._member_mask(sid))
    cnt = int(member.sum())
    cap = min(octree.snug_capacity(cnt, headroom=1.0), cloud.capacity)
    count, idx = timed("compact_indices", lambda: octree.compact_indices(
        member, cap))
    sub_valid = torch.arange(cap, device=idx.device) < count
    pos = timed("position gather", lambda: cloud.pos[idx])
    nn_idx, nn_d = timed("knn_bruteforce", lambda: neighbors.knn_bruteforce(
        pos, sub_valid))
    cov = timed("neighbor_covariance", lambda: neighbors.neighbor_covariance(
        pos, nn_idx, nn_d < 3e38))
    timed("curvature_from_cov", lambda: eigen.curvature_from_cov(cov))
    timed("smallest_eigenvector", lambda: eigen.smallest_eigenvector(cov))
    prop = torch.full((cap,), 0.375, device=pos.device)
    rcfg = session.config.render
    color, z01, _ = timed("frame: render_points", lambda: splat.render_points(
        pos, prop, sub_valid, cam, session.palette, rcfg))
    img = timed("frame: eye_dome", lambda: splat.eye_dome(color, z01, rcfg))
    timed("frame: to_u8 + copy", lambda: splat.to_u8(img).cpu())
    return stages


def overlay_stages(session, sid, cam, trunk_axis, rbv, splat) -> dict:
    """Host-clock ms of each overlay of a focus frame on the brute path's
    compacted rows (median of MAIN_PATH_REPS)."""
    from treee_tpu_torch import hull3d
    from treee_tpu_torch.render import lines
    cloud, rcfg = session.cloud, session.config.render
    idx, sub_valid = session._compact_member(sid, None, 0)
    pos, cls_ = cloud.pos[idx], cloud.classification[idx]
    member = sub_valid & cloud.valid[idx] & (cloud.segment[idx] == sid)
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)
    axis = timed("average_direction", lambda: trunk_axis.average_direction(
        pos, member & (cls_ == 1)))
    tf = timed("axis_transform", lambda: trunk_axis.axis_transform(axis))
    hull = timed("convex_hull (candidates on the card, qhull)", lambda: (
        hull3d.convex_hull(pos, member & (cls_ == 2))))
    grids = timed("split_rbv", lambda: rbv.split_rbv(pos, cls_, member,
                                                     transform=tf))
    cage = timed("rbv_lines (host)", lambda: rbv.rbv_lines(grids[0]))
    color, z01, _ = splat.render_points(pos, torch.zeros_like(pos[:, 0]),
                                        member, cam, session.palette, rcfg)
    ends = torch.as_tensor(np.concatenate(
        [hull.vertices[hull3d.hull_edges(hull.faces)], cage]), device=pos.device)
    timed(f"lines.overlay ({len(ends)} lines)", lambda: lines.overlay(
        color, z01, ends, cam, rcfg))
    return stages


def raster_stages(session, cell: float, rasters) -> dict:
    """Host-clock ms of each stage of ``Session.rasters(cell)`` as
    ``compute_rasters`` runs them (median of MAIN_PATH_REPS)."""
    from treee_tpu_torch.ops.f32 import full

    cloud = session.cloud
    stages = {}
    timed = stage_timer(stages, MAIN_PATH_REPS)
    live, lo, hi = timed("live mask + bounds to the host",
                         session._live_bounds)
    (rows, cols), shape, cell = rasters.grid_dims(lo, hi, cell)
    pos = cloud.pos
    ground = live & (cloud.classification == rasters.CLASS_GROUND)
    scale = (full(lo[0], pos), full(lo[2], pos), full(1.0 / cell, pos))
    dtm, dsm = timed("height_grids (cell index, scatter-min and -max)",
                     lambda: rasters.height_grids(pos, ground, live, *scale,
                                                  shape, (rows, cols)))
    n_dirs = 8 * len(rasters.jfa_steps(*shape))
    timed(f"jfa_fill {shape[0]}x{shape[1]}, {n_dirs} directions",
          lambda: rasters.jfa_fill(dtm, dtm < rasters.BIG))
    timed("finalize_rasters (the flood, NODATA, window, host copy)",
          lambda: rasters.finalize_rasters(dtm, dsm, rows, cols))
    return stages


def stem(points: np.ndarray) -> np.ndarray:
    """(x, z) of a synthetic tree's stem: the median of its points below
    2 m (its trunk)."""
    return np.median(points[points[:, 1] < 2.0][:, [0, 2]], axis=0)


def nearest_trees(table, sid: int, need: int) -> list[int]:
    """Segment ids nearest to ``sid`` by box centre, as many as bring its
    count past ``need``."""
    lo, hi = table.lo.cpu().numpy(), table.hi.cpu().numpy()
    counts = table.count.cpu().numpy().astype(np.int64)
    centre = (lo + hi) / 2.0
    d = np.hypot(centre[:, 0] - centre[sid, 0], centre[:, 2] - centre[sid, 2])
    order = [int(i) for i in np.argsort(d, kind="stable")
             if i not in (0, sid) and counts[i] > 0]
    chosen, total = [], int(counts[sid])
    for i in order:
        if total > need:
            break
        chosen.append(i)
        total += int(counts[i])
    return chosen


def decode_png(data: bytes) -> np.ndarray:
    """u8[H,W,3] of an RGB8 PNG whose rows all have filter 0, as
    ``io.exports.png_encode`` writes them; anything else raises."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if (depth, ctype) != (8, 2):
                raise AssertionError(f"PNG depth {depth}, colour type {ctype}")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if raw[:, 0].any():
        raise AssertionError("a PNG row has a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def hit_pixels(session, need: int, width: int, height: int) -> list:
    """``need`` pixels of the session's camera whose ray picks a point, each
    of another segment, from a 20-pixel grid over the frame taken nearest
    the centre first (the ground near the camera takes the segment of the
    tree nearest it, so neighbouring rays often share one); as
    ``[(x, y, segment)]``."""
    grid = [(x + 0.5, y + 0.5) for x in range(10, width, 20)
            for y in range(10, height, 20)]
    grid.sort(key=lambda p: (p[0] - width / 2.0) ** 2
              + (p[1] - height / 2.0) ** 2)
    found, seen = [], set()
    for x, y in grid:
        seg, _, hit = session.pick(x, y)
        if hit and seg not in seen:
            seen.add(seg)
            found.append((x, y, seg))
            if len(found) == need:
                return found
    raise AssertionError(f"only {len(found)} of {need} pixels hit a segment")


def ray_hit(session, x: float, y: float) -> np.ndarray:
    """The point a pick through pixel (x, y) hits, on the host."""
    rcfg = session.config.render
    seg, dist, hit = session.pick(x, y)
    if not hit:
        raise AssertionError(f"pixel ({x}, {y}) hits nothing")
    cam = session.camera
    d = cam.ray_direction(x, y, rcfg.width, rcfg.height).cpu().numpy()
    return cam.position.cpu().numpy() + d * dist


def http(port: int, path: str, body: bytes | None = None):
    """(status, headers, body) of a request to the loopback viewer."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers, r.read()


def table_columns_apart(a, b) -> list[str]:
    """The columns of two SegmentTables that differ, floats by their bits."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y.to(x.device)):
            out.append(f.name)
    return out


def same_grids(a: dict, b: dict) -> bool:
    """DTM, DSM and CHM equal bit for bit."""
    return all(np.array_equal(a[k].view(np.int32), b[k].view(np.int32))
               for k in ("dtm", "dsm", "chm"))


def surveys(pts, dev, kernels, counted, modules) -> None:
    """Phase 19 on the card; raises on the first check that fails.

    (a) ``sharded_session_step`` over four shards of the card against the
    one-device step on the 15M scan, and ``sharded_rasters(0.5)`` against
    ``Session.rasters(0.5)``; (b) ``tiled_pipeline`` in 2 tiles over that
    mesh against 2 tiles without it on the scan widened in x; (c)
    ``bench_tiled``'s 100M survey in 4 tiles, its ids held against the
    survey's trees; (d) its rasters in slabs
    against one ``compute_rasters`` of the survey uploaded whole; (e) the
    survey untiled; (f) ``segmented_cummax`` against its plain version at
    the largest tile's and a shard's shapes."""
    (pipeline, rasters, segmentation, sharding, tiles, bench_tiled,
     survey_trees) = modules
    n = len(pts)
    mesh = sharding.make_mesh([dev] * SHARDS)
    cap = -(-n // (1024 * SHARDS)) * (1024 * SHARDS)

    # (a) the sharded step and rasters against the one-device ones
    single = pipeline.Session.from_points(pts, device=dev, capacity=cap)
    one_ms = []
    for _ in range(MAIN_PATH_REPS):
        one, ms = counted(lambda: single.segment(MAX_DISTANCE),
                          MAIN_PATH_KERNELS, "segment()")
        one_ms.append(ms)
    cloud = single.cloud
    pos_s, valid_s = sharding.shard_points(mesh, cloud.pos, cloud.valid)
    step = sharding.sharded_session_step(mesh)
    shard_calls = []
    with swapped(kernels, segmented_cummax=recorder(
            kernels.segmented_cummax, shard_calls)):
        counted(lambda: step(pos_s, valid_s, MAX_DISTANCE), MAIN_PATH_KERNELS,
                "sharded_session_step")
    sh_ms = []
    for _ in range(MAIN_PATH_REPS):
        (seg_s, cls_s, table, res), ms = counted(
            lambda: step(pos_s, valid_s, MAX_DISTANCE), MAIN_PATH_KERNELS,
            "sharded_session_step")
        sh_ms.append(ms)
        apart = table_columns_apart(table, single.table)
        if not (torch.equal(torch.cat(seg_s), cloud.segment)
                and torch.equal(torch.cat(cls_s), cloud.classification)
                and not apart
                and int(res.n_segments) == int(one.n_segments)
                and torch.equal(res.tracked_pos, one.tracked_pos)
                and bool(res.occupied_overflow) == bool(
                    one.occupied_overflow)):
            raise AssertionError("the sharded step differs from the "
                                 f"one-device step (table columns {apart})")
    log(f"  sharded_session_step over {SHARDS} shards of {cap // SHARDS} rows"
        f" on {dev}: ids, classes and every table column equal the "
        f"one-device step's bit for bit ({int(res.n_segments)} segments); "
        f"host clock median {statistics.median(sh_ms):.1f} ms "
        f"{[round(t, 1) for t in sh_ms]} against one device "
        f"{statistics.median(one_ms):.1f} ms {[round(t, 1) for t in one_ms]}")
    (grids, _, cell), r_ms = counted(lambda: single.rasters(0.5),
                                     ("jump_flood_grid",), "rasters(0.5)")
    live = cloud.alive
    lo, hi = (a.cpu().numpy()
              for a in segmentation.scene_bounds(cloud.pos, live))
    (s_grids, _, s_cell), sr_ms = counted(
        lambda: sharding.sharded_rasters(
            mesh, pos_s, sharding.split(mesh, cloud.classification),
            sharding.split(mesh, live), lo, hi, 0.5),
        ("jump_flood_grid",), "sharded_rasters(0.5)")
    if not (s_cell == cell and same_grids(s_grids, grids)):
        raise AssertionError("sharded_rasters(0.5) differs from "
                             "Session.rasters(0.5)")
    log(f"  sharded_rasters(0.5): DTM, DSM and CHM equal Session.rasters"
        f"(0.5)'s bit for bit; {sr_ms:.2f} ms against {r_ms:.2f} ms")
    del single, one, cloud, pos_s, valid_s, seg_s, cls_s, table, res, live

    # (b) tiles over the mesh against tiles without it
    wide = pts.copy()
    wide[:n // 2, 0] -= WIDEN_X
    (t_seg, t_cls, _, t_info), t_ms = counted(
        lambda: tiles.tiled_pipeline(wide, 2, MAX_DISTANCE, device=dev),
        MAIN_PATH_KERNELS, "tiled_pipeline")
    (m_seg, m_cls, _, m_info), m_ms = counted(
        lambda: tiles.tiled_pipeline(wide, 2, MAX_DISTANCE, mesh=mesh),
        MAIN_PATH_KERNELS, "tiled_pipeline(mesh=...)")
    if not (np.array_equal(t_seg, m_seg) and np.array_equal(t_cls, m_cls)
            and t_info["owners"] == m_info["owners"]
            and t_info["n_alloc"] == m_info["n_alloc"]):
        raise AssertionError("2 tiles over the mesh differ from 2 tiles "
                             "without it")
    log(f"  tiled_pipeline(2 tiles) of the scan widened by {WIDEN_X:.0f} m: "
        f"{t_info['n_segments']} segments, capacity {t_info['capacity']} "
        f"({m_info['capacity']} over the mesh), n_alloc {t_info['n_alloc']},"
        f" overflow {t_info['occupied_overflow']}; over the mesh the same "
        f"ids, classes and owners; {t_ms / 1e3:.2f} s, over the mesh "
        f"{m_ms / 1e3:.2f} s (tiles {[round(a + b, 2) for a, b in m_info['tile_times']]}"
        f" s against {[round(a + b, 2) for a, b in t_info['tile_times']]} s)")
    del wide, t_seg, t_cls, m_seg, m_cls

    # (c) tools/bench_tiled.py's survey through the port's tool code
    pts100, gen_s = bench_tiled.survey(SURVEY_POINTS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tile_calls = []
    with swapped(kernels, segmented_cummax=recorder(
            kernels.segmented_cummax, tile_calls)):
        (record, seg100, cls100, info), _ = counted(
            lambda: bench_tiled.measure(pts100, SURVEY_TILES, dev, gen_s),
            MAIN_PATH_KERNELS, "the tiled survey")
    peak = torch.cuda.max_memory_allocated() / 2**30
    kept = sum(a.numel() * a.element_size() for _, args in tile_calls
               for a in args if torch.is_tensor(a)) / 2**30
    log(f"  bench_tiled {json.dumps(record)}")
    log(f"  the survey: {len(pts100)} points in {gen_s:.1f} s; x sort "
        f"{info['sort_s']:.2f} s; tiles (slice, run+fetch) s "
        f"{[(round(a, 2), round(b, 2)) for a, b in info['tile_times']]}; "
        f"reconcile {info['reconcile_s']:.2f} s; wall {record['wall_s']} s, "
        f"{record['value']} Mpts/s; n_alloc per tile {info['n_alloc']} of "
        f"{pipeline.DEFAULT_CONFIG.segmentation.max_segments}, overflow "
        f"{info['occupied_overflow']}; {info['n_segments']} segments, "
        f"labelled share {record['labeled_frac']}; peak device memory "
        f"{peak:.2f} GiB, of it {kept:.2f} GiB the recorded cummax inputs")
    n_trees = int(len(pts100) * 0.75) // bench_tiled.POINTS_PER_TREE
    trees = survey_trees.report(pts100, seg100, info, n_trees,
                                bench_tiled.POINTS_PER_TREE)
    log(f"  segments against the survey's trees: {json.dumps(trees)}")
    max_segments = pipeline.DEFAULT_CONFIG.segmentation.max_segments
    # every point labelled and no tile at a cap.  The ids within [0.75, 1]
    # x the trees: the band cap of 256 clusters leaves about one tree in
    # eight of a tile without a slot of its own, and the tiles allocate
    # more ids than there are trees, so a reconcile that joins nothing ends
    # above.  A tree cut by a core edge takes its two sides' ids from two
    # tiles: a reconcile that joins nothing gives them no id in common, a
    # working one about as often as a tree cut mid-core in one tile (less
    # where a tile split the tree and only one piece joins)
    if not ((seg100 > 0).all()
            and not any(info["occupied_overflow"])
            and max(info["n_alloc"]) < max_segments
            and 0.75 * n_trees <= info["n_segments"] <= n_trees
            and info["n_segments"] < sum(info["n_alloc"])
            and trees["edge_trees"] > 0
            and trees["edge_agreement"] >= 0.5 * trees["mid_agreement"]):
        raise AssertionError("the tiled survey's ids do not hold")

    # (d) its rasters in slabs against one compute_rasters of it whole
    (t_grids, t_dims, t_cell), tr_ms = counted(
        lambda: tiles.tiled_rasters(pts100, cls100, cell=SURVEY_CELL,
                                    slab=SURVEY_SLAB, device=dev),
        ("jump_flood_grid",), "tiled_rasters")
    t0 = time.perf_counter()
    lo, hi = pts100.min(axis=0), pts100.max(axis=0)
    bounds_s = time.perf_counter() - t0
    pos_t = torch.from_numpy(pts100).to(dev)
    cls_t = torch.from_numpy(cls100).to(dev)
    (w_grids, w_dims, w_cell), wr_ms = counted(
        lambda: rasters.compute_rasters(
            pos_t, cls_t, torch.ones(len(pts100), dtype=torch.bool,
                                     device=dev), lo, hi, SURVEY_CELL),
        ("jump_flood_grid",), "compute_rasters")
    if not (t_dims == w_dims and t_cell == w_cell
            and same_grids(t_grids, w_grids)):
        raise AssertionError("tiled_rasters differs from compute_rasters")
    _, (fh, fw), _ = rasters.grid_dims(lo, hi, SURVEY_CELL)
    log(f"  tiled_rasters: its flood over the padded {fh}x{fw} grid runs "
        "over tiles in "
        f"{kernels.jump_flood_grid_launches(fh, fw, rasters.jfa_steps(fh, fw))}"
        " CUDA launch(es) a call by its design")
    log(f"  tiled_rasters(cell={SURVEY_CELL}, {-(-len(pts100) // SURVEY_SLAB)}"
        f" slabs): {t_dims[0]}x{t_dims[1]} cells, bit-equal to one "
        f"compute_rasters of the survey on the card; {tr_ms / 1e3:.2f} s "
        f"(host slabs) against {wr_ms / 1e3:.2f} s (survey already on the "
        f"card); the survey's bounds on the host, which tiled_rasters also "
        f"takes, {bounds_s:.2f} s")
    del pos_t, cls_t, seg100, cls100

    # (e) the survey untiled
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = pipeline.Session.from_points(pts100, device=dev)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    res, u_ms = counted(lambda: whole.segment(MAX_DISTANCE),
                        MAIN_PATH_KERNELS, "segment() of the survey untiled")
    peak = torch.cuda.max_memory_allocated() / 2**30
    labelled = float((whole.cloud.segment[whole.cloud.valid] > 0).float()
                     .mean())
    log(f"  the survey untiled: from_points {up_s:.2f} s; segment(0.75) "
        f"{u_ms:.1f} ms; n_alloc {int(res.n_segments)}, overflow "
        f"{bool(res.occupied_overflow)}, labelled share {labelled:.4f}; peak "
        f"device memory {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    del whole, res, pts100

    # (f) the cummax at the largest tile's and a shard's shapes
    check_kernel("segmented_cummax", kernels, tile_calls + shard_calls)


def mesh_session(pts, dev, counted, modules) -> None:
    """Phase 20 on the card: one ``Session`` over a mesh of four shards of
    the card against a one-device ``Session`` fed the mesh session's rows at
    its capacity; raises on the first check that fails."""
    pipeline, sharding, rbv, trunk_axis, repl, serve, Camera = modules
    n = len(pts)
    mesh = sharding.make_mesh([dev] * SHARDS)
    times = {}

    def one_way(what, fn, needed=()):
        out, ms = counted(fn, needed, what)
        times.setdefault(what, []).append(ms)
        return out

    sm = one_way("from_points(mesh=...)",
                 lambda: pipeline.Session.from_points(pts, mesh=mesh))
    rows = sm.cloud.to_numpy()["pos"]
    one = one_way("from_points", lambda: pipeline.Session.from_points(
        rows, device=dev, capacity=sm.cloud.capacity))
    del rows
    log(f"  Session.from_points over {SHARDS} shards of {sm.cloud.rows} rows"
        f" of the card (rows in Morton order, capacity {sm.cloud.capacity}):"
        f" {times['from_points(mesh=...)'][0] / 1e3:.2f} s; the one-device "
        f"twin on its rows and capacity {times['from_points'][0] / 1e3:.2f} s")

    def both(what, fn, needed=()):
        """``fn`` of the mesh session, then of its twin, each counted and
        timed."""
        return (one_way(f"{what} over the mesh", lambda: fn(sm), needed),
                one_way(what, lambda: fn(one), needed))

    def same_cloud() -> bool:
        return all(torch.equal(sharding.gather(sm.cloud.column(k)),
                               getattr(one.cloud, k))
                   for k in ("segment", "classification"))

    # (a) the step, the table, full_table
    for _ in range(2):
        got, ref = both("segment(0.75)", lambda s: s.segment(MAX_DISTANCE),
                        MAIN_PATH_KERNELS)
        apart = table_columns_apart(sm.table, one.table)
        if not (same_cloud() and not apart
                and int(got.n_segments) == int(ref.n_segments)):
            raise AssertionError(f"segment(0.75) over the mesh differs from "
                                 f"one device's (table columns {apart})")
    for what in ("characteristics", "full_table"):
        both(f"{what}()", lambda s: getattr(s, what)(),
             ("segmented_cummax",) if what == "characteristics" else ())
        apart = table_columns_apart(sm.table, one.table)
        if apart or not same_cloud():
            raise AssertionError(f"{what}() over the mesh differs from one "
                                 f"device's ({apart})")
    log(f"  segment(0.75): {int(ref.n_segments)} segments; ids, classes and "
        "every table column equal the one-device session's bit for bit; "
        "so do characteristics() and full_table()")

    # (b) the full frames over bench.py's orbit
    cams = orbit_cameras(Camera, dev)
    for cam in cams:
        got, ref = both("render", lambda s: s.render(cam), FRAME_KERNELS)
        if not np.array_equal(got, ref):
            raise AssertionError("a frame over the mesh differs from one "
                                 "device's")
    log(f"  render over the {len(cams)} orbit cameras: byte-equal frames")

    # (c) the LOD and the screen-adaptive cut, the tau solver, LOD frames
    def same_lod() -> bool:
        return (torch.equal(sm._lod[1], one._lod[1])
                and int(sm._lod[2]) == int(one._lod[2])
                and torch.equal(sm._lod[0], one._lod[0]))

    both("build_lod(level=7)", lambda s: s.build_lod())
    if not same_lod():
        raise AssertionError("build_lod(level=7): other indices over the "
                             "mesh")
    lod7 = int(one._lod[2])
    trees = sm._tree
    tau, tau_one = both("solve_adaptive_tau",
                        lambda s: s.solve_adaptive_tau(budget_rows=n // 2,
                                                       camera=cams[0]))
    if tau != tau_one:
        raise AssertionError(f"solve_adaptive_tau: {tau} over the mesh, "
                             f"{tau_one} on one device")
    both("build_lod(adaptive)",
         lambda s: s.build_lod(camera=cams[0], adaptive_tau_px=tau))
    if not same_lod():
        raise AssertionError("the adaptive cut: other indices over the mesh")
    for cam in cams:
        got, ref = both("render(use_lod=True)",
                        lambda s: s.render(cam, use_lod=True), FRAME_KERNELS)
        if not np.array_equal(got, ref):
            raise AssertionError("an LOD frame over the mesh differs")
    log(f"  build_lod(level=7): {lod7} rows; solve_adaptive_tau(budget "
        f"{n // 2}) = {tau}; its cut {int(one._lod[2])} rows; the same "
        "indices, positions and LOD frames as one device's")

    # (d) strokes: delete, draw, spawn, combine; each with its LOD frame
    sid = int(torch.argmax(one.table.count[1:])) + 1
    for i, c in enumerate(EDIT_CENTERS):
        kind = ("delete_sphere", "draw_sphere", "spawn", "combine")[i % 4]
        if kind == "delete_sphere":
            both(kind, lambda s: s.delete_sphere(c, EDIT_RADIUS))
        elif kind == "draw_sphere":
            both(kind, lambda s: s.draw_sphere(c, sid, EDIT_RADIUS,
                                               include_deleted=True))
        elif kind == "spawn":
            nid, nid_one = both(kind, lambda s: s.spawn(c, EDIT_RADIUS))
            if nid != nid_one:
                raise AssertionError(f"spawn: id {nid}, one device {nid_one}")
        else:
            both(kind, lambda s: s.combine(nid, sid))
        got, ref = both("stroke frame", lambda s: s.render(use_lod=True),
                        FRAME_KERNELS)
        if not (same_cloud() and np.array_equal(got, ref)):
            raise AssertionError(f"stroke {i} ({kind}): ids or the LOD "
                                 "frame differ over the mesh")
    if sm._tree is not trees:
        raise AssertionError("the strokes rebuilt the shards' octrees")
    log(f"  {len(EDIT_CENTERS)} strokes (delete, draw, spawn, combine): ids, "
        "classes and LOD frames equal after each; the shards' octrees kept")

    # (e) pick, from the REPL's camera outside the stand
    rcfg = one.config.render
    for s in (sm, one):
        s.camera = Camera.orbital(distance=REPL_ORBIT, device=dev)
    for x, y, _ in hit_pixels(one, MESH_PICKS, rcfg.width, rcfg.height):
        got, ref = both("pick", lambda s: s.pick(x, y))
        if not (got[0] == ref[0] and got[2] == ref[2]
                and np.float32(got[1]).view(np.int32)
                == np.float32(ref[1]).view(np.int32)):
            raise AssertionError(f"pick({x}, {y}): {got} over the mesh, "
                                 f"{ref} on one device")
    log(f"  pick at {MESH_PICKS} hit pixels: the same segments, hits and "
        "distance bits")

    # (f) rasters
    (got, corner, _), (ref, corner_one, _) = both(
        "rasters(0.5)", lambda s: s.rasters(0.5), ("jump_flood_grid",))
    if not (same_grids(got, ref) and corner == corner_one):
        raise AssertionError("rasters(0.5) over the mesh differ")
    log("  rasters(0.5): DTM, DSM and CHM equal bit for bit")

    # (g) both inventory forms.  Their traits bin each segment's points in
    # its axis frame, and an axis whose float sums (per shard, then in
    # shard order) differ in the last bits can move a point across a
    # sector or slice edge: so the axes over the mesh are held to one
    # device's within MESH_AXIS_TOL, and the mesh's traits to the
    # one-device RBVs and traits through the mesh's own frames (after the
    # strokes, full_table() first re-derives the classes the axes read)
    for s in (sm, one):
        s.full_table()
    n_seg = one.table.present.shape[0]
    cols_s = [sm.cloud.column(k)
              for k in ("pos", "segment", "classification", "valid")]
    live_s = [v & (g > 0) for g, v in zip(cols_s[1], cols_s[3])]
    live = one.cloud.valid & (one.cloud.segment > 0)
    mesh_axes, axis_apart = {}, 0.0
    for form, extra in (("average_direction", 10), ("low_high_layer", 1.0)):
        alone = getattr(trunk_axis, f"batched_{form}")(
            one.cloud.pos, live & (one.cloud.classification == 1),
            one.cloud.segment, n_seg)
        axes = sharding.run(mesh, [
            getattr(trunk_axis, f"batched_{form}_shard")(
                p, m & (c == 1), g, n_seg, extra, True)
            for p, g, c, m in zip(cols_s[0], cols_s[1], cols_s[2], live_s)])[0]
        if not (torch.equal(axes.found, alone.found)
                and torch.equal(axes.origin[:, 1], alone.origin[:, 1])
                and torch.allclose(axes.direction, alone.direction,
                                   rtol=MESH_AXIS_TOL, atol=MESH_AXIS_TOL)):
            raise AssertionError(f"the {form} axes over the mesh differ")
        axis_apart = max(axis_apart, float(
            (axes.direction - alone.direction).abs().max()))
        mesh_axes[form] = axes
    trunk_cols = ("stem_easting", "stem_northing")
    apart = {}
    for kw in INVENTORY_CALLS:
        got, ref = both("inventory", lambda s: s.inventory(**kw),
                        INVENTORY_KERNELS)
        floats = trunk_cols + tuple(rbv.TRAITS)
        exact = same_columns({k: v for k, v in got.items()
                              if k not in floats},
                             {k: v for k, v in ref.items() if k not in floats})
        exact += [k for k in trunk_cols if not np.allclose(
            got[k], ref[k], rtol=MESH_RTOL, atol=MESH_ATOL)]
        method = (rbv.METHOD_MEAN if kw.get("method") == "mean"
                  else rbv.METHOD_MAX)
        axes = mesh_axes["low_high_layer" if kw.get("axis_algo") == "lowhigh"
                         else "average_direction"]
        through = rbv.batched_traits(*rbv.batched_split_rbv(
            one.cloud.pos, one.cloud.classification, live, one.cloud.segment,
            n_seg, trunk_axis.batched_axis_transform(axes), method=method,
            symmetric=kw.get("symmetric", False)))
        ids = got["segment"]
        for k in rbv.TRAITS:
            want = getattr(through, k).cpu().numpy()[ids].astype(np.float64)
            if not (np.array_equal(got[k], want) if method == rbv.METHOD_MAX
                    else np.allclose(got[k], want, rtol=MESH_RBV_TOL,
                                     atol=MESH_ATOL)):
                exact.append(k)
            rel = np.abs(got[k] - ref[k]) / (np.abs(ref[k]) + MESH_ATOL)
            n_out, top = apart.get(k, (0, 0.0))
            apart[k] = (max(n_out, int((rel > MESH_RTOL).sum())),
                        max(top, float(rel.max())))
        if exact:
            raise AssertionError(f"inventory({kw}) over the mesh differs in "
                                 f"{exact}")
    log(f"  inventory() in both forms: {len(got['segment'])} trees; counts, "
        "ids, boxes, heights, separators and axis_found equal, stem positions"
        f" within rtol {MESH_RTOL}; the axes over the shards within "
        f"{axis_apart:.2e} of one device's; the traits equal the one-device "
        "RBVs' through the mesh's axes (max grids bit for bit, mean within "
        f"rtol {MESH_RBV_TOL}); against one device's own traits (trees past "
        "rtol 1e-4 of the worse form, largest relative difference): "
        + ", ".join(f"{k} {n} {r:.2e}" for k, (n, r) in apart.items()))

    # (h) the largest tree's focused view
    sid = int(torch.argmax(one.table.count[1:])) + 1
    for kind in ("curvature", "normals"):
        got, ref = both(kind, lambda s: getattr(s, kind)(sid))
        if not torch.equal(sharding.gather(got), ref):
            raise AssertionError(f"{kind}({sid}) over the mesh differs")
    centre = one.cloud.pos[one._member_mask(sid)].mean(dim=0)
    eye = np.eye(4, dtype=np.float32)
    eye[:3, 3] = centre.cpu().numpy() + [0.0, 0.0, FOCUS_DISTANCE]
    focus_cam = Camera.from_numpy(eye, FOCUS_DISTANCE, device=dev)
    got, ref = both("render_focus", lambda s: s.render_focus(
        sid, focus_cam, show_hull=True, show_axis=True), FRAME_KERNELS)
    if not np.array_equal(got, ref):
        raise AssertionError("render_focus with hull and axis differs over "
                             "the mesh")
    log(f"  segment {sid}: curvature and normals equal bit for bit, "
        "render_focus with the hull and the axis byte for byte")

    # (i) a REPL and the viewer over the mesh session
    texts = []
    tmp = tempfile.mkdtemp(prefix="treee_mesh_")
    for s in (sm, one):
        r = repl.Repl(s, out=io.StringIO())
        for line in MESH_REPL:
            t0 = time.perf_counter()
            r.handle(line.format(png=os.path.join(tmp, "frame.png")))
            torch.cuda.synchronize()
            times.setdefault(f"repl {line}" + (" over the mesh" if s is sm
                                              else ""), []).append(
                (time.perf_counter() - t0) * 1e3)
        texts.append(r.out.getvalue().replace(tmp, "TMP"))
    shutil.rmtree(tmp, ignore_errors=True)
    num = r"-?\d+\.\d+(?:e[-+]?\d+)?"
    if ("error" in texts[0] or re.split(num, texts[0])
            != re.split(num, texts[1]) or not same_cloud()):
        raise AssertionError(f"the REPL over the mesh: {texts[0]!r} against "
                             f"{texts[1]!r}")
    viewer = serve.ViewerServer(sm, port=0)
    viewer.serve_background()
    try:
        _, _, body = http(viewer.port, "/info")
        info = json.loads(body)
        _, _, png = http(viewer.port, "/frame.png")
        frame = decode_png(png)
        _, _, body = http(viewer.port, "/cmd", b"status")
    finally:
        viewer.shutdown()
    if not (info["points"] == n and json.loads(body)["ok"]
            and frame.shape == (rcfg.height, rcfg.width, 3)):
        raise AssertionError(f"the viewer over the mesh: {info}, "
                             f"{frame.shape}")
    log(f"  a REPL ({len(MESH_REPL)} commands) prints what it prints over "
        "the one-device session and leaves the same ids; the viewer over the"
        f" mesh serves /info ({info['points']} points), a frame and commands")
    for what, ms in times.items():
        log(f"  time {what}: median {statistics.median(ms):.2f} ms of "
            f"{len(ms)} {[round(t, 2) for t in ms]}")
    del sm, one

    # (j) a mesh over several cards, where the machine has them
    if torch.cuda.device_count() > 1:
        cards = sharding.make_mesh()
        sc = pipeline.Session.from_points(pts, mesh=cards)
        sc_one = pipeline.Session.from_points(
            sc.cloud.to_numpy()["pos"], device=dev,
            capacity=sc.cloud.capacity)
        sc.segment(MAX_DISTANCE)
        sc_one.segment(MAX_DISTANCE)
        ok = (torch.equal(sharding.gather(sc.cloud.column("segment")),
                          sc_one.cloud.segment)
              and np.array_equal(sc.render(cams[0]), sc_one.render(cams[0])))
        log(f"  over make_mesh() ({cards.size} cards): ids and a frame "
            f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("the mesh over several cards differs")
    else:
        log("  a mesh over several cards: not run, torch sees one card")


def front_ends(src: str, n: int, tmp: str, dev, counted, pipeline,
               Camera) -> None:
    """Phase 18: the CLI, the REPL and the browser viewer on the scan that
    phase 17 wrote, on the card; raises on the first check that fails."""
    from treee_tpu_torch import app, serve
    from treee_tpu_torch import repl as repl_mod
    from treee_tpu_torch.io import exports
    from treee_tpu_torch.utils import profiling

    # (a) the CLI: the session it builds, built here the same way
    out = os.path.join(tmp, "cli")
    frames_dir = os.path.join(out, "frames")
    os.makedirs(out)
    ref, ms = counted(lambda: pipeline.Session.from_las(src, device=dev), (),
                      "from_las")
    res, seg_ms = counted(lambda: ref.segment(MAX_DISTANCE),
                          MAIN_PATH_KERNELS, "segment()")
    n_seg = int(res.n_segments)
    counts = ref.table.count.cpu().numpy().astype(np.int64)
    counts[0] = 0
    sid = int(np.argmax(counts))
    argv = [src, "--frames", str(N_FRAMES), "--out-dir", frames_dir,
            "--export-info", os.path.join(out, "info.json"),
            "--export-inventory", os.path.join(out, "inv.csv"),
            "--export-summary", os.path.join(out, "summary.json"),
            "--export-chm", os.path.join(out, "chm.asc"),
            "--segment-id", str(sid),
            "--export-traits", os.path.join(out, "traits.json"),
            "--export-hull-ply", os.path.join(out, "hull.ply"),
            "--export-rbv", os.path.join(out, "rbv.json"), "-v"]
    args = app.build_parser().parse_args(argv)
    if app.build_config(args) != ref.config:
        raise AssertionError("the CLI's configuration is not the default")
    profiling.reset()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, cli_ms = counted(lambda: app.main(argv),
                             MAIN_PATH_KERNELS + FRAME_KERNELS
                             + ("jump_flood_grid",), "the CLI")
    text = printed.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if rc != 0 or f"segments: {n_seg}\n" not in text:
        raise AssertionError(f"the CLI returned {rc} and did not print "
                             f"segments: {n_seg}")
    cam = Camera.orbital(distance=args.orbit_distance, device=dev)
    for i in range(N_FRAMES):
        cam = cam.rotate_orbital(2 * np.pi / N_FRAMES / 0.002, 0.0)
        with open(os.path.join(frames_dir, f"frame_{i:03d}.png"), "rb") as fh:
            got = decode_png(fh.read())
        if not np.array_equal(got, ref.render(cam)):
            raise AssertionError(f"the CLI's frame {i} differs from "
                                 "Session.render at its camera")
    inv_ref = io.StringIO()
    exports.save_inventory_csv(inv_ref, ref.inventory(
        **app._inventory_kwargs(args)))
    with open(os.path.join(out, "inv.csv")) as fh:
        if fh.read() != inv_ref.getvalue():
            raise AssertionError("the CLI's inventory CSV differs from "
                                 "save_inventory_csv(Session.inventory())")
    chm_ref = os.path.join(out, "chm_ref.asc")
    ref.export_raster(chm_ref, "chm", cell=args.raster_cell)
    with open(os.path.join(out, "chm.asc"), "rb") as a, \
            open(chm_ref, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the CLI's chm.asc differs from "
                                 "Session.export_raster('chm')")
    with open(os.path.join(out, "info.json")) as fh:
        info = json.load(fh)
    with open(os.path.join(out, "traits.json")) as fh:
        traits = json.load(fh)
    with open(os.path.join(out, "rbv.json")) as fh:
        rbv = json.load(fh)
    present = int(ref.table.present.sum())
    if not (len(info) == present and list(traits) == [str(sid)]
            and all(np.isfinite(v) for v in traits[str(sid)].values())
            and np.isfinite(rbv["distances"]).all()):
        raise AssertionError("the CLI's info, traits or RBV export is off")
    phases: dict[str, float] = {}
    for r in profiling.records():
        if r["parent"] is None:     # the CLI's phases
            phases[r["name"]] = phases.get(r["name"], 0.0) + r["host_s"]
    log(f"  CLI: {cli_ms / 1e3:.2f} s, rc 0, {n_seg} segments as "
        f"from_las ({ms / 1e3:.2f} s) + segment ({seg_ms:.1f} ms) give; "
        f"{N_FRAMES} PNG frames byte-equal to Session.render, the inventory "
        f"CSV and chm.asc byte-equal to the session's own; info of "
        f"{len(info)} segments, traits, hull and RBV of segment {sid}; "
        "spans: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in phases.items()))

    # (a') --save and reopen on a small scene
    small = os.path.join(tmp, "small")
    ckpt = os.path.join(small, "demo.npz")
    os.makedirs(small)
    with contextlib.redirect_stdout(io.StringIO()):
        rc1, save_ms = counted(lambda: app.main(
            ["--demo", "--save", ckpt, "--frames", "1", "--out-dir",
             os.path.join(small, "a")]), MAIN_PATH_KERNELS + FRAME_KERNELS,
            "the CLI's --demo --save")
        rc2, open_ms = counted(lambda: app.main(
            [ckpt, "--no-segment", "--frames", "1", "--out-dir",
             os.path.join(small, "b")]), FRAME_KERNELS,
            "the CLI's reopen")
    with open(os.path.join(small, "a", "frame_000.png"), "rb") as a, \
            open(os.path.join(small, "b", "frame_000.png"), "rb") as b:
        same = a.read() == b.read()
    if (rc1, rc2) != (0, 0) or not same:
        raise AssertionError(f"--save + reopen: rc {rc1}, {rc2}; frames "
                             f"{'equal' if same else 'differ'}")
    log(f"  CLI --demo --save {save_ms / 1e3:.2f} s, reopen --no-segment "
        f"--frames 1 {open_ms / 1e3:.2f} s: the reopened frame is the "
        "first run's, byte for byte")

    # (b) the REPL over the session, against the same Session calls made
    # directly on a second session built the same way; the default camera
    # stands inside the forest, a tree filling its view, so the script
    # first backs off to see the stand's edge
    par = pipeline.Session.from_las(src, device=dev)
    par.segment(MAX_DISTANCE)
    par.camera = Camera.orbital(distance=REPL_ORBIT, device=dev)
    rcfg = ref.config.render
    r = repl_mod.Repl(ref, out=io.StringIO())
    previews = []
    r.preview_hook = previews.append
    times = []

    def run(line, needed=()):
        _, line_ms = counted(lambda: r.handle(line), needed, line)
        times.append((line, line_ms))

    run(f"camera orbit {REPL_ORBIT}")
    (px, py, seg_p), (qx, qy, seg_q), (dx, dy, _) = hit_pixels(
        ref, 3, rcfg.width, rcfg.height)
    png = os.path.join(tmp, "repl.png")
    run(f"render {png}", FRAME_KERNELS)
    if not (r.use_lod and r.view_path.startswith("adaptive(tau=")):
        raise AssertionError(f"the auto view took {r.view_path} at {n} "
                             "points")
    run(f"event down left {px} {py}")
    run(f"event up left {px} {py}")
    if r.selected != par.pick(px, py)[0] or r.selected != seg_p:
        raise AssertionError(f"the click selected {r.selected}, "
                             f"Session.pick gives {par.pick(px, py)[0]}")
    run("mode combine")
    for x, y in ((px, py), (qx, qy)):
        run(f"event down left {x} {y}")
        run(f"event up left {x} {y}")
    par.combine(par.pick(qx, qy)[0], par.pick(px, py)[0])
    run("mode delete")
    strokes = [(dx, dy), (dx + 3, dy), (dx + 6, dy)]
    run(f"event down right {dx} {dy}")
    for x, y in strokes[1:]:
        run(f"event move {x} {y}")
    run(f"event up right {dx + 6} {dy}")
    for x, y in strokes:
        par.delete_sphere(ray_hit(par, x, y))
    if not (torch.equal(r.s.cloud.segment, par.cloud.segment)
            and torch.equal(r.s.cloud.classification,
                            par.cloud.classification)):
        raise AssertionError("the REPL's edits give other ids or classes "
                             "than the same Session calls")
    run("mode view")
    run("event down left 100 100")
    run("event move 140 110")
    run("event move 180 120")
    if not r._lod_dirty:
        raise AssertionError("a drag left the adaptive subset fresh")
    run("event up left 180 120")
    # each move: 40 and 10 pixels of f32 mouse travel, times rotate_scale 4
    step = np.float32(40.0) * 4.0, np.float32(10.0) * 4.0
    want = Camera.orbital(REPL_ORBIT, device=dev).rotate_orbital(*step)
    want = want.rotate_orbital(*step)
    if not torch.equal(r.s.camera.transform, want.transform):
        raise AssertionError("the drag gave another camera than "
                             "rotate_orbital")
    run(f"render {png}", FRAME_KERNELS)
    for line in ("lod level 7", "lod adaptive", "display hag",
                 "display intensity"):
        run(line)
        run(f"render {png}", FRAME_KERNELS)
    run("display classification")
    run("overlay hull on")
    run(f"focusrender {png}", FRAME_KERNELS)
    run("distance 0.5", MAIN_PATH_KERNELS)
    par.segment(0.5)
    if len(previews) != 1 or not torch.equal(r.s.cloud.segment,
                                             par.cloud.segment):
        raise AssertionError(f"distance 0.5: {len(previews)} previews; ids "
                             "differ from Session.segment(0.5)")
    ex, ey, seg_e = hit_pixels(r.s, 1, rcfg.width, rcfg.height)[0]
    run(f"event down left {ex} {ey}")
    run(f"event up left {ex} {ey}")
    for line in ("info", "traits", "summary"):
        run(line)
    ply = os.path.join(tmp, "selected.ply")
    run(f"export ply {ply}", ("segmented_cummax",))
    run("quit")
    text = r.out.getvalue()
    with open(ply) as fh:
        n_ply = int(fh.read(400).split("element vertex ")[1].split("\n")[0])
    member = int((r.s.cloud.valid & (r.s.cloud.segment == seg_e)).sum())
    if "error:" in text or r.selected != seg_e or n_ply != member:
        raise AssertionError(f"the REPL printed an error or exported "
                             f"{n_ply} of {member} points:\n{text}")
    log(f"  REPL: {len(times)} commands, no error, ids and classes after "
        "the click, combine and delete strokes equal the same Session calls,"
        " the drag's camera rotate_orbital's, distance 0.5's ids "
        "segment(0.5)'s; each command's host-clock ms after a synchronize:")
    for line, line_ms in times:
        log(f"    {line.replace(tmp + os.sep, '')}: {line_ms:.1f}")
    del par

    # (c) the browser viewer over the session
    v = serve.ViewerServer(r.s, port=0)
    http_thread = v.serve_background()
    try:
        status, _, page = http(v.port, "/")
        _, _, body = http(v.port, "/info")
        info = json.loads(body)
        if status != 200 or b"/frame.png" not in page \
                or info["points"] != n:
            raise AssertionError(f"viewer page {status}, info {info}")
        t0 = time.perf_counter()
        _, hdr, body = http(v.port, "/frame.png")
        first_ms = (time.perf_counter() - t0) * 1e3
        _, _, raw = http(v.port, "/frame.rgb")
        vr = v.repl
        with v.lock:
            want = vr.s.render(use_lod=vr.use_lod,
                               show_deleted=vr.show_deleted)
        if not (np.array_equal(decode_png(body), want)
                and raw == want.tobytes()):
            raise AssertionError("the viewer's frame differs from "
                                 "Session.render on its view path")
        renders = []
        draw = v._frame_img_locked
        v._frame_img_locked = lambda focus=False: (renders.append(1),
                                                   draw(focus))[1]
        seq = v.frame_seq
        burst = (["event down left 300 300"]
                 + [f"event move {300 + 5 * i} {300 + 2 * i}"
                    for i in range(1, 19)] + ["event up left 390 336"])
        t0 = time.perf_counter()
        for line in burst:
            http(v.port, "/cmd", line.encode())
        t_last = time.perf_counter()
        with v._frame_cond:
            gen = v._req_gen
        while True:   # until the served frame is the one after the burst
            _, hdr, body = http(v.port, f"/frame.png?wait=1&seq={seq}")
            seq = int(hdr["X-Frame-Seq"])
            with v._frame_cond:
                if v._done_gen >= gen and v._frame_seq == seq:
                    break
        to_frame_ms = (time.perf_counter() - t_last) * 1e3
        burst_ms = (t_last - t0) * 1e3
        with v.lock:
            want = vr.s.render(use_lod=vr.use_lod,
                               show_deleted=vr.show_deleted)
        if not (np.array_equal(decode_png(body), want)
                and 1 <= len(renders) < len(burst)):
            raise AssertionError(f"after the burst: {len(renders)} renders "
                                 f"for {len(burst)} commands, frame "
                                 "differs from Session.render")
        with v.lock:
            fx, fy, fseg = hit_pixels(vr.s, 1, rcfg.width, rcfg.height)[0]
        for line in (f"event down left {fx} {fy}", f"event up left {fx} {fy}",
                     "focusview on"):
            http(v.port, "/cmd", line.encode())
        t0 = time.perf_counter()
        png_focus = v.frame_png()
        focus_ms = (time.perf_counter() - t0) * 1e3
        with v.lock:
            want = vr.s.render_focus(
                fseg, display=vr.display, show_hull=vr.overlays["hull"],
                show_rbv=vr.overlays["rbv"], show_axis=vr.overlays["axis"],
                hull_include=vr.hull_include,
                rbv_slices=vr.rbv_opts["slices"],
                rbv_sectors=vr.rbv_opts["sectors"],
                rbv_method=vr.rbv_opts["method"],
                rbv_symmetric=vr.rbv_opts["symmetric"],
                axis_algo=vr.axis_algo)
        if vr.selected != fseg or not np.array_equal(decode_png(png_focus),
                                                     want):
            raise AssertionError("the viewer's focus frame differs from "
                                 "Session.render_focus")
        http(v.port, "/cmd", b"focusview off")
        back = decode_png(v.frame_png())
        with v.lock:
            want = vr.s.render(use_lod=vr.use_lod,
                               show_deleted=vr.show_deleted)
        if not np.array_equal(back, want):
            raise AssertionError("back from the focus view, the frame "
                                 "differs from Session.render")
    finally:
        v.shutdown()
    http_thread.join(timeout=60)
    if v._render_thread.is_alive() or http_thread.is_alive():
        raise AssertionError("the viewer's threads outlived shutdown()")
    log(f"  viewer: first /frame.png {first_ms:.1f} ms ({vr.view_path}); "
        f"a burst of {len(burst)} drag commands in {burst_ms:.1f} ms cost "
        f"{len(renders)} renders, its frame {to_frame_ms:.1f} ms after the "
        f"last command; focus frame of segment {fseg} {focus_ms:.1f} ms; "
        "every frame byte-equal to Session.render / render_focus; shutdown "
        "ended both threads")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from treee_tpu_torch import config as tconfig
    from treee_tpu_torch import (change, characteristics, pipeline, rasters,
                                 rbv, repl, segmentation, serve, trunk_axis)
    from treee_tpu_torch.io import las, native_build
    from treee_tpu_torch.ops import eigen, kernels, neighbors, octree
    from treee_tpu_torch.ops.kernels import build
    from treee_tpu_torch.parallel import sharding, tiles
    from treee_tpu_torch.render import Camera, splat
    from treee_tpu_torch.tools import bench_tiled, probe_extract, survey_trees

    t_start = time.perf_counter()
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # --- phase 0: the device, the toolchain, the build ---
    log("phase 0: device")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {count}")
    nvcc = build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    log(f"  nvcc: {nvcc}: {nvcc_ver.splitlines()[-1]}")
    log(f"  ninja: {shutil.which('ninja') or 'absent'}, triton: "
        f"{'present' if importlib.util.find_spec('triton') else 'absent'}")
    # the native LAS/LAZ codec (g++) builds in a thread beside nvcc;
    # phase 17 waits for it
    pool = concurrent.futures.ThreadPoolExecutor(1)

    def native_codec():
        t0 = time.perf_counter()
        lib = native_build.load_library(required=True)
        return lib, time.perf_counter() - t0

    native_job = pool.submit(native_codec)
    pool.shutdown(wait=False)
    path, build_s = build.build()
    build.library()
    ptxas = path.with_suffix(".log").read_text() if path.with_suffix(
        ".log").exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", ptxas)]
    log(f"  built {path.name} in {build_s:.1f} s; ptxas: {len(regs)} kernels,"
        f" max {max(regs, default=0)} registers, "
        f"{sum(spills)} bytes of spill stores")

    # --- the 15M-point scan (bench.py:115-126) ---
    t0 = time.perf_counter()
    pts = las.synthetic_forest(
        n_trees=N_TREES, spacing=7.0, points_per_tree=POINTS_PER_TREE,
        ground_points=N_POINTS - N_TREES * POINTS_PER_TREE, seed=0)
    n = len(pts)
    log(f"scene: {n} points, {N_TREES} trees, made in "
        f"{time.perf_counter() - t0:.1f} s")

    flood_cfg = tconfig.Config(segmentation=tconfig.SegmentationConfig(
        use_bruteforce_voronoi=False, use_packed_jfa=False))

    # --- phases 1-7: each kernel of a path against its plain version ---
    calls = {k: [] for k in PATH_KERNELS}
    # every CC body of the step: each stops at its own bands' fixpoints
    with swapped(kernels, **{k: recorder(getattr(kernels, k), calls[k],
                                         by_value=k == "cc_sweep")
                             for k in PATH_KERNELS}):
        session, _, _ = run_main_path(pts, pipeline, octree, dev)
        session.render(Camera.orbital(distance=ORBIT_DISTANCE, device=dev))
        # the focused view: properties() and a focus frame of the largest
        # tree, which runs segment_properties on its compacted rows
        session.properties()
        largest = int(torch.argmax(session.table.count[1:])) + 1
        session.render_focus(largest,
                             Camera.orbital(distance=ORBIT_DISTANCE,
                                            device=dev), display="expansion")
        session.curvature(largest)      # the brute-force k-NN
        for kw in INVENTORY_CALLS:
            session.inventory(**kw)
        del session
        pipeline.Session.from_points(pts, flood_cfg, device=dev).segment(
            MAX_DISTANCE)
    results = {}
    for i, k in enumerate(PATH_KERNELS, start=1):
        # phases 1-7 hold the TPU kernels' ports, 7b the step's Voronoi, 7c
        # the focused view's k-NN
        log(f"phase {SIDE_PHASES.get(k, i)}: {k}")
        if not calls[k]:
            raise AssertionError(f"the port's paths never called {k}")
        extra = (synthetic_scans(calls[k], dev)
                 if k in ("segmented_cummax", "segmented_cumsum") else
                 frame_extras(calls[k], dev) if k == "dilate" else
                 knn_extras(las, dev) if k == "knn_select" else ())
        if k == "knn_select":
            kernels.reset_launches()
            kernels.knn_select(*extra[0][1])
            if kernels.knn_select.launches != 1:
                raise AssertionError(f"{extra[0][0]}: knn_select launched "
                                     f"{kernels.knn_select.launches} times")
        results[k] = check_kernel(
            k, kernels, calls[k], extra=extra,
            device="queued" if k in SIDE_PHASES else k in FRAME_KERNELS)
        if k == "dilate":
            log_tile_stats(calls[k], extra)
    del calls

    # --- phase 8: the main path ---
    log("phase 8: main path, Session.from_points(...).segment(0.75) + "
        "build_keys")
    cc_inputs = []
    cc_kernel = kernels.cc_sweep

    def cc_recorded(lbl, sweeps):
        cc_inputs.append((lbl.clone(), sweeps))
        return cc_kernel(lbl, sweeps)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with swapped(kernels, cc_sweep=cc_recorded):
        session, res, keys = run_main_path(pts, pipeline, octree, dev)
    launches = kernels.launches()
    log(f"  launches: {launches}")
    for k in MAIN_PATH_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"the main path launched no {k} kernel")
    max_segments = tconfig.DEFAULT_CONFIG.segmentation.max_segments
    check_outputs(session, res, keys, n, N_TREES, max_segments)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    seg_kernel = session.cloud.segment[session.cloud.valid]
    n_seg_kernel = int(res.n_segments)
    del session, res, keys
    for i, (lbl, sweeps) in enumerate(cc_inputs, start=1):
        fix = sweeps_to_fixpoint(kernels.cc_sweep_plain, lbl, sweeps).cpu()
        occupied = (lbl != IBIG).flatten(1).any(1).cpu()
        f = fix[occupied]
        log(f"  cc_sweep call {i} of {len(cc_inputs)} ({sweeps} sweeps): "
            f"{int(occupied.sum())} occupied bands; sweeps to the fixpoint "
            f"per occupied band: median {float(f.median()) if len(f) else 0},"
            f" max {int(f.max()) if len(f) else 0}; still changing after "
            f"{sweeps}: {int((f > sweeps).sum())}; counts "
            f"{sorted(f.tolist())}")
    del cc_inputs

    plain = {k: getattr(kernels, k + "_plain") for k, _, _ in KERNELS}
    with swapped(kernels, **plain):
        session, res, keys = run_main_path(pts, pipeline, octree, dev)
    seg_plain = session.cloud.segment[session.cloud.valid]
    differ = int((seg_plain != seg_kernel).sum())
    log(f"  plain versions on the card: {int(res.n_segments)} segments vs "
        f"{n_seg_kernel} with the kernels; {differ} points differ")
    if differ or int(res.n_segments) != n_seg_kernel:
        raise AssertionError(f"the plain path gives {differ} points another "
                             "segment id than the kernels")
    del session, res, keys, seg_plain

    session = pipeline.Session.from_points(pts, device=dev)
    times = []
    for _ in range(MAIN_PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.segment(MAX_DISTANCE)
        octree.build_keys(session.cloud.pos, session.cloud.valid)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not torch.equal(session.cloud.segment[session.cloud.valid],
                           seg_kernel):
            raise AssertionError("a repeated kernel run of the main path "
                                 "gave other segment ids")
    step_s = statistics.median(times)
    log(f"  {MAIN_PATH_REPS + 1} kernel runs and the plain run give "
        "identical segment ids")
    log(f"  step (segment + table + build_keys, cloud on the card): median "
        f"{step_s * 1e3:.1f} ms of {MAIN_PATH_REPS} warm runs "
        f"{[round(t * 1e3, 1) for t in times]}, {n / step_s / 1e6:.2f} Mpts/s")
    for stage, ms in step_stages(session, kernels, segmentation,
                                 characteristics, octree).items():
        log(f"  stage {stage}: {ms:.3f} ms")
    del seg_kernel

    # --- phase 9: the frame ---
    log(f"phase 9: frame, Session.render of the segmented scan at "
        f"{session.config.render.width}x{session.config.render.height}, "
        f"{N_FRAMES} orbit cameras")
    cams = orbit_cameras(Camera, dev)
    session.render(cams[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames, frame_ms = [], []
    frame_launches = dict.fromkeys(FRAME_KERNELS, 0)
    for cam in cams:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(session.render(cam))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        got = kernels.launches()
        for k in FRAME_KERNELS:
            if got[k] <= 0:
                raise AssertionError(f"a frame launched no {k} kernel")
            frame_launches[k] += got[k]
    launches.update(frame_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(frame_ms)
    log(f"  launches over {N_FRAMES} frames: {frame_launches}")
    log(f"  frame (render to a host u8 image, cloud on the card): median "
        f"{med:.2f} ms of {N_FRAMES} {[round(t, 2) for t in frame_ms]}, "
        f"{1e3 / med:.1f} fps; peak device memory {peak:.2f} GiB")
    for img in frames:
        if img.shape != (720, 1280, 3) or img.dtype.name != "uint8":
            raise AssertionError(f"frame {img.dtype}{img.shape}")
    bg = [round(c * 255.0) for c in session.config.render.background]
    covered = float(((abs(frames[0].astype(int) - bg)).max(-1) > 3).mean())
    log(f"  frame 0 covers {covered:.4f} of the pixels")
    if not 0.02 < covered < 0.98:
        raise AssertionError(f"frame 0 covers {covered} of the pixels")
    for stage, ms in frame_stages(session, cams[0], splat).items():
        log(f"  stage {stage}: {ms:.3f} ms")
    with swapped(kernels, **plain):
        plain_frames = [session.render(cam) for cam in cams]
    same = sum(int((a == b).all()) for a, b in zip(frames, plain_frames))
    log(f"  plain versions: {same} of {N_FRAMES} frames byte-equal")
    if same != N_FRAMES:
        raise AssertionError("frames with the plain versions differ")
    del frames, plain_frames

    # --- phase 10: the inventory ---
    log("phase 10: inventory of the segmented scan")
    n_live = int((session.cloud.valid & (session.cloud.segment != 0)).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.full_table()
    torch.cuda.synchronize()
    log(f"  full_table (characteristics with full boxes): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    inv_launches = dict.fromkeys(INVENTORY_KERNELS, 0)
    for kw in INVENTORY_CALLS:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        inv = session.inventory(**kw)
        torch.cuda.synchronize()
        got = kernels.launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k in INVENTORY_KERNELS:
            if got[k] <= 0:
                raise AssertionError(f"inventory({kw}) launched no {k} kernel")
            inv_launches[k] += got[k]
        log(f"  inventory({kw}): launches {got}; {len(inv['segment'])} trees; "
            f"peak device memory {peak:.2f} GiB")
        check_inventory(inv, N_TREES, max_segments, n_live,
                        dbh_slice_filled(session, kw, trunk_axis, rbv))
        differ = same_columns(inv, session.inventory(**kw))
        if differ:
            raise AssertionError(f"a second kernel run of inventory({kw}) "
                                 f"differs in {differ}")
        with swapped(kernels, **plain):
            differ = same_columns(inv, session.inventory(**kw))
        if differ:
            raise AssertionError(f"inventory({kw}) with the plain versions "
                                 f"differs in {differ}")
        inv_ms, inv_times = timed_ms(lambda: session.inventory(**kw),
                                     MAIN_PATH_REPS)
        log(f"  inventory({kw}): kernel runs and the plain run give "
            f"identical columns; median {inv_ms:.1f} ms of {MAIN_PATH_REPS} "
            f"warm runs {[round(t, 1) for t in inv_times]}")
        dbh = inv["diameter_breast_height"][inv["n_trunk"] > 0]
        log(f"  DBH over {len(dbh)} trees with trunk points: median "
            f"{float(np.median(dbh)):.4f} m, range {float(dbh.min()):.4f}-"
            f"{float(dbh.max()):.4f} m")
    log(f"  launches over both inventories: {inv_launches}")
    for stage, ms in inventory_stages(session, trunk_axis, rbv).items():
        log(f"  stage {stage}: {ms:.3f} ms")
    del session, inv

    # --- phase 11: the flood-fill Voronoi ---
    log("phase 11: flood-fill Voronoi, Session.from_points(..., "
        "use_bruteforce_voronoi=False, use_packed_jfa=False).segment(0.75)")
    brute = pipeline.Session.from_points(pts, device=dev)
    brute.segment(MAX_DISTANCE)
    seg_brute = brute.cloud.segment[brute.cloud.valid]
    bf_ms, _ = timed_ms(lambda: brute.segment(MAX_DISTANCE), MAIN_PATH_REPS)
    del brute
    flood = pipeline.Session.from_points(pts, flood_cfg, device=dev)
    flood_calls = []
    kernels.reset_launches()
    with swapped(kernels, jump_flood=recorder(kernels.jump_flood,
                                              flood_calls)):
        res = flood.segment(MAX_DISTANCE)
    torch.cuda.synchronize()
    got = kernels.launches()
    log(f"  launches: {got}")
    for _, (slot, _, _) in flood_calls:
        g = slot.shape[-1]
        log(f"  jump_flood i32[{', '.join(map(str, slot.shape))}]: route "
            f"{kernels.jump_flood_route(g)}, "
            f"{kernels.jump_flood_clusters(g)} clusters of "
            f"{kernels.JUMP_FLOOD_CLUSTER_CTAS} CTAs resident, "
            f"{int((slot >= 0).flatten(1).any(1).sum())} of {slot.shape[0]} "
            "bands hold a seed")
    del flood_calls
    for k in FLOOD_KERNELS:
        if got[k] <= 0:
            raise AssertionError(f"the flood-fill step launched no {k} kernel")
    launches["jump_flood"] = got["jump_flood"]
    if bool(res.occupied_overflow):
        raise AssertionError("occupied-cell compaction overflowed")
    seg_flood = flood.cloud.segment[flood.cloud.valid]
    n_flood = int(res.n_segments)
    if not 0.9 * N_TREES <= n_flood <= max_segments:
        raise AssertionError(f"flood-fill n_segments {n_flood} outside "
                             f"[{0.9 * N_TREES}, {max_segments}]")
    with swapped(kernels, **plain):
        plain_seg = pipeline.Session.from_points(pts, flood_cfg, device=dev)
        plain_seg.segment(MAX_DISTANCE)
    differ = int((plain_seg.cloud.segment[plain_seg.cloud.valid]
                  != seg_flood).sum())
    del plain_seg
    if differ:
        raise AssertionError(f"the plain flood-fill path gives {differ} "
                             "points another segment id than the kernels")
    fl_ms, fl_times = timed_ms(lambda: flood.segment(MAX_DISTANCE),
                               MAIN_PATH_REPS)
    if not torch.equal(flood.cloud.segment[flood.cloud.valid], seg_flood):
        raise AssertionError("a repeated flood-fill run gave other ids")
    agree = float((seg_flood == seg_brute).double().mean())
    log(f"  {n_flood} segments; the plain run and {MAIN_PATH_REPS + 1} kernel "
        f"runs give identical ids; {agree:.6f} of the points take the "
        f"brute-force Voronoi's id")
    log(f"  segment step (segment + table, cloud on the card): flood fill "
        f"median {fl_ms:.1f} ms {[round(t, 1) for t in fl_times]}, brute "
        f"force median {bf_ms:.1f} ms, of {MAIN_PATH_REPS} warm runs each")
    del flood, seg_flood, seg_brute
    packed_cfg = tconfig.Config(segmentation=tconfig.SegmentationConfig(
        use_bruteforce_voronoi=False, use_packed_jfa=True))
    packed = pipeline.Session.from_points(pts, packed_cfg, device=dev)
    res = packed.segment(MAX_DISTANCE)
    log(f"  packed flood (plain torch on every device): "
        f"{int(res.n_segments)} segments")
    del packed, res

    # --- phase 12: a small scene, the card's run against the port's CPU run ---
    small = las.synthetic_forest(n_trees=16, points_per_tree=2000,
                                 ground_points=8000, seed=1)
    small_cfg = tconfig.Config(
        segmentation=tconfig.SegmentationConfig(
            grid_size=128, max_bands=32, cc_occupied_cap=1 << 14),
        characteristics=tconfig.CharacteristicsConfig(max_slices=64))
    s_cpu, r_cpu, k_cpu = run_main_path(small, pipeline, octree, "cpu",
                                        small_cfg)
    s_gpu, r_gpu, k_gpu = run_main_path(small, pipeline, octree, dev,
                                        small_cfg)
    small_agree = float((s_gpu.cloud.segment.cpu() == s_cpu.cloud.segment)
                        .double().mean())
    log(f"small scene ({len(small)} points): card vs CPU point agreement "
        f"{small_agree:.6f}, segments {int(r_gpu.n_segments)} vs "
        f"{int(r_cpu.n_segments)}, keys equal {torch.equal(k_gpu.cpu(), k_cpu)}")
    if small_agree < MIN_CPU_AGREEMENT or not torch.equal(k_gpu.cpu(), k_cpu):
        raise AssertionError("the card's run disagrees with the CPU run")
    cam = Camera.orbital(distance=60.0, device="cpu").rotate_orbital(
        ORBIT_STEP, -60.0)
    f_cpu = s_cpu.render(cam)
    f_gpu = s_gpu.render(cam.to(dev))
    diff = abs(f_cpu.astype(int) - f_gpu.astype(int))
    log(f"  small frame: card vs CPU max difference {int(diff.max())} per "
        f"channel, {float((diff.max(-1) > 0).mean()):.6f} of pixels differ")
    if diff.max() > 1:
        raise AssertionError("the card's frame differs from the CPU's by "
                             "more than 1 per channel")
    seg_c = s_cpu.cloud.segment
    seg_g = s_gpu.cloud.segment.cpu()
    bad = set(seg_c[seg_c != seg_g].tolist()) | set(seg_g[seg_c != seg_g]
                                                     .tolist())
    for kw in INVENTORY_CALLS:
        a, b = s_gpu.inventory(**kw), s_cpu.inventory(**kw)
        rows_a = ~np.isin(a["segment"], list(bad))
        rows_b = ~np.isin(b["segment"], list(bad))
        worst = 0.0
        for k in a:
            ga, gb = a[k][rows_a], b[k][rows_b]
            if ga.dtype.kind in "biu":
                if not np.array_equal(ga, gb):
                    raise AssertionError(f"small inventory({kw}) column {k}: "
                                         "card and CPU differ")
                continue
            scale = np.abs(gb).max(initial=1.0)
            rel = float((np.abs(ga - gb) / np.maximum(np.abs(gb),
                                                      scale * 1e-2)).max(
                initial=0.0))
            worst = max(worst, rel)
            if rel > INVENTORY_RTOL:
                raise AssertionError(f"small inventory({kw}) column {k}: "
                                     f"card vs CPU relative difference {rel}")
        log(f"  small inventory({kw}): {int(rows_a.sum())} of "
            f"{len(a['segment'])} rows with agreeing ids; card vs CPU largest "
            f"relative difference {worst:.3g}")
    interactive_card_vs_cpu(small, small_cfg, s_cpu.cloud.segment, cam,
                            pipeline, octree, dev)
    focus_card_vs_cpu(small, small_cfg, s_cpu.cloud.segment, cam, pipeline,
                      dev)
    del s_cpu, s_gpu

    # --- phase 13: the gather probe (on no path of the system) ---
    log("phase 13: take_along_axis, the gather probe's four shapes "
        "(treee_tpu_torch.tools.probe_extract)")
    cases = probe_extract.gather_cases(probe_extract.probe_inputs())
    kernels.reset_launches()
    outs = probe_extract.run_gathers(cases, dev)
    torch.cuda.synchronize()
    launches["take_along_axis"] = kernels.launches()["take_along_axis"]
    log(f"  launches: {launches['take_along_axis']} for {len(cases)} gathers")
    if launches["take_along_axis"] != len(cases):
        raise AssertionError("the probe's gathers did not all launch the "
                             "take_along_axis kernel")
    probe_calls = []
    for (_, tab, idx, axis), out in zip(cases, outs):
        args = (torch.from_numpy(tab).to(dev), torch.from_numpy(idx).to(dev),
                axis)
        if not torch.equal(out, kernels.take_along_axis_plain(*args)):
            raise AssertionError("a probe gather differs from the plain "
                                 "version")
        probe_calls.append(((tuple(tab.shape), tuple(idx.shape)), args))

    def take_along_library(tab, idx, axis):
        idx = idx.long()
        if axis is None:
            return lambda: tab[idx]
        return lambda: torch.take_along_dim(tab, idx, dim=axis)

    results["take_along_axis"] = check_kernel(
        "take_along_axis", kernels, probe_calls, library=take_along_library,
        reps=PROBE_TIMING_REPS)
    per_shape = results["take_along_axis"]["per_shape"]
    log(f"  kernel no slower than the library at "
        f"{sum(k <= lib for k, lib in per_shape)} of {len(per_shape)} shapes "
        f"(kernel / library ms: "
        f"{'; '.join(f'{k:.4f} / {lib:.4f}' for k, lib in per_shape)})")

    # --- phase 14: the interactive view ---
    log("phase 14: the interactive view of the segmented scan: build_lod and "
        "LOD frames, solve_adaptive_tau and the adaptive and screen-adaptive "
        "frames, edit strokes with their LOD frames, membership edits, pick, "
        "then full_table() and inventory()")
    t_phase = time.perf_counter()
    session = pipeline.Session.from_points(pts, device=dev)
    session.segment(MAX_DISTANCE)
    rcfg = session.config.render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    view_launches = dict.fromkeys(PATH_KERNELS, 0)
    counted = launch_counter(kernels, view_launches)

    def plain_equal(frames, draw, what):
        with swapped(kernels, **plain):
            same = sum(int((img == draw(i)).all())
                       for i, img in enumerate(frames))
        if same != len(frames):
            raise AssertionError(f"{what}: {len(frames) - same} frames "
                                 "differ with the plain versions")
        return same

    # (a) the fixed-level LOD
    first_ms, _ = timed_ms(session.build_lod, 1)
    warm_ms, warm = timed_ms(session.build_lod, MAIN_PATH_REPS)
    _, idx, n_kept = session._lod
    lod_points, lod_cap = int(n_kept), idx.shape[0]
    frames, lod_ms = [], []
    for cam in cams:
        img, ms = counted(lambda: session.render(cam, use_lod=True),
                          FRAME_KERNELS, "a LOD frame")
        frames.append(img)
        lod_ms.append(ms)
    same = plain_equal(frames,
                       lambda i: session.render(cams[i], use_lod=True),
                       "LOD frames")
    bench_lod = int((octree.lod_mask(session._tree, 7)
                     & session.cloud.valid).sum())
    log(f"  build_lod() (level 7): {first_ms:.2f} ms with the octree build, "
        f"{warm_ms:.2f} ms on the cached tree (median of {MAIN_PATH_REPS} "
        f"{[round(t, 2) for t in warm]}); {lod_points} points, capacity "
        f"{lod_cap}")
    log(f"  LOD frame: median {statistics.median(lod_ms):.2f} ms of "
        f"{N_FRAMES} {[round(t, 2) for t in lod_ms]}; {same} of {N_FRAMES} "
        "byte-equal to the plain versions'")
    log(f"  cross-check, bench.py's cut (every valid point): {bench_lod} "
        f"points; BENCH_r05.json (TPU v5e): {BENCH_R05['lod_points']}")
    for stage, ms in build_lod_stages(session, octree, lambda t, live: (
            octree.lod_mask(t, 7, live=live))).items():
        log(f"  build_lod stage {stage}: {ms:.3f} ms")
    log("  build_lod() on the cached tree: "
        + top_device_ops(session.build_lod))
    log("  octree.build: " + top_device_ops(
        lambda: octree.build(session.cloud.pos, session.cloud.valid)))
    log("  LOD frame: " + top_device_ops(
        lambda: session.render(cams[0], use_lod=True)))
    for stage, ms in frame_stages(session, cams[0], splat, session._lod[0],
                                  lambda: lod_select(session, splat)).items():
        log(f"  LOD frame stage {stage}: {ms:.3f} ms")

    # (b) the screen-adaptive cuts for the first camera
    full = session.render(cams[0])
    px = pipeline._px_scale(cams[0], rcfg)
    planes = cams[0].frustum_planes(rcfg.width / rcfg.height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tau = session.solve_adaptive_tau(budget_rows=n // 2, camera=cams[0])
    solve_ms = (time.perf_counter() - t0) * 1e3
    log(f"  solve_adaptive_tau(budget_rows={n // 2}): tau {tau} in "
        f"{solve_ms:.2f} ms; " + top_device_ops(
            lambda: session.solve_adaptive_tau(budget_rows=n // 2,
                                               camera=cams[0])))
    # bench.py's own cut for the cross-check: the ladder's counts without a
    # frustum over every valid point, and its tau for the same budget
    ladder = pipeline.Session.TAU_LADDER
    bench_counts = octree.adaptive_counts(
        session._tree, cams[0].position, px, ladder,
        live=session.cloud.valid).cpu().numpy()
    fits = np.nonzero(bench_counts <= n // 2)[0]
    bench_tau = ladder[int(fits[0])] if len(fits) else ladder[-1]
    for cut, t, bench_key, b_tau in (
            ("adaptive", tau, "adaptive", bench_tau),
            ("screen-adaptive", 1.0, "screen_adaptive", 1.0)):
        b_ms, _ = timed_ms(lambda: session.build_lod(
            camera=cams[0], adaptive_tau_px=t), 1)
        _, idx, n_kept = session._lod
        img, _ = counted(lambda: session.render(cams[0], use_lod=True),
                         FRAME_KERNELS, f"an {cut} frame")
        plain_equal([img], lambda i: session.render(cams[0], use_lod=True),
                    f"the {cut} frame")
        f_ms, f_times = timed_ms(lambda: session.render(cams[0],
                                                        use_lod=True),
                                 TIMING_REPS)
        match = float((img == full).all(axis=-1).mean())
        bench_pts = int(octree.adaptive_mask(
            session._tree, cams[0].position, px, tau_px=b_tau,
            live=session.cloud.valid).sum())
        log(f"  {cut} (tau {t}): build_lod {b_ms:.2f} ms, {int(n_kept)} "
            f"points, capacity {idx.shape[0]}; frame median {f_ms:.2f} ms of "
            f"{TIMING_REPS} {[round(x, 2) for x in f_times]}; pixel match "
            f"against the full frame {match:.4f}; byte-equal to the plain "
            "versions'")
        log(f"  cross-check, bench.py's cut (no frustum, every valid point) "
            f"at tau {b_tau}: {bench_pts} points; BENCH_r05.json (TPU v5e): "
            f"{BENCH_R05[bench_key + '_points']} points, pixel match "
            f"{BENCH_R05[bench_key + '_pixel_match']}"
            + (f", tau {BENCH_R05['adaptive_tau']}" if cut == "adaptive"
               else ""))
        for stage, ms in build_lod_stages(session, octree, lambda tr, live: (
                octree.adaptive_mask(tr, cams[0].position, px, tau_px=t,
                                     live=live, frustum=planes))).items():
            log(f"  {cut} build_lod stage {stage}: {ms:.3f} ms")
        for stage, ms in frame_stages(session, cams[0], splat,
                                      session._lod[0],
                                      lambda: lod_select(session,
                                                         splat)).items():
            log(f"  {cut} frame stage {stage}: {ms:.3f} ms")
        log(f"  {cut} frame: " + top_device_ops(
            lambda: session.render(cams[0], use_lod=True)))
        log(f"  {cut} build_lod: " + top_device_ops(
            lambda: session.build_lod(camera=cams[0], adaptive_tau_px=t)))

    # (c) edit strokes through the cached LOD subset, then membership edits
    session.build_lod()
    tree, lod = session._tree, session._lod
    alive_before = int(session.cloud.alive.sum())
    stroke_ms, stroke_frames = [], []
    for c in EDIT_CENTERS:
        img, ms = counted(lambda: (session.delete_sphere(c, EDIT_RADIUS),
                                   session.render(cams[0], use_lod=True))[1],
                          FRAME_KERNELS, "an edit frame")
        stroke_frames.append(img)
        stroke_ms.append(ms)
        plain_equal([img], lambda i: session.render(cams[0], use_lod=True),
                    "an edit frame")
    if session._tree is not tree or session._lod is not lod:
        raise AssertionError("an edit stroke rebuilt the octree or the LOD "
                             "subset")
    deleted = alive_before - int(session.cloud.alive.sum())
    stroke_dev = top_device_ops(lambda: (
        session.delete_sphere(EDIT_CENTERS[0], EDIT_RADIUS),
        session.render(cams[0], use_lod=True)))
    del_ms, _ = timed_ms(lambda: session.delete_sphere(EDIT_CENTERS[0],
                                                       EDIT_RADIUS),
                         TIMING_REPS)
    frame_only, _ = timed_ms(lambda: session.render(cams[0], use_lod=True),
                             TIMING_REPS)
    log(f"  edit stroke (delete_sphere r={EDIT_RADIUS} + LOD frame): median "
        f"{statistics.median(stroke_ms):.2f} ms of {len(EDIT_CENTERS)} "
        f"{[round(t, 2) for t in stroke_ms]}; {deleted} points deleted; the "
        f"cached octree and subset kept; every frame byte-equal to the plain "
        f"versions'; delete_sphere alone {del_ms:.3f} ms, the frame alone "
        f"{frame_only:.3f} ms (medians of {TIMING_REPS}); a stroke's "
        + stroke_dev)
    present = np.flatnonzero(session.table.present.cpu().numpy())
    pair = tuple(int(i) for i in present[present > 0][:2])
    done = membership_edits(session, EDIT_TREE, pair)
    session.camera = cams[0]
    hit = session.pick(rcfg.width / 2, rcfg.height / 2)
    log(f"  membership edits {done}; pick at the frame centre: segment "
        f"{hit[0]}, {hit[1]:.3f} m, hit {hit[2]}")
    if not session._counts_stale:
        raise AssertionError("the membership edits left the table fresh")
    table, ft_ms = counted(session.full_table, ("segmented_cummax",),
                           "full_table() after the edits")
    if session._counts_stale or not bool(table.present[done["spawned"]]):
        raise AssertionError("full_table() did not recompute after the "
                             "edits")
    with swapped(kernels, **plain):
        session._counts_stale = True
        plain_table = session.full_table()
    for f in dataclasses.fields(table):
        if not same_bits(getattr(table, f.name),
                         getattr(plain_table, f.name)):
            raise AssertionError(f"full_table() after the edits: {f.name} "
                                 "differs with the plain versions")
    inv, inv_ms = counted(session.inventory, ("segmented_cumsum",),
                          "inventory() after the edits")
    with swapped(kernels, **plain):
        differ = same_columns(inv, session.inventory())
    if differ:
        raise AssertionError(f"inventory() after the edits differs in "
                             f"{differ} with the plain versions")
    log(f"  full_table() after the edits: {ft_ms:.2f} ms, recomputed, "
        f"identical with the plain versions; inventory(): {inv_ms:.2f} ms, "
        f"{len(inv['segment'])} trees, columns identical with the plain "
        "versions")
    log(f"  launches over the phase: {view_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for k in ("dilate", "eye_dome", "segmented_cummax", "segmented_cumsum"):
        launches[k] += view_launches[k]
    del session, inv, table, plain_table, frames, stroke_frames, full

    # --- phase 15: the focused view ---
    log("phase 15: the focused view of the segmented scan's largest tree: "
        "properties(), curvature and normals, render_focus for "
        f"{len(pipeline.FOCUS_DISPLAYS)} displays x {N_FRAMES} orbit cameras "
        "and the overlays, traits against the inventory, segment_coords, an "
        "edit, then the grid path")
    t_phase = time.perf_counter()
    session = pipeline.Session.from_points(pts, device=dev)
    session.segment(MAX_DISTANCE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    focus_launches = dict.fromkeys(PATH_KERNELS, 0)
    counted = launch_counter(kernels, focus_launches)
    seg_counts = session.table.count.cpu().numpy().astype(np.int64)
    seg_counts[0] = 0
    sid = int(np.argmax(seg_counts))
    seg_n = int(seg_counts[sid])
    k_nn = session.config.characteristics.neighbors
    bfm = session.config.neighbors.brute_force_max
    log(f"  segment {sid}: {seg_n} points, brute force up to {bfm}; "
        f"cross-check, BENCH_r05.json (TPU v5e): "
        f"{BENCH_R05['curvature_points']} points, grid "
        f"{BENCH_R05['curvature_grid']}")
    if seg_n > bfm:
        raise AssertionError("the largest tree routes to the grid")

    # (a) properties() of the whole cloud
    props, p_ms = counted(session.properties, ("segmented_cummax",),
                          "properties()")
    with swapped(kernels, **plain):
        plain_props = session.properties()
    if not all(same_bits(a, b) for a, b in zip(props, plain_props)):
        raise AssertionError("properties() differs with the plain versions")
    p_warm, p_times = timed_ms(session.properties, MAIN_PATH_REPS)
    log(f"  properties() over {n} points: {p_ms:.2f} ms first, median "
        f"{p_warm:.2f} ms of {MAIN_PATH_REPS} {[round(t, 2) for t in p_times]}"
        "; identical with the plain versions; " + top_device_ops(
            session.properties))
    del props, plain_props

    # (b) curvature and normals on the brute path
    curve, c_first = counted(lambda: session.curvature(sid), ("knn_select",),
                             "curvature")
    _, c_cached = counted(lambda: session.curvature(sid), (), "curvature")
    nrm, n_ms = counted(lambda: session.normals(sid), (), "normals")
    idx, sub_valid = session._focus_idx_cache[sid]
    sub_c = session._focus_prop_cache[("curve", sid, k_nn)]
    sub_n = session._focus_prop_cache[("normals", sid, k_nn)]
    session._clear_focus()
    if not (torch.equal(session.curvature(sid), curve)
            and torch.equal(session.normals(sid), nrm)):
        raise AssertionError("a second k-NN run on the card gave other "
                             "curvatures or normals")
    pos_sub = session.cloud.pos[idx]
    knn = [neighbors.knn_bruteforce(pos_sub, sub_valid) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*knn)):
        raise AssertionError("the card's k-NN indices do not repeat")
    cpu_knn = neighbors.knn_bruteforce(pos_sub.cpu(), sub_valid.cpu())
    n_differ, n_bad = same_neighbours(knn[0], cpu_knn)
    if n_bad:
        raise AssertionError(f"{n_bad} k-NN rows differ between the card and "
                             "the CPU away from a distance tie")
    cov = neighbors.neighbor_covariance(pos_sub.cpu(), cpu_knn[0],
                                        cpu_knn[1] < 3e38)
    sv = sub_valid.cpu()
    c_ok, c_worst = share_close(sub_c[sub_valid],
                                eigen.curvature_from_cov(cov)[sv], FOCUS_ATOL)
    n_ok, n_worst = share_close(sub_n[sub_valid],
                                eigen.smallest_eigenvector(cov)[sv],
                                FOCUS_ATOL)
    if min(c_ok, n_ok) < FOCUS_MIN_SHARE:
        raise AssertionError(f"curvature / normals: card and CPU within "
                             f"{FOCUS_ATOL} on {c_ok:.4f} / {n_ok:.4f}")
    del knn, cpu_knn, cov
    log(f"  curvature({sid}): {c_first:.2f} ms uncached (compaction + k-NN + "
        f"covariance + eigen), {c_cached:.3f} ms cached; normals "
        f"{n_ms:.2f} ms (compaction cached); {idx.shape[0]} rows; a fresh "
        "k-NN repeats curvature and normals bit for bit, k-NN indices repeat")
    log(f"  card vs the port's CPU run on the same {idx.shape[0]} rows: "
        f"{n_differ} k-NN rows differ (each at a distance tie); curvature "
        f"within {FOCUS_ATOL} on {c_ok:.5f} (largest {c_worst:.3g}), normals "
        f"on {n_ok:.5f} (largest {n_worst:.3g})")

    # the same tree through the grid hash, for the brute-vs-grid crossover
    member = session._member_mask(sid)
    g_tree_ms, g_tree_times = timed_ms(
        lambda: characteristics.segment_curvature(
            session.cloud.pos, member, k=k_nn, use_grid=True), 2)
    diff = (characteristics.segment_curvature(
        session.cloud.pos, member, k=k_nn, use_grid=True) - curve)[member]
    log(f"  the same {seg_n} points through the grid hash: median "
        f"{g_tree_ms:.2f} ms of 2 {[round(t, 2) for t in g_tree_times]}; "
        f"curvature within {FOCUS_ATOL} of the brute force's on "
        f"{float((diff.abs() <= FOCUS_ATOL).double().mean()):.5f}")

    def fresh_curvature():
        session._clear_focus()
        return session.curvature(sid)

    log("  curvature uncached: " + top_device_ops(fresh_curvature, k=6))
    for stage, ms in focus_stages(session, sid, cams[0], neighbors, eigen,
                                  splat).items():
        log(f"  focus stage {stage}: {ms:.3f} ms")

    # (c) the five displays over the 8 orbit cameras (bench.py's focus
    # frames, which pivot on the scene's centre and may miss the tree), and
    # from a camera 30 m in front of the tree
    centre = session.cloud.pos[session._member_mask(sid)].mean(dim=0)
    eye = np.eye(4, dtype=np.float32)
    eye[:3, 3] = centre.cpu().numpy() + [0.0, 0.0, FOCUS_DISTANCE]
    focus_cam = Camera.from_numpy(eye, FOCUS_DISTANCE, device=dev)
    bg = [round(c * 255.0) for c in session.config.render.background]
    for display in pipeline.FOCUS_DISPLAYS:
        needed = FRAME_KERNELS + (("segmented_cummax",) if display in (
            "expansion", "height") else ())
        imgs, f_ms = [], []
        for cam in cams + [focus_cam]:
            img, ms = counted(lambda: session.render_focus(
                sid, cam, display=display), needed, f"a {display} focus frame")
            imgs.append(img)
            f_ms.append(ms)
        plain_equal(imgs, lambda i: session.render_focus(
            sid, (cams + [focus_cam])[i], display=display),
            f"{display} focus frames")
        lit = [float(((abs(img.astype(int) - bg)).max(-1) > 3).mean())
               for img in imgs]
        if not lit[-1] > 0.01:
            raise AssertionError(f"the {display} focus frame shows "
                                 f"{lit[-1]} of its pixels lit")
        log(f"  render_focus(display={display!r}): median "
            f"{statistics.median(f_ms[:-1]):.2f} ms of the {N_FRAMES} orbit "
            f"frames {[round(t, 2) for t in f_ms[:-1]]}, lit "
            f"{[round(x, 4) for x in lit[:-1]]}; {f_ms[-1]:.2f} ms from "
            f"{FOCUS_DISTANCE:.0f} m in front of the tree, {lit[-1]:.4f} lit; "
            f"all {len(imgs)} byte-equal to the plain versions'")
    log("  classification focus frame: " + top_device_ops(
        lambda: session.render_focus(sid, focus_cam)))
    log("  expansion focus frame: " + top_device_ops(
        lambda: session.render_focus(sid, focus_cam, display="expansion")))

    # (d) all three overlays under each axis algorithm and RBV method
    for kw in FOCUS_OVERLAYS:
        img, ms = counted(lambda: session.render_focus(sid, focus_cam, **kw),
                          FRAME_KERNELS, f"an overlay frame {kw}")
        plain_equal([img], lambda i: session.render_focus(sid, focus_cam,
                                                          **kw),
                    f"the overlay frame {kw}")
        o_ms, o_times = timed_ms(lambda: session.render_focus(sid, focus_cam,
                                                              **kw),
                                 TIMING_REPS)
        log(f"  overlays (hull, RBV cage, axis), axis {kw['axis_algo']}, RBV "
            f"{kw['rbv_method']}: {ms:.2f} ms first, median {o_ms:.2f} ms of "
            f"{TIMING_REPS} {[round(t, 2) for t in o_times]}; byte-equal to "
            "the plain versions'")
    log("  overlay frame: " + top_device_ops(
        lambda: session.render_focus(sid, focus_cam, **FOCUS_OVERLAYS[0])))
    for stage, ms in overlay_stages(session, sid, focus_cam, trunk_axis, rbv,
                                    splat).items():
        log(f"  overlay stage {stage}: {ms:.3f} ms")

    # (e) the tree's split RBVs and traits against its inventory row
    cloud = session.cloud
    member = session._member_mask(sid)
    axis = trunk_axis.average_direction(cloud.pos, member & (
        cloud.classification == 1))
    crown_r, trunk_r = rbv.split_rbv(cloud.pos, cloud.classification, member,
                                     transform=trunk_axis.axis_transform(axis))
    traits = rbv.traits(crown_r, trunk_r)
    inv = session.inventory()
    row = int(np.flatnonzero(inv["segment"] == sid)[0])
    worst = 0.0
    for trait in rbv.TRAITS:
        got, ref = float(getattr(traits, trait)), float(inv[trait][row])
        worst = max(worst, abs(got - ref) / max(abs(ref), 1e-12))
        if not np.isclose(got, ref, rtol=TRAITS_RTOL, atol=TRAITS_ATOL):
            raise AssertionError(f"traits {trait} of segment {sid}: {got} "
                                 f"against the inventory's {ref}")
    coords = session.segment_coords(sid)
    if coords is None or not np.all(np.isfinite(coords)):
        raise AssertionError(f"segment_coords({sid}) gave {coords}")
    log(f"  split_rbv + traits of segment {sid} against its inventory row: "
        f"within rtol {TRAITS_RTOL} (largest relative difference "
        f"{worst:.3g}); DBH {float(traits.diameter_breast_height):.4f} m; "
        f"segment_coords {coords}")

    # (f) a deletion through the tree: the focus caches go, curvature
    # recomputes
    session.curvature(sid)
    centre = cloud.pos[member][0].cpu().numpy()      # a point of the tree
    n_before = int(member.sum())
    session.delete_sphere(centre, radius=1.0)
    if session._focus_prop_cache or session._focus_idx_cache:
        raise AssertionError("delete_sphere left the focus caches")
    after, d_ms = counted(lambda: session.curvature(sid), (),
                          "curvature after the edit")
    n_after = int(session._member_mask(sid).sum())
    if not n_after < n_before or not bool((after[member] == 0).any()):
        raise AssertionError("curvature did not follow the deletion")
    log(f"  delete_sphere through segment {sid}: {n_before - n_after} points "
        f"deleted; curvature recomputed in {d_ms:.2f} ms")

    # (g) the grid path: the tree and its nearest trees past brute_force_max
    others = nearest_trees(session.full_table(), sid, bfm)
    for other in others:
        session.combine(other, sid)
    member = session._member_mask(sid)
    n_member = int(member.sum())
    g_curve, g_ms = counted(lambda: session.curvature(sid), (),
                            "grid curvature")
    key = ("curve", sid, k_nn)
    if key not in session._focus_grid_cache:
        raise AssertionError(f"{n_member} points did not route to the grid")
    again, g2_ms = counted(lambda: session.curvature(sid), (),
                           "cached grid curvature")
    if again is not g_curve:
        raise AssertionError("a second grid curvature missed the cache")
    g_frame, gf_ms = counted(lambda: session.render_focus(
        sid, focus_cam, display="curve"), FRAME_KERNELS, "a grid focus frame")
    plain_equal([g_frame], lambda i: session.render_focus(
        sid, focus_cam, display="curve"), "the grid path's focus frame")
    cap = octree.snug_capacity(n_member, headroom=1.0)
    n_kept, cidx = octree.compact_indices(member, cap)
    valid_c = torch.arange(cap, device=cidx.device) < n_kept
    pos_c = cloud.pos[cidx]
    b_ms, b_times = timed_ms(lambda: characteristics.segment_curvature(
        pos_c, valid_c, k=k_nn), 2)
    b_curve = characteristics.segment_curvature(pos_c, valid_c, k=k_nn)
    rows = torch.nonzero(member).flatten()
    g_idx, _ = neighbors.knn_grid_reduce(
        cloud.pos, member, GRID_CELL, lambda i, d, nb: (i, d), k=k_nn,
        rows=rows)
    b_idx = cidx[neighbors.knn_bruteforce(pos_c, valid_c, k=k_nn)[0].long()]
    same_sets = float((torch.sort(g_idx, dim=1).values == torch.sort(
        b_idx[:len(rows)].to(g_idx.dtype), dim=1).values).all(dim=1)
        .double().mean())
    diff = (g_curve[cidx[:len(rows)].long()] - b_curve[:len(rows)]).abs()
    log(f"  grid path: segment {sid} combined with {len(others)} nearest "
        f"trees, {n_member} points (> {bfm}); curvature through the grid "
        f"hash {g_ms:.2f} ms, again from the cache {g2_ms:.3f} ms; brute "
        f"force on the same members median {b_ms:.2f} ms of 2 "
        f"{[round(t, 2) for t in b_times]}; {same_sets:.5f} of the points "
        f"have the brute force's neighbours; curvature difference largest "
        f"{float(diff.max()):.4f}, {float((diff <= FOCUS_ATOL).double().mean()):.5f} "
        f"within {FOCUS_ATOL}; a curve focus frame on the grid path "
        f"{gf_ms:.2f} ms, byte-equal to the plain versions'")

    def fresh_grid():
        session._focus_grid_cache.clear()
        return session.curvature(sid)

    log("  grid curvature uncached: " + top_device_ops(fresh_grid, k=6))
    for k in ("dilate", "eye_dome", "segmented_cummax", "segmented_cumsum"):
        launches[k] += focus_launches[k]
    log(f"  launches over the phase: {focus_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del session, inv, curve, nrm, g_curve, b_curve, pos_c, pos_sub

    # --- phase 16: rasters, height above ground, summary, change ---
    log("phase 16: rasters of the segmented scan (DTM/DSM/CHM at "
        f"{' and '.join(map(str, RASTER_CELLS))} m), height above ground "
        f"({HAG_CELL} m) and hag focus frames, export_raster, "
        "forest_summary, then change detection against a second epoch")
    t_phase = time.perf_counter()
    session = pipeline.Session.from_points(pts, device=dev)
    session.segment(MAX_DISTANCE)
    ppt, n_tree_pts = POINTS_PER_TREE, N_TREES * POINTS_PER_TREE
    grown = pts.copy()
    canopy = np.zeros(n, bool)
    canopy[:n_tree_pts] = pts[:n_tree_pts, 1] > 0.3
    grown[canopy, 1] *= np.float32(GROWTH)
    planted = grown[ppt:2 * ppt] + np.array(PLANT_SHIFT, np.float32)
    off_b = np.array(EPOCH_B_OFFSET)
    pts_b = (np.concatenate([grown[ppt:], planted])
             - off_b[None, :].astype(np.float32))
    epoch_b = pipeline.Session.from_points(pts_b, world_offset=off_b,
                                           device=dev)
    epoch_b.segment(MAX_DISTANCE)
    del grown, canopy, pts_b
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raster_launches = dict.fromkeys(PATH_KERNELS + ("jump_flood_grid",), 0)
    counted = launch_counter(kernels, raster_launches)

    # (a) every flood of the phase's raster calls against the plain flood on
    # the same input, in a pass of its own
    flood_kernel = kernels.jump_flood_grid
    flood_calls, flood_log = [], []

    def flood_checked(slot, at, cc, steps):
        out = flood_kernel(slot, at, cc, steps)
        if not torch.equal(out, kernels.jump_flood_grid_plain(slot, at, cc,
                                                              steps)):
            raise AssertionError(f"jump_flood_grid at {list(slot.shape)}: "
                                 "the kernel differs from the plain flood")
        sig = (tuple(slot.shape),)
        if all(s != sig for s, _ in flood_calls):
            flood_calls.append((sig, (slot.clone(), at, cc, list(steps))))
        h, w = slot.shape
        flood_log.append(
            f"{h}x{w} ({8 * len(steps)} directions, "
            f"{'seeds at their cells' if at is None else 'given positions'})")
        return out

    with swapped(kernels, jump_flood_grid=flood_checked):
        checked = {c: session.rasters(c) for c in RASTER_CELLS}
        checked_hag = session.height_above_ground(HAG_CELL)
        change.chm_change(session, epoch_b, cell=RASTER_CELLS[0])
    log(f"  {len(flood_log)} raster floods, each byte-equal to the plain "
        f"flood on the same input: {'; '.join(flood_log)}")
    # torch.profiler loses most of the cooperative launch's records in
    # this long process, so its device time is taken from queued calls
    results["jump_flood_grid"] = check_kernel(
        "jump_flood_grid", kernels, flood_calls, device="queued")
    grid_flood_launches(kernels, flood_calls)

    # (b) the rasters: kernel runs, a second card run and the plain run
    for cell in RASTER_CELLS:
        (grids, ll, out_cell), r_ms = counted(
            lambda: session.rasters(cell), ("jump_flood_grid",),
            f"rasters({cell})")
        again = session.rasters(cell)
        with swapped(kernels, **plain):
            plain_grids = session.rasters(cell)[0]
        for k, g in grids.items():
            if (g.tobytes() != checked[cell][0][k].tobytes()
                    or g.tobytes() != again[0][k].tobytes()):
                raise AssertionError(f"rasters({cell}) {k}: a second card "
                                     "run gave other bits")
            if g.tobytes() != plain_grids[k].tobytes():
                raise AssertionError(f"rasters({cell}) {k}: the plain run "
                                     "gave other bits")
        dtm, dsm, chm = grids["dtm"], grids["dsm"], grids["chm"]
        if not ((dtm != rasters.NODATA).all() and np.isfinite(dtm).all()
                and (chm != rasters.NODATA).any()
                and float(chm[chm != rasters.NODATA].max()) > 5.0):
            raise AssertionError(f"rasters({cell}): DTM holes or no canopy")
        warm, warm_t = timed_ms(lambda: session.rasters(cell), MAIN_PATH_REPS)
        log(f"  rasters({cell}): {dtm.shape[0]}x{dtm.shape[1]} live cells, "
            f"cell {out_cell}, corner {ll}; {r_ms:.2f} ms first, median "
            f"{warm:.2f} ms of {MAIN_PATH_REPS} {[round(t, 2) for t in warm_t]}"
            f"; DSM cells {float((dsm != rasters.NODATA).mean()):.4f}, CHM "
            f"max {float(chm[chm != rasters.NODATA].max()):.3f} m; identical "
            "to the checked pass, a second card run and the plain run")
        for stage, ms in raster_stages(session, cell, rasters).items():
            log(f"  rasters({cell}) stage {stage}: {ms:.3f} ms")
    log(f"  rasters({RASTER_CELLS[-1]}): " + top_device_ops(
        lambda: session.rasters(RASTER_CELLS[-1]), k=6))

    # (c) height above ground, hag_prop and the hag focus frames
    hag, h_ms = counted(lambda: session.height_above_ground(HAG_CELL),
                        ("jump_flood_grid",), "height_above_ground")
    with swapped(kernels, **plain):
        plain_hag = session.height_above_ground(HAG_CELL)
    if not (same_bits(hag, checked_hag) and same_bits(hag, plain_hag)):
        raise AssertionError("height_above_ground differs between runs")
    prop, p_first = counted(session.hag_prop, ("jump_flood_grid",),
                            "hag_prop")
    again, p_cached = counted(session.hag_prop, (), "hag_prop cached")
    if again is not prop or float(prop.max()) != 1.0:
        raise AssertionError("hag_prop missed its cache or is not in [0, 1]")
    seg_counts = session.table.count.cpu().numpy().astype(np.int64)
    seg_counts[0] = 0
    sid = int(np.argmax(seg_counts))
    # the 8 orbit cameras (bench.py's, which pivot on the scene's centre)
    # and one 30 m in front of the tree
    eye = np.eye(4, dtype=np.float32)
    eye[:3, 3] = (session.cloud.pos[session._member_mask(sid)].mean(dim=0)
                  .cpu().numpy() + [0.0, 0.0, FOCUS_DISTANCE])
    hag_cams = cams + [Camera.from_numpy(eye, FOCUS_DISTANCE, device=dev)]
    frames, f_ms = [], []
    for cam in hag_cams:
        img, ms = counted(lambda: session.render_focus(sid, cam,
                                                       display="hag"),
                          FRAME_KERNELS, "a hag focus frame")
        frames.append(img)
        f_ms.append(ms)
    with swapped(kernels, **plain):
        session._hag_cache.clear()      # the plain flood computes it anew
        same = sum(int((img == session.render_focus(sid, cam,
                                                    display="hag")).all())
                   for img, cam in zip(frames, hag_cams))
    session._hag_cache.clear()
    if same != len(frames):
        raise AssertionError(f"{len(frames) - same} hag focus frames differ "
                             "with the plain versions")
    bg = [round(c * 255.0) for c in session.config.render.background]
    lit = float(((abs(frames[-1].astype(int) - bg)).max(-1) > 3).mean())
    if not lit > 0.01:
        raise AssertionError(f"the hag focus frame in front of the tree "
                             f"shows {lit} of its pixels lit")
    log(f"  height_above_ground({HAG_CELL}): {h_ms:.2f} ms, "
        f"{int((hag > 0).sum())} points above ground, max "
        f"{float(hag.max()):.3f} m; identical to the checked pass and the "
        f"plain run; hag_prop {p_first:.2f} ms first, {p_cached:.3f} ms "
        f"cached; render_focus({sid}, display='hag') median "
        f"{statistics.median(f_ms[:-1]):.2f} ms of the {N_FRAMES} orbit "
        f"frames {[round(t, 2) for t in f_ms[:-1]]}, {f_ms[-1]:.2f} ms from "
        f"{FOCUS_DISTANCE:.0f} m in front of the tree ({lit:.4f} lit); all "
        f"{len(frames)} byte-equal to the plain versions'")

    # (d) export_raster and forest_summary
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("dtm", "dsm", "chm"):
            path = os.path.join(tmp, f"{which}.asc")
            shape, e_ms = counted(lambda: session.export_raster(
                path, which, cell=RASTER_CELLS[0]), ("jump_flood_grid",),
                f"export_raster({which})")
            with open(path) as fh:
                head = [next(fh) for _ in range(6)]
                n_rows = sum(1 for _ in fh)
            if head[0].split() != ["ncols", str(shape[1])] or \
                    n_rows != shape[0]:
                raise AssertionError(f"export_raster({which}) wrote {head}, "
                                     f"{n_rows} rows for {shape}")
            log(f"  export_raster({which}, {RASTER_CELLS[0]}): {shape[0]}x"
                f"{shape[1]}, {os.path.getsize(path)} bytes, {e_ms:.1f} ms")
    summary, s_ms = counted(session.forest_summary,
                            ("jump_flood_grid",) + INVENTORY_KERNELS,
                            "forest_summary")
    if not (0.9 * N_TREES <= summary["n_trees"] <= max_segments
            and 0.0 < summary["canopy_cover"] < 1.0
            and all(np.isfinite(v) for v in summary.values())):
        raise AssertionError(f"forest_summary: {summary}")
    log(f"  forest_summary(): {s_ms:.2f} ms (inventory + rasters("
        f"{RASTER_CELLS[0]})); {json.dumps(summary)}")

    # (e) change detection between the two epochs
    inv_a, ia_ms = counted(session.inventory, INVENTORY_KERNELS,
                           "inventory of epoch A")
    inv_b, _ = counted(epoch_b.inventory, INVENTORY_KERNELS,
                       "inventory of epoch B")
    (diff, (xll, yll), c_cell), c_ms = counted(
        lambda: change.chm_change(session, epoch_b, cell=RASTER_CELLS[0]),
        ("jump_flood_grid",), "chm_change")
    self_diff, _, _ = change.chm_change(session, session,
                                        cell=RASTER_CELLS[0])
    valid = diff != change.NODATA
    if not np.all((self_diff == 0.0) | (self_diff == change.NODATA)):
        raise AssertionError("chm_change of an epoch with itself is not null")
    if not (float(diff[valid].mean()) > 0.0
            and float(diff[valid].min()) < -1.0):
        raise AssertionError("chm_change shows no growth or no felled tree")
    changes, t_ms = counted(lambda: change.tree_changes(
        inv_a, inv_b, max_dist=CHANGE_MAX_DIST), (), "tree_changes")
    null = change.tree_changes(inv_a, inv_a, max_dist=CHANGE_MAX_DIST)
    if (len(null["lost"]["segment"]) or len(null["new"]["segment"])
            or any((null["matched"][f"delta_{t}"] != 0).any()
                   for t in change.DELTA_TRAITS)):
        raise AssertionError("tree_changes of an epoch with itself is not "
                             "null")
    felled = stem(pts[:ppt]) * (1.0, -1.0)
    new_stem = (stem(pts[ppt:2 * ppt]) + np.array(PLANT_SHIFT)[[0, 2]]) * (
        1.0, -1.0)

    def nearest(table, at):
        if not len(table["segment"]):
            return float("inf")
        return float(np.hypot(table["stem_easting"] - at[0],
                              table["stem_northing"] - at[1]).min())

    d_lost = nearest(changes["lost"], felled)
    d_new = nearest(changes["new"], new_stem)
    matched = changes["matched"]
    dh = matched["delta_tree_height"]
    dn = np.abs(matched["delta_n_points"]) / np.maximum(
        matched["n_points_a"], 1)
    same_tree = dn <= SAME_TREE_POINTS
    grown_share = float((dh > 0).mean()) if len(dh) else 0.0
    if d_lost > STEM_TOLERANCE or d_new > STEM_TOLERANCE:
        raise AssertionError(f"the felled tree's nearest lost stem is "
                             f"{d_lost:.2f} m away, the planted tree's "
                             f"nearest new stem {d_new:.2f} m")
    if not (2 * same_tree.sum() >= len(dh) and (dh[same_tree] > 0).all()):
        raise AssertionError(
            f"{int(same_tree.sum())} of {len(dh)} matched trees keep their "
            f"points within {SAME_TREE_POINTS}; of those "
            f"{int((dh[same_tree] <= 0).sum())} did not grow")
    stand = change.stand_changes(summary, epoch_b.forest_summary(inv_b))
    if not stand["max_height"]["delta"] > 0:
        raise AssertionError(f"stand_changes: {stand['max_height']}")
    log(f"  chm_change: {diff.shape[0]}x{diff.shape[1]} cells of "
        f"{c_cell} m, corner ({xll:.3f}, {yll:.3f}), {c_ms:.2f} ms; mean "
        f"change {float(diff[valid].mean()):.4f} m over {int(valid.sum())} "
        f"cells, min {float(diff[valid].min()):.3f}, max "
        f"{float(diff[valid].max()):.3f}; the self-compare is null")
    log(f"  tree_changes: {t_ms:.2f} ms (inventory {ia_ms:.2f} ms an epoch); "
        f"{len(dh)} matched, {len(changes['lost']['segment'])} lost (nearest "
        f"to the felled stem {d_lost:.2f} m), {len(changes['new']['segment'])}"
        f" new (nearest to the planted stem {d_new:.2f} m); all "
        f"{int(same_tree.sum())} that keep their points within "
        f"{SAME_TREE_POINTS} grew (height delta min "
        f"{float(dh[same_tree].min()):.3f} m); of all matched "
        f"{grown_share:.4f} grew, median {float(np.median(dh)):.3f} m, min "
        f"{float(dh.min()):.3f} m, the others' point counts changed by >= "
        f"{float(dn[dh <= 0].min()) if (dh <= 0).any() else 0.0:.4f}; the "
        f"self-compare is null; stand: n_trees "
        f"{stand['n_trees']['delta']:+d}, max_height "
        f"{stand['max_height']['delta']:+.3f} m, canopy_cover "
        f"{stand['canopy_cover']['delta']:+.4f}")
    for k in raster_launches:
        launches[k] += raster_launches[k]
    log(f"  launches over the phase: {raster_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del session, epoch_b, hag, plain_hag, checked_hag, prop, frames

    # --- phase 17: ingest, source attributes, checkpoints, point exports ---
    log("phase 17: the scan as a LAS 1.4 PDRF 7 file: Session.from_las "
        "through the native codec, with and without previews; the source "
        "attributes' properties and frames; export_las to .las and .laz; "
        "save / open as .npz and add_session of one tree's .ipc; "
        "export_points_ply of a tree and of the live cloud")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ingest_launches = dict.fromkeys(PATH_KERNELS, 0)
    counted = launch_counter(kernels, ingest_launches)
    _, native_s = native_job.result()
    log(f"  native codec {os.path.relpath(native_build._LIB_PATH)}: built "
        f"beside nvcc in phase 0 in {native_s:.1f} s")
    rng = np.random.default_rng(0)
    intensity = rng.integers(0, 1 << 16, n, dtype=np.uint16)
    rgb = rng.integers(0, 1 << 16, (n, 3), dtype=np.uint16)
    gps = GPS_EPOCH + rng.uniform(0.0, GPS_SPAN, n)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        src = os.path.join(tmp, "scan.las")
        t0 = time.perf_counter()
        rec = np.zeros((n, las.POINT_LENGTHS[7]), np.uint8)
        rec[:, 12:14] = intensity.astype("<u2").view(np.uint8).reshape(n, 2)
        rec[:, 14] = 0x11   # return 1 of 1
        rec[:, 22:30] = gps.astype("<f8").view(np.uint8).reshape(n, 8)
        rec[:, 30:36] = rgb.astype("<u2").view(np.uint8).reshape(n, 6)
        las.write_las(src, pts, point_format=7, records=rec,
                      las_offset=np.array(LAS_OFFSET))
        del rec
        log(f"  write_las: {os.path.getsize(src)} bytes in "
            f"{time.perf_counter() - t0:.2f} s")

        # (a) from_las without previews, against las.load and from_points
        t0 = time.perf_counter()
        scan = las.load(src)
        load_s = time.perf_counter() - t0
        session, a_ms = counted(lambda: pipeline.Session.from_las(
            src, device=dev), (), "from_las")
        cap = session.cloud.capacity
        if not (session.cloud.count == n and np.array_equal(
                session.cloud.pos[:n].cpu().numpy(), scan.pos)):
            raise AssertionError("from_las: positions differ from las.load")
        for attr, ref in (("intensity", intensity), ("rgb", rgb),
                          ("gps_time", gps)):
            got = session.attributes[attr]
            if not (len(got) == cap and np.array_equal(got[:n], ref)
                    and not got[n:].any()):
                raise AssertionError(f"from_las: attribute {attr} differs")
        _, seg_ms = counted(lambda: session.segment(MAX_DISTANCE),
                            MAIN_PATH_KERNELS, "segment() of the loaded scan")
        ref_s = pipeline.Session.from_points(scan.pos, device=dev)
        ref_s.segment(MAX_DISTANCE)
        if not (torch.equal(session.cloud.segment, ref_s.cloud.segment)
                and torch.equal(session.cloud.classification,
                                ref_s.cloud.classification)):
            raise AssertionError("from_las: ids or classes differ from "
                                 "from_points(las.load(...).pos)")
        n_seg_loaded = len(torch.unique(session.cloud.segment[
            session.cloud.alive]))
        del ref_s, scan
        log(f"  las.load {load_s:.2f} s (native decode); from_las "
            f"{a_ms / 1e3:.2f} s; positions equal las.load's, intensity, "
            f"rgb and gps_time the records'; segment() {seg_ms:.1f} ms, "
            f"{n_seg_loaded} segments, ids and classes equal "
            f"from_points(las.load(...).pos)'s; world_offset "
            f"{session.world_offset.tolist()}")

        # (b) from_las with previews, against the plain versions
        frames, plain_frames = [], []
        _, b_ms = counted(lambda: pipeline.Session.from_las(
            src, preview_cb=frames.append, slab_points=SLAB_POINTS,
            device=dev), FRAME_KERNELS, "from_las(preview_cb=...)")
        with swapped(kernels, **plain):
            pipeline.Session.from_las(src, preview_cb=plain_frames.append,
                                      slab_points=SLAB_POINTS, device=dev)
        bg = [round(c * 255.0) for c in session.config.render.background]
        lit = [float((abs(f.astype(int) - bg).max(-1) > 3).mean())
               for f in frames]
        if len(frames) != -(-n // SLAB_POINTS) or len(plain_frames) != len(
                frames) or not lit[-1] > 0.0:
            raise AssertionError(f"from_las gave {len(frames)} preview "
                                 f"frames ({len(plain_frames)} plain), lit "
                                 f"{lit}")
        same = sum(int(np.array_equal(a, b))
                   for a, b in zip(frames, plain_frames))
        if same != len(frames):
            raise AssertionError(f"{len(frames) - same} preview frames "
                                 "differ from the plain versions'")
        log(f"  from_las(preview_cb=..., slab_points={SLAB_POINTS}): "
            f"{b_ms / 1e3:.2f} s, {len(frames)} frames of "
            f"{frames[0].shape[1]}x{frames[0].shape[0]}, lit "
            f"{[round(x, 4) for x in lit]}; byte-equal to the plain "
            "versions'")

        # (c) the attributes' properties and frames
        valid = session.cloud.valid.cpu().numpy()
        want = {}
        v = session.attributes["intensity"].astype(np.float32)
        want["intensity"] = v / max(float(v.max(initial=0.0)), 1e-12)
        a32 = session.attributes["rgb"].astype(np.int32)
        a32 = a32 << (8 if a32.max(initial=0) <= 255 else 0)
        cube = ((a32[:, 0] >> 13) << 5) | ((a32[:, 1] >> 13) << 2) | (
            a32[:, 2] >> 14)
        want["rgb"] = (cube.astype(np.float32) + 0.5) / 256.0
        t64 = session.attributes["gps_time"]
        keep = valid & (t64 != 0.0)
        lo_t, hi_t = float(t64[keep].min()), float(t64[keep].max())
        want["gps_time"] = ((t64 - lo_t) / max(hi_t - lo_t, 1e-12)).astype(
            np.float32)
        counts = session.table.count.cpu().numpy().astype(np.int64)
        counts[0] = 0
        sid = int(np.argmax(counts))
        eye = np.eye(4, dtype=np.float32)
        eye[:3, 3] = (session.cloud.pos[session._member_mask(sid)].mean(dim=0)
                      .cpu().numpy() + [0.0, 0.0, FOCUS_DISTANCE])
        focus_cam = Camera.from_numpy(eye, FOCUS_DISTANCE, device=dev)
        for attr in ("intensity", "rgb", "gps_time"):
            (prop, pal), p_ms = counted(
                lambda: session.attribute_prop(attr), (),
                f"attribute_prop({attr})")
            _, p_cached = counted(lambda: session.attribute_prop(attr), (),
                                  f"attribute_prop({attr}) cached")
            if not (prop.device == session.cloud.pos.device and np.array_equal(
                    prop.cpu().numpy().view(np.int32),
                    want[attr].view(np.int32))):
                raise AssertionError(f"attribute_prop({attr}) differs from "
                                     "its numpy recomputation")
            drawn, f_ms = [], []
            for draw in (lambda: session.render(cams[0], prop=prop,
                                                palette=pal),
                         lambda: session.render_focus(sid, focus_cam,
                                                      display=attr)):
                img, ms = counted(draw, FRAME_KERNELS, f"a {attr} frame")
                with swapped(kernels, **plain):
                    if not np.array_equal(img, draw()):
                        raise AssertionError(f"a {attr} frame differs from "
                                             "the plain versions'")
                drawn.append(float((abs(img.astype(int) - bg).max(-1)
                                    > 3).mean()))
                f_ms.append(ms)
            if not min(drawn) > 0.01:
                raise AssertionError(f"{attr} frames lit {drawn}")
            log(f"  attribute_prop({attr}): {p_ms:.1f} ms (numpy on the "
                f"host, then one copy), {p_cached:.3f} ms cached, bit-equal "
                f"to the numpy recomputation; full-cloud frame "
                f"{f_ms[0]:.2f} ms, focus frame of segment {sid} "
                f"{f_ms[1]:.2f} ms (lit {[round(x, 4) for x in drawn]}), "
                "both byte-equal to the plain versions'")

        # (d) export_las to .las and .laz, read back
        seg_np = session.cloud.segment.cpu().numpy()
        cls_np = session.cloud.classification.cpu().numpy()
        pos_np = session.cloud.pos.cpu().numpy()

        def check_export(path, n_out, member):
            back = las.load(path)
            want_cls = np.asarray(ASPRS, np.uint8)[cls_np[member]]
            ok = (len(back.pos) == n_out == int(member.sum())
                  and back.header.point_format == 7
                  and np.array_equal(back.attributes["file_classification"],
                                     want_cls)
                  and np.array_equal(back.attributes["intensity"],
                                     session.attributes["intensity"][member])
                  and np.array_equal(back.attributes["rgb"],
                                     session.attributes["rgb"][member])
                  and np.array_equal(back.attributes["gps_time"],
                                     session.attributes["gps_time"][member]))
            world = back.pos.astype(np.float64) + back.world_offset
            orig = pos_np[member].astype(np.float64) + session.world_offset
            err = float(np.abs(world - orig).max())
            if not ok or err > 2e-3:
                raise AssertionError(f"{path}: the export does not read back "
                                     f"(ok {ok}, position error {err})")
            return back, err

        alive = session.cloud.alive.cpu().numpy()
        las_path = os.path.join(tmp, "export.las")
        n_las, e_ms = counted(lambda: session.export_las(las_path), (),
                              "export_las(.las)")
        _, err = check_export(las_path, n_las, alive)
        with open(las_path, "rb") as fh:
            hdr = las.LasHeader.parse(fh.read(375))
            fh.seek(hdr.offset_to_point_data)
            raw = np.frombuffer(fh.read(n_las * hdr.point_length), np.uint8)
        psid = raw.reshape(n_las, -1)[:, 20:22].copy().view("<u2")[:, 0]
        if not np.array_equal(psid, np.minimum(seg_np[alive], 0xFFFF)):
            raise AssertionError("export_las: point_source_id is not the "
                                 "segment id")
        del raw, psid
        log(f"  export_las(.las): {n_las} points, "
            f"{os.path.getsize(las_path)} bytes, {e_ms / 1e3:.2f} s; read "
            f"back: ASPRS classes, point_source_id, intensity, rgb, gps_time "
            f"equal, positions within {err:.2e} m in the map frame")
        os.unlink(las_path)
        member = alive & (seg_np == sid)
        tree_laz = os.path.join(tmp, "tree.laz")
        n_tree, zt_ms = counted(lambda: session.export_las(
            tree_laz, segment_id=sid), (), "export_las(tree .laz)")
        check_export(tree_laz, n_tree, member)
        estimate_s = zt_ms / 1e3 * n_las / max(n_tree, 1)
        if estimate_s <= LAZ_BUDGET_S:
            laz_path = os.path.join(tmp, "export.laz")
            n_laz, z_ms = counted(lambda: session.export_las(laz_path), (),
                                  "export_las(.laz)")
            t0 = time.perf_counter()
            check_export(laz_path, n_laz, alive)
            log(f"  export_las(.laz): {n_laz} points, "
                f"{os.path.getsize(laz_path)} bytes, {z_ms / 1e3:.2f} s "
                f"(expected {estimate_s:.1f} s from segment {sid}'s "
                f"{n_tree} points in {zt_ms:.1f} ms); read back in "
                f"{time.perf_counter() - t0:.2f} s, equal as the .las")
            os.unlink(laz_path)
        else:
            log(f"  export_las(.laz): segment {sid} alone, {n_tree} points "
                f"in {zt_ms:.1f} ms, read back equal as the .las; the live "
                f"cloud would take about {estimate_s:.1f} s > "
                f"{LAZ_BUDGET_S:.0f} s, so it is cut to the tree")

        # (e) save / open as .npz, add_session of one tree's .ipc
        npz = os.path.join(tmp, "session.npz")
        _, sv_ms = counted(lambda: session.save(npz), (), "save(.npz)")
        opened, op_ms = counted(lambda: pipeline.Session.open(npz,
                                                              device=dev),
                                (), "open(.npz)")
        live_t = session.cloud.valid
        ok = opened.cloud.count == n and all(
            torch.equal(getattr(opened.cloud, f)[:n],
                        getattr(session.cloud, f)[live_t])
            for f in ("pos", "segment", "classification"))
        ok = ok and all(np.array_equal(opened.attributes[k][:n],
                                       session.attributes[k][valid])
                        for k in ("intensity", "rgb", "gps_time"))
        if not ok:
            raise AssertionError("open(save(.npz)) differs from the session")
        part = os.path.join(tmp, "tree.ipc")
        _, si_ms = counted(lambda: session.save(part, segment_id=sid), (),
                           "save(tree .ipc)")
        top = int(opened.cloud.segment.max())
        _, ad_ms = counted(lambda: opened.add_session(part), (),
                           "add_session(.ipc)")
        m_valid = opened.cloud.valid.cpu().numpy()
        m_seg = opened.cloud.segment.cpu().numpy()[m_valid]
        m_pos = opened.cloud.pos.cpu().numpy()[m_valid]
        m_cls = opened.cloud.classification.cpu().numpy()[m_valid]
        tree_pos, tree_cls = pos_np[member], cls_np[member]
        o_new, o_tree = (np.lexsort(m_pos[n:].T[::-1]),
                         np.lexsort(tree_pos.T[::-1]))
        if not (len(m_seg) == n + n_tree and (m_seg[n:] == top + 1).all()
                and np.array_equal(m_seg[:n], seg_np[valid])
                and np.array_equal(m_pos[n:][o_new], tree_pos[o_tree])
                and np.array_equal(m_cls[n:][o_new], tree_cls[o_tree])
                and not opened.attributes["intensity"][n:n + n_tree].any()
                and opened.table is None):
            raise AssertionError("add_session(.ipc): the merged tree is not "
                                 f"segment {top + 1} with its points")
        log(f"  save(.npz) {sv_ms / 1e3:.2f} s, {os.path.getsize(npz)} "
            f"bytes; open {op_ms / 1e3:.2f} s, ids, classes, positions and "
            f"attributes equal; save(segment {sid} as .ipc) {si_ms:.1f} ms; "
            f"add_session {ad_ms / 1e3:.2f} s: its {n_tree} points as "
            f"segment {top + 1} (ipc.merge renumbers past {top}), "
            f"attributes zero-filled")
        del opened, m_seg, m_pos, m_cls
        os.unlink(npz)

        # (f) export_points_ply of the tree and of the live cloud
        ply_tree = os.path.join(tmp, "tree.ply")
        n_pt, pt_ms = counted(lambda: session.export_points_ply(
            ply_tree, segment_id=sid), ("segmented_cummax",),
            "export_points_ply(tree)")
        body = np.loadtxt(ply_tree, skiprows=10, ndmin=2)
        if not (n_pt == n_tree == len(body) and np.isfinite(body).all()
                and (body[:, 5] > 0).any()):
            raise AssertionError("export_points_ply(tree) wrote "
                                 f"{len(body)} rows for {n_tree}")
        _, gc_ms = counted(lambda: characteristics.segment_curvature(
            session.cloud.pos, session.cloud.alive,
            k=session.config.characteristics.neighbors, use_grid=True), (),
            "grid curvature of the live cloud")
        ply_all = os.path.join(tmp, "live.ply")
        n_pa, pa_ms = counted(lambda: session.export_points_ply(ply_all),
                              ("segmented_cummax",),
                              "export_points_ply(live)")
        lines = 0
        with open(ply_all, "rb") as fh:
            while chunk := fh.read(1 << 26):
                lines += chunk.count(b"\n")
        if not (n_pa == n_las and lines == n_pa + 10):
            raise AssertionError(f"export_points_ply(live) wrote {lines} "
                                 f"lines for {n_pa} points")
        log(f"  export_points_ply(segment {sid}): {n_pt} points, brute "
            f"curvature, {pt_ms:.1f} ms; export_points_ply(live cloud): "
            f"{n_pa} points, {os.path.getsize(ply_all)} bytes, "
            f"{pa_ms / 1e3:.2f} s, of which the grid curvature alone takes "
            f"{gc_ms / 1e3:.2f} s")
        os.unlink(ply_all)
    except BaseException:
        # phase 18 reads the scan file; after a failure nothing will
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for k in ingest_launches:
        launches[k] += ingest_launches[k]
    log(f"  launches over the phase: {ingest_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del session

    # --- phase 18: the front ends on the scan phase 17 wrote ---
    log("phase 18: the front ends on the scan file of phase 17: the CLI "
        "(app.main, 8 frames and the exports; --save and reopen on the "
        "demo scene), a REPL over the session fed a scripted command "
        "stream, and the browser viewer over it")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    front_launches = dict.fromkeys(launches, 0)
    try:
        front_ends(src, n, tmp, dev, launch_counter(kernels, front_launches),
                   pipeline, Camera)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in front_launches:
        launches[k] += front_launches[k]
    log(f"  launches over the phase: {front_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # --- phase 19: surveys beyond one card ---
    log(f"phase 19: surveys beyond one card: the sharded step and rasters "
        f"over {SHARDS} shards of the card, tiles over that mesh, "
        f"bench_tiled's {SURVEY_POINTS // 1_000_000}M survey in "
        f"{SURVEY_TILES} tiles with its rasters, and the survey untiled")
    t_phase = time.perf_counter()
    survey_launches = dict.fromkeys(launches, 0)
    surveys(pts, dev, kernels, launch_counter(kernels, survey_launches),
            (pipeline, rasters, segmentation, sharding, tiles, bench_tiled,
             survey_trees))
    for k in survey_launches:
        launches[k] += survey_launches[k]
    log(f"  launches over the phase: {survey_launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # --- phase 20: one session over a mesh ---
    log(f"phase 20: one Session over a mesh of {SHARDS} shards of the card "
        "(from_points(mesh=...)) against a one-device Session on its rows: "
        "segment, table, frames, LOD and adaptive cuts, strokes, pick, "
        "rasters, inventory, the focused view, a REPL and the viewer")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh_launches = dict.fromkeys(launches, 0)
    mesh_session(pts, dev, launch_counter(kernels, mesh_launches),
                 (pipeline, sharding, rbv, trunk_axis, repl, serve,
                  Camera))
    for k in mesh_launches:
        launches[k] += mesh_launches[k]
    log(f"  launches over the phase: {mesh_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"],
         "device_ms": results[k]["device_ms"],
         "shapes": results[k]["shapes"]}
        for k, src, tpu in KERNELS]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
