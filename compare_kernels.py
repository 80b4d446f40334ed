#!/usr/bin/env python3
"""Time two builds of the ``cc_sweep``, ``match_scan``, ``segmented_cummax``,
``segmented_cumsum``, ``jump_flood``, ``take_along_axis``,
``nearest_slot`` and ``knn_select`` kernels (and the frame's) against
each other on one CUDA card: this tree's sources and those of another
commit.

    mkdir -p build/parent
    git archive <commit> treee_tpu_torch/ops/kernels/csrc \\
        | tar -x --strip-components=4 -C build/parent
    python3 compare_kernels.py build/parent [--reps 7] \\
        [--only cc|scans|flood|grid|gather|frame|voronoi|knn]

Each build takes the chosen kernels' sources and ``common.cu`` from its
directory and the port's nvcc flags, into ``build/compare_kernels/``.
Inputs, each held bit for bit against this tree's plain version for the
shipped build (and for the other build too, except the scans where the two
trees' tie rules for signed zeros may differ: there the other build is held
against this tree's only where no zero is involved):

- every ``cc_sweep`` call and the ``match_scan`` call of one
  ``Session.segment(0.75)`` on bench.py's 15M-point scan;
- every distinct shape of a ``segmented_cummax`` and ``segmented_cumsum``
  call of that step and of both inventory forms, and two synthetic key
  layouts at 15M rows and the widest recorded width: one run over the whole
  array, and all keys distinct.  The scans' scratch is allocated outside the
  timed interval.  With the shipped build, the device time of each CUDA
  launch of one call at each shape (``torch.profiler``);
- one full 384 x 384 band whose minimum needs 383 sweeps to cross it, at 1,
  2, 16 and 64 sweeps (the per-sweep cost of a band);
- stacks of 1 to 64 such bands at 64 sweeps: every band busy to the last
  sweep, the case where the cluster design's waves of resident clusters
  cost the most;
- 64 bands of a random 60% fill at 64 sweeps, at G = 384, 512 and 1024;
- ``--only flood``: the ``jump_flood`` call of one flood-fill
  ``Session.segment(0.75)`` (``use_bruteforce_voronoi=False,
  use_packed_jfa=False``) on that scan, with its seeded bands, route and
  resident clusters, and 64 bands with a seed in every band at G = 384
  (shared-memory route) and 512 (device-memory route); each launch's device
  time;
- ``--only grid``: the rasters' grid flood (the grid entry of
  ``jump_flood.cu``) at the inputs of ``Session.rasters(0.5)``,
  ``rasters(0.1)`` and ``height_above_ground(1.0)`` of that scan once
  segmented, and at synthetic DTM holes on 640 x 640 (the 100M survey's
  1 m grid) and 4096 x 4096 (the cap): the other build through its entry
  (the first design takes (row, col) planes, made outside the timing) and
  this tree's wrapper, each bit-equal to the plain flood, and each build's
  device time a call and CUDA launches;
- ``--only gather``: the gather probe's four shapes and three tables beyond
  48 KB; the wrapper and ``torch.take_along_dim`` / ``tab[idx]`` beside the
  two builds, each part of the wrapper's host work over 1000 calls, and
  the device time of each kernel and of torch's (``torch.profiler``);
- ``--only frame``: ``dilate`` and ``eye_dome`` at the inputs of bench.py's
  8 orbit frames of the segmented 15M scan, and ``dilate`` at a 720p key
  image with a splat on every pixel at r=3 and r=8; beside the two
  builds' eye-dome a third, ``variants/eye_dome_tile.cu`` (a 2-D tile of
  linearized depths in shared memory); each build's device time a call,
  this tree's wrappers against the first design's (allocations and
  constants as it made them) in turns, the dilation's skipped tiles, and
  the eye-dome wrapper's host work by part;
- ``--only voronoi``: ``nearest_slot`` (the step's occupied-cell Voronoi)
  at the call of one ``Session.segment(0.75)`` on that scan and with every
  row valid and every slot active; a tree without ``nearest_slot.cu``
  builds none, and the kernel is timed beside the plain version alone;
- ``--only knn``: ``knn_select`` (the focused view's brute-force k-NN, k =
  31) on one synthetic tree of 8,000, 16,000 and 40,072 members in snug
  buffers of 8,192, 16,384 and 40,960 rows (the focus cell's trees), with
  its bound (8 operations a pair at 67 TFLOP/s), the wrapper against the
  plain version in turns, one ``torch.topk`` over the plain version's
  [rows, rows] int64 keys (made outside the timing) as the library's
  yardstick, and the device time a call; a tree without
  ``knn_select.cu`` builds none.

Times are medians of ``--reps`` CUDA-event intervals around one call of the
C entry point (no wrapper), the builds in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from treee_tpu_torch.ops.kernels import build

SOURCES = {"cc": ("cc_sweep.cu", "match_scan.cu"),
           "scans": ("seg_cummax.cu", "seg_cumsum.cu"),
           "flood": ("jump_flood.cu",), "grid": ("jump_flood.cu",),
           "gather": ("take_along.cu",),
           "frame": ("dilate.cu", "eye_dome.cu"),
           "voronoi": ("nearest_slot.cu",), "knn": ("knn_select.cu",)}
# the eye-dome design that linearizes each depth once, timed beside the
# shipped one
EYE_DOME_TILE = (Path(__file__).resolve().parent / "variants"
                 / "eye_dome_tile.cu")
OUT_DIR = build.BUILD_DIR.parent / "compare_kernels"


def with_eye_dome(source: Path) -> Path:
    """This tree's kernel sources with ``eye_dome.cu`` taken from
    ``source``, copied into a directory of their own."""
    where = OUT_DIR / source.stem
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(build.CSRC, where)
    shutil.copyfile(source, where / "eye_dome.cu")
    return where


def load(name: str, where: Path, groups) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"lib_{name}.so"
    files = [f for k in groups for f in SOURCES[k]] + ["common.cu"]
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
           *(str(where / f) for f in files)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    print(f"{name}: built in {time.perf_counter() - t0:.1f} s; {regs}")
    lib = ctypes.CDLL(str(out))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    if "cc" in groups:
        lib.treee_cc_sweep.argtypes = [p, p, p, i, i, i, p]
        lib.treee_match_scan.argtypes = [p, p, i, i, i, i, f, p, p, p, p]
    if "scans" in groups:
        lib.treee_seg_cummax.argtypes = [p, p, p, ll, i, p, p]
        lib.treee_seg_cummax_scratch_bytes.argtypes = [ll, i]
        lib.treee_seg_cummax_scratch_bytes.restype = ll
        lib.treee_seg_cumsum.argtypes = [p, p, p, ll, i, i, p, p]
        lib.treee_seg_cumsum_scratch_bytes.argtypes = [ll, i, i]
        lib.treee_seg_cumsum_scratch_bytes.restype = ll
    if "flood" in groups:
        # the cluster design (this tree) or the earlier one launch a direction
        lib.cluster_flood = hasattr(lib, "treee_jump_flood_clusters")
        lib.treee_jump_flood.argtypes = (
            [p, p, p, p, p, i, i, i, p] if lib.cluster_flood
            else [p, p, p, p, p, p, p, i, i, p])
    if "grid" in groups:
        # this tree's grid flood (tiles with a plan, the rasters' form) or
        # the first one (a launch a direction, position planes)
        lib.grid_tiles = "grid_tiles" in (where / "jump_flood.cu").read_text()
        lib.treee_jump_flood_grid.argtypes = (
            [p, p, p, p, p, p, p, i, i, i, p] if lib.grid_tiles
            else [p, p, p, p, p, p, i, i, i, p])
    if "gather" in groups:
        lib.treee_take_along.argtypes = [p, p, p, i, i, i, i, p]
    if "voronoi" in groups:
        lib.treee_nearest_slot.argtypes = [p] * 7 + [i] * 4 + [p]
    if "knn" in groups:
        lib.treee_knn_select.argtypes = [p] * 4 + [i] * 2 + [p]
    if "frame" in groups:
        # this tree's dilation takes a stats pointer before the stream
        lib.tile_dilate = hasattr(lib, "treee_dilate_core_cols")
        lib.treee_dilate.argtypes = ([p, p, p, p, p, i, i, i, f, f, f, f]
                                     + [p] * (2 if lib.tile_dilate else 1))
        lib.treee_eye_dome.argtypes = [p, p, p, i, i, f, f, f, f, f, f, f, p]
        # the packed twins, called as the wrappers call them
        lib.held = ctypes.PyDLL(str(out))
    return lib


def cc_call(lib, lbl, sweeps):
    out, tmp = torch.empty_like(lbl), torch.empty_like(lbl)
    b, g, _ = lbl.shape
    build.check(lib.treee_cc_sweep(lbl.data_ptr(), out.data_ptr(),
                                   tmp.data_ptr(), b, g, sweeps,
                                   build.stream(lbl)), "cc_sweep")
    return out


def match_call(lib, cents, cmask, radius, rounds, t_cap):
    b, c_cap, _ = cents.shape
    pos = torch.empty(b, t_cap, 2, dtype=torch.float32, device=cents.device)
    act = torch.empty(b, t_cap, dtype=torch.bool, device=cents.device)
    n = torch.empty((), dtype=torch.int32, device=cents.device)
    build.check(lib.treee_match_scan(
        cents.data_ptr(), cmask.data_ptr(), b, c_cap, t_cap, rounds,
        float(radius), pos.data_ptr(), act.data_ptr(), n.data_ptr(),
        build.stream(cents)), "match_scan")
    return pos, act, n


_scratch: dict = {}


def _scan_buffers(lib, name: str, val, nbytes: int):
    """Output and scratch of one build's scan at one shape, made once."""
    k = (id(lib), name, tuple(val.shape))
    if k not in _scratch:
        _scratch[k] = (torch.empty_like(val),
                       torch.empty(nbytes, dtype=torch.uint8, device=val.device))
    return _scratch[k]


def cummax_call(lib, key, val):
    n, c = val.shape[0], 1 if val.dim() == 1 else val.shape[1]
    out, scratch = _scan_buffers(lib, "cummax", val,
                                 lib.treee_seg_cummax_scratch_bytes(n, c))
    build.check(lib.treee_seg_cummax(key.data_ptr(), val.data_ptr(),
                                     out.data_ptr(), n, c, scratch.data_ptr(),
                                     build.stream(key)), "segmented_cummax")
    return out


def cumsum_call(lib, key, val, block=8192):
    n, c = val.shape[0], 1 if val.dim() == 1 else val.shape[1]
    out, scratch = _scan_buffers(
        lib, "cumsum", val, lib.treee_seg_cumsum_scratch_bytes(n, c, block))
    build.check(lib.treee_seg_cumsum(key.data_ptr(), val.data_ptr(),
                                     out.data_ptr(), n, c, block,
                                     scratch.data_ptr(), build.stream(key)),
                "segmented_cumsum")
    return out


def flood_call(lib, slot, pos, cc):
    b, g, _ = slot.shape
    out, tmp = torch.empty_like(slot), torch.empty_like(slot)
    if lib.cluster_flood:
        from treee_tpu_torch.ops import kernels
        args = (b, g, int(kernels.jump_flood_route(g) == "shared"))
    else:
        xy = torch.empty((2, b, g, g, 2), dtype=torch.float32,
                         device=slot.device)
        args = (xy[0].data_ptr(), xy[1].data_ptr(), b, g)
    build.check(lib.treee_jump_flood(slot.data_ptr(), pos.data_ptr(),
                                     cc.data_ptr(), out.data_ptr(),
                                     tmp.data_ptr(), *args,
                                     build.stream(slot)), "jump_flood")
    return out


def grid_call(lib, slot, steps):
    """One grid flood through a build's entry, its buffers and host arrays
    made once a shape (outside the timing): this tree's in the rasters'
    form with the wrapper's plan, the first design with (row, col)
    planes."""
    from treee_tpu_torch.ops import kernels
    from treee_tpu_torch.ops.kernels.jump_flood import cell_positions
    h, w = slot.shape
    k = (id(lib), "grid", h, w, tuple(steps))
    if k not in _scratch:
        host_steps = (ctypes.c_int * max(1, len(steps)))(*steps)
        at = None if lib.grid_tiles else cell_positions(h, w, slot.device)
        flat = [v for e in kernels.jump_flood_grid_plan(h, w, tuple(steps))
                for v in e]
        tiles = (ctypes.c_int * max(1, len(flat)))(*flat)
        _scratch[k] = (torch.empty_like(slot), torch.empty_like(slot), at,
                       host_steps, tiles)
    out, tmp, at, host_steps, tiles = _scratch[k]
    if lib.grid_tiles:
        args = (0, 0, out.data_ptr(), tmp.data_ptr(),
                ctypes.addressof(host_steps), ctypes.addressof(tiles),
                len(steps), h, w)
    else:
        args = (at.data_ptr(), at.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                ctypes.addressof(host_steps), len(steps), h, w)
    build.check(lib.treee_jump_flood_grid(slot.data_ptr(), *args,
                                          build.stream(slot)),
                "jump_flood_grid")
    return out


def gather_call(lib, tab, idx, axis):
    out = torch.empty(idx.shape, dtype=torch.float32, device=tab.device)
    if axis is None:
        rows, cols, m, ax = 1, tab.shape[0], idx.numel(), -1
    else:
        (rows, cols), m, ax = tab.shape, idx.shape[axis], axis
    build.check(lib.treee_take_along(tab.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), rows, cols, m, ax,
                                     build.stream(tab)), "take_along_axis")
    return out


def voronoi_call(lib, occ_idx, occ_valid, pos, act, lo, s, n_bands, g):
    """One occupied-cell Voronoi through a build's entry, its output made
    once a shape (outside the timing)."""
    k = (id(lib), "voronoi", n_bands, g)
    if k not in _scratch:
        _scratch[k] = torch.empty((n_bands, g, g), dtype=torch.int32,
                                  device=occ_idx.device)
    out = _scratch[k]
    build.check(lib.treee_nearest_slot(
        occ_idx.data_ptr(), occ_valid.data_ptr(), pos.data_ptr(),
        act.data_ptr(), lo.data_ptr(), s.data_ptr(), out.data_ptr(),
        occ_idx.shape[0], n_bands, pos.shape[1], g, build.stream(occ_idx)),
        "nearest_slot")
    return out


def launch_times(label: str, fn) -> None:
    """Device time of each CUDA launch of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if t <= 0 or e.key.startswith(("aten::", "cuda")):
            continue
        # "void (anonymous namespace)::scan_tiles<8>(int const*, ...)"
        m = re.search(r"(\w+(?:<[\d, ]+>)?)\(", e.key.replace(
            "(anonymous namespace)::", ""))
        rows.append((m.group(1) if m else e.key[:40], e.count, t))
    print(f"{label}: launches " + (", ".join(
        f"{k} x{n} {t / 1e3:.4f} ms" for k, n, t in rows)
        or "no device time reported"), flush=True)


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def compare(label: str, libs: dict, call, args, ref, reps: int,
            card: str, same=lambda name, a, b: torch.equal(a, b)) -> None:
    """Bit equality of both builds (``same(build, got, ref)``), then their
    median times in turns."""
    for name, lib in libs.items():
        got = call(lib, *args)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        if not all(same(name, a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 "version")
    times = {name: [] for name in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(reps):
        for name in order:
            times[name].append(event_ms(lambda: call(libs[name], *args)))
    print(f"{label}: bit-equal; median ms " + ", ".join(
        f"{n} {statistics.median(t):.4f}" for n, t in times.items())
        + f"   [{card}]", flush=True)


def full_band(g: int, b: int) -> torch.Tensor:
    """b bands, every cell occupied, labels falling along the rows: the
    minimum starts in the last cell and needs g - 1 sweeps to cross."""
    idx = torch.arange(g * g, dtype=torch.int32, device="cuda").view(1, g, g)
    return (g * g - 1 - idx).expand(b, g, g).contiguous()


def random_fill(g: int, b: int, fill: float, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    occ = rng.random((b, g, g)) < fill
    lbl = np.where(occ, np.arange(g * g, dtype=np.int32).reshape(1, g, g),
                   0x7FFFFFFF).astype(np.int32)
    return torch.from_numpy(lbl).cuda()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path,
                    help="directory with the other commit's kernel sources")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", choices=tuple(SOURCES), default=None,
                    help="one group's kernels only: cc_sweep and match_scan, "
                         "the two scans, jump_flood, take_along_axis, "
                         "the frame's dilate and eye_dome, nearest_slot "
                         "or knn_select")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    from treee_tpu_torch import pipeline
    from treee_tpu_torch.io import las
    from treee_tpu_torch.ops import kernels
    from treee_tpu_torch.tools.probe_extract import card as card_line

    card = card_line()
    groups = tuple(SOURCES) if args.only is None else (args.only,)
    # an earlier tree may lack a group's sources: its build leaves it out
    there = tuple(k for k in groups
                  if all((args.parent / f).exists() for f in SOURCES[k]))
    libs = {"parent": load("parent", args.parent, there),
            "shipped": load("shipped", build.CSRC, groups)}
    if "gather" in groups:
        compare_gather(libs, kernels, args.reps, card)
    if "knn" in groups:
        compare_knn({n: lib for n, lib in libs.items()
                     if n == "shipped" or "knn" in there},
                    las, kernels, args.reps, card)
    if groups in (("gather",), ("knn",)):
        return 0
    pts = las.synthetic_forest(n_trees=937, spacing=7.0,
                               points_per_tree=12_000,
                               ground_points=15_000_000 - 937 * 12_000, seed=0)
    if "cc" in groups:
        compare_cc_and_match(libs, pts, pipeline, kernels, args.reps, card)
    if "scans" in groups:
        compare_scans(libs, pts, pipeline, kernels, args.reps, card)
    if "flood" in groups:
        compare_flood(libs, pts, pipeline, kernels, args.reps, card)
    if "grid" in groups:
        compare_grid(libs, pts, pipeline, kernels, args.reps, card)
    if "voronoi" in groups:
        compare_voronoi({n: lib for n, lib in libs.items()
                         if n == "shipped" or "voronoi" in there},
                        pts, pipeline, kernels, args.reps, card)
    if "frame" in groups:
        tile = load("eye_dome_tile", with_eye_dome(EYE_DOME_TILE), ("frame",))
        compare_frame(libs, {**libs, "eye-dome tile": tile}, pts, pipeline,
                      kernels, args.reps, card)
    return 0


def compare_cc_and_match(libs, pts, pipeline, kernels, reps, card) -> None:
    def cc(label, lbl, sweeps):
        compare(label, libs, cc_call, (lbl, sweeps),
                (kernels.cc_sweep_plain(lbl, sweeps),), reps, card)

    for sweeps in (1, 2, 16, 64):
        cc(f"cc_sweep, one full 384 band, {sweeps} sweeps", full_band(384, 1),
           sweeps)
    for b in (8, 15, 16, 30, 45, 64):
        cc(f"cc_sweep, {b} full 384 bands, 64 sweeps", full_band(384, b), 64)
    for g in (384, 512, 1024):
        cc(f"cc_sweep, 64 bands of G={g} at 60% random fill, 64 sweeps",
           random_fill(g, 64, 0.6, g), 64)

    cc_in, ms_in = [], []
    cc_kernel, ms_kernel = kernels.cc_sweep, kernels.match_scan

    def cc_recorded(lbl, sweeps):
        cc_in.append((lbl.clone(), sweeps))
        return cc_kernel(lbl, sweeps)

    def ms_recorded(*a):
        ms_in.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return ms_kernel(*a)

    kernels.cc_sweep, kernels.match_scan = cc_recorded, ms_recorded
    try:
        pipeline.Session.from_points(pts, device="cuda").segment(0.75)
    finally:
        kernels.cc_sweep, kernels.match_scan = cc_kernel, ms_kernel
    torch.cuda.synchronize()
    for i, (lbl, sweeps) in enumerate(cc_in, start=1):
        cc(f"cc_sweep, main-path body {i}", lbl, sweeps)
    for a in ms_in:
        compare("match_scan, main path", libs, match_call, a,
                kernels.match_scan_plain(*a), reps, card)


def compare_scans(libs, pts, pipeline, kernels, reps, card) -> None:
    """The two scans at every distinct shape of the step and both inventory
    forms, and at two synthetic key layouts."""
    calls = {"segmented_cummax": [], "segmented_cumsum": []}
    wrappers = {k: getattr(kernels, k) for k in calls}

    def recording(name):
        def record(key, val, *rest):
            if all(v.shape != val.shape for _, v in calls[name]):
                calls[name].append((key.clone(), val.clone()))
            return wrappers[name](key, val, *rest)
        return record

    for name in calls:
        setattr(kernels, name, recording(name))
    try:
        forest = pipeline.Session.from_points(pts, device="cuda")
        forest.segment(0.75)
        forest.inventory()
        forest.inventory(axis_algo="lowhigh", method="mean", symmetric=True)
    finally:
        for name, fn in wrappers.items():
            setattr(kernels, name, fn)
    del forest
    torch.cuda.synchronize()

    n = 15_000_000
    one_run = torch.zeros(n, dtype=torch.int32, device="cuda")
    distinct = torch.arange(n, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, call, plain in (
            ("segmented_cummax", cummax_call, kernels.segmented_cummax_plain),
            ("segmented_cumsum", cumsum_call, kernels.segmented_cumsum_plain)):
        width = max(v.shape[1] for _, v in calls[name] if v.dim() == 2)
        wide = torch.randn((n, width), device="cuda", generator=gen)
        cases = [(f"{name} {list(v.shape)}, recorded", k, v)
                 for k, v in calls[name]]
        cases += [(f"{name} {list(wide.shape)}, one run", one_run, wide),
                  (f"{name} {list(wide.shape)}, all keys distinct", distinct,
                   wide)]
        for label, key, val in cases:
            ref = plain(key, val)

            def same(build_name, got, ref=ref):
                if build_name == "shipped" or name == "segmented_cumsum":
                    return torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32))
                # another tree's max may order +0.0 and -0.0 its own way
                return torch.equal(got, ref)

            compare(label, libs, call, (key, val), (ref,), reps, card, same)
            nbytes = 4 * key.numel() + 8 * val.numel()
            print(f"    bound {nbytes / 3.35e12 * 1e3:.4f} ms (bytes at "
                  "3.35 TB/s)")
            launch_times("    shipped", lambda: call(libs["shipped"], key, val))
            del ref
        del wide


def compare_flood(libs, pts, pipeline, kernels, reps, card) -> None:
    """The flood-fill step's jump_flood call, and 64 bands with a seed in
    every band at G = 384 and 512."""
    from treee_tpu_torch import config as tconfig

    calls, wrapper = [], kernels.jump_flood

    def record(slot, pos, cc):
        calls.append((slot.clone(), pos.clone(), cc.clone()))
        return wrapper(slot, pos, cc)

    cfg = tconfig.Config(segmentation=tconfig.SegmentationConfig(
        use_bruteforce_voronoi=False, use_packed_jfa=False))
    kernels.jump_flood = record
    try:
        pipeline.Session.from_points(pts, cfg, device="cuda").segment(0.75)
    finally:
        kernels.jump_flood = wrapper
    torch.cuda.synchronize()
    cases = [("flood-fill step, recorded", *a) for a in calls]
    rng = np.random.default_rng(0)
    for g in (384, 512):
        slot = np.full((64, g, g), -1, np.int32)
        pos = np.zeros((64, g, g, 2), np.float32)
        for bi in range(64):
            cells = rng.choice(g * g, 100, replace=False)
            i, j = np.divmod(cells, g)
            slot[bi, i, j] = np.arange(100)
            pos[bi, i, j] = (np.stack([i, j], -1) + rng.random((100, 2))) * 0.75
        centre = (np.arange(g, dtype=np.float32) + 0.5) * np.float32(0.75)
        cc = np.stack(np.meshgrid(centre, centre, indexing="ij"), -1)
        cases.append((f"64 bands of G={g}, 100 seeds in each",
                      *(torch.from_numpy(a).cuda() for a in
                        (slot, pos, cc.astype(np.float32)))))
    for label, slot, pos, cc in cases:
        b, g, _ = slot.shape
        seeded = int((slot >= 0).flatten(1).any(1).sum())
        print(f"jump_flood {label}: i32/f32[{b},{g},{g}], {seeded} of {b} "
              f"bands with a seed; route {kernels.jump_flood_route(g)}, "
              f"{kernels.jump_flood_clusters(g)} clusters resident",
              flush=True)
        compare(f"jump_flood {label}", libs, flood_call, (slot, pos, cc),
                (kernels.jump_flood_plain(slot, pos, cc),), reps, card)
        for name, lib in libs.items():
            launch_times(f"    {name}", lambda: flood_call(lib, slot, pos, cc))


def compare_voronoi(libs, pts, pipeline, kernels, reps, card) -> None:
    """The step's nearest_slot call on the 15M scan, and a worst case: all
    524,288 rows valid over 64 bands of G = 384, all 2048 slots active.
    Each build's C entry alone (bit-equal to the plain version, in turns),
    the wrapper and the plain version in turns, each build's device time a
    call with calls queued back to back, the bound and each launch's device
    time."""
    calls, wrapper = [], kernels.nearest_slot

    def record(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x
                           for x in a))
        return wrapper(*a)

    kernels.nearest_slot = record
    try:
        pipeline.Session.from_points(pts, device="cuda").segment(0.75)
    finally:
        kernels.nearest_slot = wrapper
    torch.cuda.synchronize()
    cases = [("main path, recorded", *calls[0])]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_bands, g, t_cap, rows = 64, 384, 2048, 1 << 19
    occ = torch.randperm(n_bands * g * g, device="cuda", generator=gen)[:rows]
    lo = torch.tensor([-144.0, 0.0, -144.0], device="cuda")
    s = torch.tensor(0.75, device="cuda")
    pos = (torch.rand((n_bands, t_cap, 2), device="cuda", generator=gen)
           * (g * 0.75) - 144.0)
    cases.append(("all rows valid, all slots active",
                  occ.sort().values.to(torch.int32),
                  torch.ones(rows, dtype=torch.bool, device="cuda"), pos,
                  torch.ones((n_bands, t_cap), dtype=torch.bool,
                             device="cuda"), lo, s, n_bands, g, 256))
    for label, *a in cases:
        occ_idx, occ_valid, pos, act, lo, s, n_bands, g, chunk = a
        band = (occ_idx[occ_valid] // (g * g)).long()
        pairs = int(act.sum(1)[band].sum())
        nbytes = 5 * occ_idx.numel() + 9 * act.numel() + 4 * n_bands * g * g
        bound = max(nbytes / 3.35e12, 5 * pairs / 67e12) * 1e3
        print(f"nearest_slot {label}: {int(occ_valid.sum())} valid rows of "
              f"{occ_idx.numel()}, {n_bands} bands of {g}x{g}, "
              f"{act.shape[1]} slots ({int(act.sum())} active), {pairs} "
              f"row-slot pairs; bound {bound:.4f} ms ({nbytes} bytes, "
              f"{5 * pairs} operations)", flush=True)
        entry = tuple(a[:8])
        ref = kernels.nearest_slot_plain(*a)
        compare(f"nearest_slot {label}, the C entry alone", libs,
                voronoi_call, entry, (ref,), reps, card)
        print_in_turns({"wrapper": lambda: kernels.nearest_slot(*a),
                        "plain": lambda: kernels.nearest_slot_plain(*a)},
                       reps)
        for name, lib in libs.items():
            voronoi_call(lib, *entry)
            torch.cuda.synchronize()
            n = 20
            ms = event_ms(lambda: [voronoi_call(lib, *entry)
                                   for _ in range(n)]) / n
            print(f"    {name}: device {ms:.4f} ms a call ({n} calls queued "
                  "back to back between CUDA events)", flush=True)
        launch_times("    shipped", lambda: voronoi_call(libs["shipped"],
                                                         *entry))
        del ref


def knn_call(lib, pos, valid, k):
    """One k-NN selection through a build's entry, its outputs made once a
    shape (outside the timing)."""
    n = pos.shape[0]
    key = (id(lib), "knn", n, k)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty((n, k), dtype=torch.int32, device=pos.device),
            torch.empty((n, k), dtype=torch.float32, device=pos.device))
    idx, dist = _scratch[key]
    build.check(lib.treee_knn_select(
        pos.data_ptr(), valid.data_ptr(), idx.data_ptr(), dist.data_ptr(), n,
        k, build.stream(pos)), "knn_select")
    return idx, dist


def compare_knn(libs, las, kernels, reps, card, k: int = 31) -> None:
    """The focused view's k-NN on one synthetic tree a size, its members
    first and the snug buffer's invalid tail at the origin.  Each build's
    C entry alone (bit-equal to the plain version, in turns), the wrapper
    and the plain version in turns, one ``torch.topk`` over the plain
    version's keys for all rows at once, each build's device time a call
    queued back to back, the bound and each launch's device time."""
    from treee_tpu_torch.ops.kernels.knn_select import _pairwise_sqdist

    for rows, members in ((8192, 8000), (16384, 16000), (40960, 40072)):
        rng = np.random.default_rng(rows)
        tree = las.synthetic_tree(rng, np.array([30.0, 2.0, -40.0]),
                                  trunk_height=6.0, crown_height=12.0,
                                  crown_radius=4.0, n_points=members)
        pos = torch.zeros((rows, 3), dtype=torch.float32, device="cuda")
        pos[:members] = torch.from_numpy(tree).cuda()
        valid = torch.arange(rows, device="cuda") < members
        ops = 8 * rows * rows
        print(f"knn_select {rows} rows ({members} valid), k = {k}: "
              f"{rows * rows} pairs; bound {ops / 67e12 * 1e3:.4f} ms "
              f"({ops} operations)", flush=True)
        ref = kernels.knn_select_plain(pos, valid, k, 1024)
        compare(f"knn_select {rows} rows, the C entry alone", libs, knn_call,
                (pos, valid, k), ref, reps, card)
        print_in_turns(
            {"wrapper": lambda: kernels.knn_select(pos, valid, k, 1024),
             "plain": lambda: kernels.knn_select_plain(pos, valid, k, 1024)},
            reps)
        d = torch.empty((rows, rows), dtype=torch.float32, device="cuda")
        for t0 in range(0, rows, 1024):
            d[t0:t0 + 1024] = _pairwise_sqdist(pos[t0:t0 + 1024], pos)
        d = torch.where(valid[None, :], d, 3.0e38)
        keys = d.view(torch.int32).to(torch.int64)
        del d
        keys <<= 32
        keys |= torch.arange(rows, device="cuda")
        top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        if not torch.equal((top & 0xFFFFFFFF).to(torch.int32), ref[0]):
            raise AssertionError("knn_select: topk over all keys differs")
        lib_ms = statistics.median(event_ms(lambda: torch.topk(
            keys, k, dim=1, largest=False, sorted=True)) for _ in range(reps))
        print(f"    library: one torch.topk over [{rows}, {rows}] int64 keys "
              f"{lib_ms:.4f} ms", flush=True)
        del keys, top
        for name, lib in libs.items():
            knn_call(lib, pos, valid, k)
            torch.cuda.synchronize()
            n = 10
            ms = event_ms(lambda: [knn_call(lib, pos, valid, k)
                                   for _ in range(n)]) / n
            print(f"    {name}: device {ms:.4f} ms a call ({n} calls queued "
                  "back to back between CUDA events)", flush=True)
        launch_times("    shipped", lambda: knn_call(libs["shipped"], pos,
                                                     valid, k))
        del ref
        torch.cuda.empty_cache()


def dtm_holes(g: int, seed: int) -> torch.Tensor:
    """A g x g flood input like a DTM's: ground in 30% of the cells of
    random 8 x 8 patches, the rest holes, one large hole; each seed its
    cell's flat index."""
    rng = np.random.default_rng(seed)
    patch = rng.random((-(-g // 8), -(-g // 8))) < 0.5
    have = np.kron(patch, np.ones((8, 8), bool))[:g, :g]
    have &= rng.random((g, g)) < 0.3
    have[g // 4: g // 2, g // 3: g // 2] = False
    slot = np.where(have, np.arange(g * g).reshape(g, g), -1)
    return torch.from_numpy(slot.astype(np.int32)).cuda()


def compare_grid(libs, pts, pipeline, kernels, reps, card) -> None:
    """The rasters' grid flood at the inputs of rasters(0.5), rasters(0.1)
    and height_above_ground(1.0) of the segmented scan, and at synthetic
    holes on 640² and 4096²: both builds, this tree's wrapper, and device
    times and CUDA launches."""
    from treee_tpu_torch import rasters

    calls, wrapper = [], kernels.jump_flood_grid

    def record(slot, pos, cc, steps):
        if all(tuple(slot.shape) != tuple(c.shape) for c, _ in calls):
            calls.append((slot.clone(), list(steps)))
        return wrapper(slot, pos, cc, steps)

    session = pipeline.Session.from_points(pts, device="cuda")
    session.segment(0.75)
    kernels.jump_flood_grid = record
    try:
        session.rasters(0.5)
        session.rasters(0.1)
        session.height_above_ground(1.0)
    finally:
        kernels.jump_flood_grid = wrapper
    del session
    torch.cuda.synchronize()
    cases = [(f"recorded {c.shape[0]}x{c.shape[1]}", c, steps)
             for c, steps in calls]
    for g in (640, 4096):
        cases.append((f"synthetic DTM holes {g}x{g}", dtm_holes(g, g),
                      rasters.jfa_steps(g, g)))
    for label, slot, steps in cases:
        h, w = slot.shape
        print(f"jump_flood_grid {label}: {int((slot >= 0).sum())} seeds, "
              f"{len(steps)} steps; "
              f"{kernels.jump_flood_grid_launches(h, w, steps)} CUDA "
              "launches a call", flush=True)
        ref = (kernels.jump_flood_grid_plain(slot, None, None, steps),)
        compare(f"jump_flood_grid {label}", libs, grid_call, (slot, steps),
                ref, reps, card)
        got = kernels.jump_flood_grid(slot, None, None, steps)
        torch.cuda.synchronize()
        if not torch.equal(got, ref[0]):
            raise AssertionError(f"jump_flood_grid {label}: the wrapper "
                                 "differs from the plain version")
        wrap = [event_ms(lambda: kernels.jump_flood_grid(slot, None, None,
                                                         steps))
                for _ in range(2 * reps)]
        print(f"    this tree's wrapper: median "
              f"{statistics.median(wrap):.4f} ms   [{card}]", flush=True)
        for name, lib in libs.items():
            launch_times(f"    {name}", lambda: grid_call(lib, slot, steps))


def host_us(fn, n: int = 1000) -> float:
    """Mean host-clock microseconds of ``n`` calls of ``fn`` (no
    synchronize: the host's own work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return t


def compare_gather(libs, kernels, reps, card) -> None:
    """The gather at the probe's four shapes and three larger tables: both
    builds' C entry points, then the wrapper against the library call in
    turns, the wrapper's host work part by part, and device times."""
    from treee_tpu_torch.ops.kernels import take_along as ta
    from treee_tpu_torch.tools import probe_extract

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(name, torch.from_numpy(t).to(dev), torch.from_numpy(i).to(dev),
              ax) for name, t, i, ax in probe_extract.gather_cases(
                  probe_extract.probe_inputs())]
    for shape, hi, axis, ishape in (((100_000,), 100_000, None, (1000, 37)),
                                    ((3, 5000), 5000, 1, (3, 700)),
                                    ((2000, 50), 2000, 0, (300, 50))):
        cases.append((f"table {list(shape)} by {list(ishape)}, axis {axis}",
                      torch.rand(shape, device=dev, generator=gen),
                      torch.randint(0, hi, ishape, device=dev, generator=gen,
                                    dtype=torch.int32), axis))
    for label, tab, idx, axis in cases:
        ref = ta.take_along_axis_plain(tab, idx, axis)
        compare(f"take_along_axis {label}", libs, gather_call,
                (tab, idx, axis), (ref,), reps, card)
        lidx = idx.long()
        library = ((lambda: tab[lidx]) if axis is None else
                   (lambda: torch.take_along_dim(tab, lidx, dim=axis)))
        wrapper = lambda: kernels.take_along_axis(tab, idx, axis)  # noqa: E731
        if not torch.equal(wrapper(), ref):
            raise AssertionError(f"take_along_axis {label}: the wrapper "
                                 "differs from the plain version")
        times = {"wrapper": [], "library": []}
        for _ in range(reps):
            for name, fn in (("wrapper", wrapper), ("library", library),
                             ("library", library), ("wrapper", wrapper)):
                times[name].append(event_ms(fn))
        print(f"    wrapper {statistics.median(times['wrapper']):.4f} ms, "
              f"library {statistics.median(times['library']):.4f} ms "
              f"(CUDA events around one call, median of {2 * reps}, in "
              "turns)", flush=True)
        for name, lib in libs.items():
            launch_times(f"    {name}",
                         lambda: gather_call(lib, tab, idx, axis))
        launch_times("    library", library)

    # the wrapper's host work, part by part, at the probe's first shape
    _, tab, idx, axis = cases[0]
    lib = build.library()
    packed, pack = lib.treee_take_along.packed
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    rows, cols = tab.shape
    m = idx.shape[axis]
    raw = torch._C._cuda_getCurrentRawStream
    parts = {
        "_check": lambda: ta._check(tab, idx, axis),
        "on_cuda": lambda: build.on_cuda(tab, "take_along_axis"),
        "two .contiguous()": lambda: (tab.contiguous(), idx.contiguous()),
        "torch.empty(shape, dtype, device)": lambda: torch.empty(
            idx.shape, dtype=torch.float32, device=tab.device),
        "idx.new_empty(shape, dtype)": lambda: idx.new_empty(
            idx.shape, dtype=torch.float32),
        "torch.empty_like(idx, dtype)": lambda: torch.empty_like(
            idx, dtype=torch.float32),
        "torch.cuda.device(t.device) context": _device_context(tab),
        "Stream object: current_stream(dev).cuda_stream": lambda: (
            torch.cuda.current_stream(tab.device).cuda_stream),
        "raw stream: _cuda_getCurrentRawStream": lambda: raw(
            tab.get_device()),
        "current_device() == get_device()": lambda: (
            torch.cuda.current_device() == tab.get_device()),
        "_cuda_getDevice() == get_device()": lambda: (
            torch._C._cuda_getDevice() == tab.get_device()),
        "ctypes call, each argument converted (the launch)": lambda: (
            lib.treee_take_along(tab.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), rows, cols, m, axis,
                                 raw(tab.get_device()))),
        "ctypes call, the arguments packed (the launch)": lambda: (
            packed(pack(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                        cols, m, axis, raw(tab.get_device())))),
        "build.launch (helper, with the launch)": lambda: build.launch(
            lib.treee_take_along, "take_along_axis", tab, tab.data_ptr(),
            idx.data_ptr(), out.data_ptr(), rows, cols, m, axis),
        "build.check(0)": lambda: build.check(0, "take_along_axis"),
        "whole wrapper": lambda: kernels.take_along_axis(tab, idx, axis),
        "library: torch.take_along_dim": lambda: torch.take_along_dim(
            tab, idx.long(), dim=axis),
    }
    lidx = idx.long()
    parts["library, i64 indices made beforehand"] = (
        lambda: torch.take_along_dim(tab, lidx, dim=axis))
    _, tab1, idx1, _ = cases[3]                 # the probe's 1-D gather
    lidx1 = idx1.long()
    parts["whole wrapper, 1-D [128] by [8, 128]"] = (
        lambda: kernels.take_along_axis(tab1, idx1, None))
    parts["library, 1-D: tab[i64 indices made beforehand]"] = (
        lambda: tab1[lidx1])
    print(f"host work a call at {list(tab.shape)} axis {axis}, mean of 1000 "
          f"calls   [{card}]", flush=True)
    for name, fn in parts.items():
        print(f"    {name}: {host_us(fn):.2f} us", flush=True)


def dilate_call(lib, kimg, radius, p22, p23, coef, bufs):
    """One build's dilation C entry point, scratch made beforehand."""
    from treee_tpu_torch.ops.kernels.dilate import ZSCALE
    out, tmp, off = bufs
    h, w = kimg.shape
    stats = (0,) if lib.tile_dilate else ()
    build.check(lib.treee_dilate(
        kimg.data_ptr(), out.data_ptr(), tmp.data_ptr(), off[0].data_ptr(),
        off[1].data_ptr(), h, w, radius, p22, p23, coef, ZSCALE, *stats,
        build.stream(kimg)), "dilate")
    return out


def parent_dilate_wrapper(lib, kimg, radius, p22, p23, coef):
    """The dilation wrapper as the first design had it: output, key scratch
    and two offset planes allocated every call, then a packed launch."""
    from treee_tpu_torch.ops.kernels.dilate import ZSCALE
    kimg = kimg.contiguous()
    h, w = kimg.shape
    out, tmp = torch.empty_like(kimg), torch.empty_like(kimg)
    off = torch.empty((2, h, w), dtype=torch.int32, device=kimg.device)
    stats = (0,) if lib.tile_dilate else ()
    err = lib.held.treee_dilate_packed(build.packer(lib.treee_dilate.argtypes)(
        kimg.data_ptr(), out.data_ptr(), tmp.data_ptr(), off[0].data_ptr(),
        off[1].data_ptr(), h, w, radius, p22, p23, coef, ZSCALE, *stats,
        build.stream(kimg)))
    build.check(err, "dilate")
    return out


def eye_dome_call(lib, color, z01, consts, out):
    """One build's eye-dome C entry point, output made beforehand."""
    h, w = z01.shape
    build.check(lib.treee_eye_dome(color.data_ptr(), z01.data_ptr(),
                                   out.data_ptr(), h, w, *consts,
                                   build.stream(z01)), "eye_dome")
    return out


def parent_eye_dome_wrapper(lib, color, z01, near, far, strength, ed):
    """The eye-dome wrapper as the first design had it: the seven f32
    constants converted every call, then a packed launch."""
    from treee_tpu_torch.ops.kernels.eye_dome import _constants
    color, z01 = color.contiguous(), z01.contiguous()
    h, w = z01.shape
    out = torch.empty_like(color)
    consts = _constants(near, far, strength)
    e = tuple(float(np.float32(c)) for c in ed)
    err = lib.held.treee_eye_dome_packed(
        build.packer(lib.treee_eye_dome.argtypes)(
            color.data_ptr(), z01.data_ptr(), out.data_ptr(), h, w, *consts,
            *e, build.stream(z01)))
    build.check(err, "eye_dome")
    return out


def print_in_turns(fns: dict, reps: int) -> None:
    """Median CUDA-event ms of each of ``fns`` through the wrappers, one
    call at a time, the order reversed every other round."""
    times = {name: [] for name in fns}
    order = list(fns)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            times[name].append(event_ms(fns[name]))
    print(f"    through the wrappers (CUDA events, median of {reps}): "
          + ", ".join(f"{n} {statistics.median(t):.4f} ms"
                      for n, t in times.items()), flush=True)


def print_device_ms(libs, call, args, reps, device_ms) -> None:
    """Each build's device time a call (``torch.profiler``)."""
    for name, lib in libs.items():
        ms = device_ms(lambda: call(lib, *args), reps)
        print(f"    {name}: device {ms:.4f} ms a call (torch.profiler)",
              flush=True)


def compare_frame(libs, eye_libs, pts, pipeline, kernels, reps,
                  card) -> None:
    """The frame's dilation and eye-dome at the inputs of bench.py's 8
    orbit frames of the segmented 15M scan, and the dilation at a dense
    720p key image at r=3 and r=8: each build's C entry point (``libs``
    for the dilation, ``eye_libs`` for the eye-dome) in turns, its
    device time a call, the wrappers (this tree's and the first design's)
    in turns, the dilation's skipped tiles, the eye-dome wrapper's host
    work by part."""
    from chip_smoke import dense_keys, device_ms, orbit_cameras
    from treee_tpu_torch.ops.kernels.dilate import tile_stats
    from treee_tpu_torch.ops.kernels.eye_dome import (_check, _constants,
                                                      _launch_constants)
    from treee_tpu_torch.render import Camera

    session = pipeline.Session.from_points(pts, device="cuda")
    session.segment(0.75)
    d_calls, e_calls = [], []
    d_wrap, e_wrap = kernels.dilate, kernels.eye_dome

    def d_rec(*a):
        d_calls.append(tuple(x.clone() if torch.is_tensor(x) else x
                             for x in a))
        return d_wrap(*a)

    def e_rec(*a):
        e_calls.append(tuple(x.clone() if torch.is_tensor(x) else x
                             for x in a))
        return e_wrap(*a)

    kernels.dilate, kernels.eye_dome = d_rec, e_rec
    try:
        for cam in orbit_cameras(Camera, "cuda"):
            session.render(cam)
    finally:
        kernels.dilate, kernels.eye_dome = d_wrap, e_wrap
    del session
    torch.cuda.synchronize()

    kimg0, _, *params = d_calls[0]
    dense = dense_keys(*kimg0.shape, 0, "cuda")
    cases = [(f"frame {i}", a) for i, a in enumerate(d_calls)]
    cases += [(f"dense {list(kimg0.shape)}, r={r}", (dense, r, *params))
              for r in (3, 8)]
    for label, (kimg, radius, p22, p23, coef) in cases:
        st = tile_stats(kimg, radius, p22, p23, coef)
        print(f"dilate {label} (i32{list(kimg.shape)}, r={radius}): "
              f"{st['tiles']} tiles, {st['empty']} empty, {st['stopped']} "
              f"stopped after a still pass, {st['passes']} passes",
              flush=True)
        ref = kernels.dilate_plain(kimg, radius, p22, p23, coef)
        h, w = kimg.shape
        bufs = (torch.empty_like(kimg), torch.empty_like(kimg),
                torch.empty((2, h, w), dtype=torch.int32, device="cuda"))
        args = (kimg, radius, p22, p23, coef, bufs)
        compare(f"dilate {label}, C entry alone", libs, dilate_call, args,
                (ref,), reps, card)
        print_device_ms(libs, dilate_call, args, reps, device_ms)
        parent = libs["parent"]
        fns = {"wrapper": lambda: kernels.dilate(kimg, radius, p22, p23,
                                                 coef),
               "parent's wrapper": lambda: parent_dilate_wrapper(
                   parent, kimg, radius, p22, p23, coef)}
        for name, fn in fns.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"dilate {label}: {name} differs")
        print_in_turns(fns, 2 * reps)

    for i, (color, z01, near, far, strength, ed) in enumerate(e_calls):
        label = f"eye_dome frame {i}"
        ref = kernels.eye_dome_plain(color, z01, near, far, strength, ed)
        consts = _launch_constants(near, far, strength, tuple(ed))
        args = (color, z01, consts, torch.empty_like(color))
        compare(f"{label}, C entry alone", eye_libs, eye_dome_call, args,
                (ref,), reps, card)
        print_device_ms(eye_libs, eye_dome_call, args, reps, device_ms)
        fns = {"wrapper": lambda: kernels.eye_dome(color, z01, near, far,
                                                   strength, ed),
               "parent's wrapper": lambda: parent_eye_dome_wrapper(
                   libs["parent"], color, z01, near, far, strength, ed)}
        for name, fn in fns.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"{label}: {name} differs")
        print_in_turns(fns, 2 * reps)

    # the eye-dome wrapper's host work, part by part, at frame 0
    color, z01, near, far, strength, ed = e_calls[0]
    lib = build.library()
    packed, pack = lib.treee_eye_dome.packed
    consts = _launch_constants(near, far, strength, tuple(ed))
    out = torch.empty_like(color)
    h, w = z01.shape
    parts = {
        "_check": lambda: _check(color, z01),
        "two build.aligned": lambda: (build.aligned(color),
                                      build.aligned(z01)),
        "empty_like": lambda: torch.empty_like(color),
        "the seven constants, converted (first design)": lambda: (
            _constants(near, far, strength),
            tuple(float(np.float32(c)) for c in ed)),
        "the seven constants, cached": lambda: _launch_constants(
            near, far, strength, tuple(ed)),
        "the packed launch": lambda: packed(pack(
            color.data_ptr(), z01.data_ptr(), out.data_ptr(), h, w, *consts,
            build.stream(z01))),
        "whole wrapper": lambda: kernels.eye_dome(color, z01, near, far,
                                                  strength, ed),
        "the first design's wrapper": lambda: parent_eye_dome_wrapper(
            libs["parent"], color, z01, near, far, strength, ed),
    }
    print(f"eye_dome host work a call at {list(color.shape)}, mean of 1000 "
          f"calls   [{card}]", flush=True)
    for name, fn in parts.items():
        print(f"    {name}: {host_us(fn):.2f} us", flush=True)


def _device_context(t):
    def enter():
        with torch.cuda.device(t.device):
            pass
    return enter


if __name__ == "__main__":
    sys.exit(main())
