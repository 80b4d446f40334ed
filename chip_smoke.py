#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``treee_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; it exits non-zero without them.
Phases, each of which raises on failure:

0. The device: the card's name and power limit, the toolchain, and the build
   of the port's CUDA kernels from ``treee_tpu_torch/ops/kernels/csrc``
   (into ``build/treee_tpu_torch/``).
1-5. Each kernel on the card at the shapes its path gives it (its inputs
   are recorded from one run of the main path and one ``Session.render`` on
   the 15M-point scan), held bit for bit against its plain PyTorch version
   on the same inputs, with both times from CUDA events.
6. The main path as a user drives it: ``Session.from_points(...).segment()``
   and ``.table``, then ``octree.build_keys``, on the 15M-point synthetic
   forest that ``bench.py`` times (937 trees of 12,000 points, 7 m apart,
   seed 0).  The kernels' launch counters are zeroed just before and read
   just after; every kernel of the path must have run.  The same path with
   the plain versions swapped in, and every repeated kernel run, must give
   every point the same segment id.
7. The frame: ``Session.render`` of the segmented 15M scan at 1280x720 for
   8 orbit cameras (``bench.py``'s frame sweep), with the counters zeroed
   before and read after each frame; both frame kernels must run in every
   frame, and the same frames with the plain versions swapped in must be
   byte-equal.  Then a small scene's ids and frame on the card against the
   port's CPU run.

The last two lines are a JSON object of per-kernel results and the JSON
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

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
MAIN_PATH_REPS = 3
N_FRAMES = 8
ORBIT_DISTANCE = 120.0
ORBIT_STEP = 40.0

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
)
MAIN_PATH_KERNELS = ("cc_sweep", "match_scan", "segmented_cummax")
FRAME_KERNELS = ("dilate", "eye_dome")


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


def recorder(fn, calls: list):
    """``fn`` that also keeps the arguments of its first call at each
    distinct set of input shapes."""
    def record(*args):
        sig = tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
        if all(s != sig for s, _ in calls):
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


def max_abs_err(got, ref) -> float:
    """Largest |got - ref| over all outputs; equal entries count 0 (so
    matching -3e38 fills give 0, not inf - inf)."""
    err = 0.0
    for a, b in zip(as_tuple(got), as_tuple(ref)):
        a, b = a.double(), b.double()
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_kernel(name: str, wrapper, plain, calls: list) -> dict:
    """The kernel against its plain version on every recorded input: bit
    equality, and both median times (kernel and plain in turns)."""
    shapes, ms, plain_ms, err = [], 0.0, 0.0, 0.0
    for sig, args in calls:
        got = as_tuple(wrapper(*args))
        ref = as_tuple(plain(*args))
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.dtype != r.dtype or g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(
                    f"{name} at {sig}: kernel output differs from the plain "
                    f"version (max abs err {max_abs_err(got, ref)})")
        err = max(err, max_abs_err(got, ref))
        k_t, p_t = [], []
        for _ in range(TIMING_REPS):
            k_t += cuda_ms(lambda: wrapper(*args), 1)
            p_t += cuda_ms(lambda: plain(*args), 1)
        k_ms, p_ms = statistics.median(k_t), statistics.median(p_t)
        log(f"  {name} {list(map(list, sig))}: bit-equal; kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (median of {TIMING_REPS})")
        shapes.append([list(s) for s in sig])
        ms += k_ms
        plain_ms += p_ms
    return {"shapes": shapes, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err}


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


def frame_stages(session, cam, splat) -> dict:
    """Host-clock ms of each stage of one frame, each ended by a
    synchronize (median of TIMING_REPS)."""
    cloud, cfg = session.cloud, session.config.render
    stages = {}

    def timed(name, fn):
        times = []
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stages[name] = statistics.median(times)
        return out

    prop = timed("prop_from_segment + mask", lambda: (
        splat.prop_from_segment(cloud.segment),
        cloud.valid & (cloud.segment != 0)))
    timed("_project alone", lambda: splat._project(cloud.pos, cam, cfg.width,
                                                    cfg.height))
    kimg = timed("rasterize_keys (project + pack + scatter-min)",
                 lambda: splat.rasterize_keys(cloud.pos, prop[0], prop[1],
                                              cam, cfg))
    color, z01, _ = timed("resolve_keys (dilate + palette)",
                          lambda: splat.resolve_keys(kimg, cam,
                                                     session.palette, cfg))
    img = timed("eye_dome", lambda: splat.eye_dome(color, z01, cfg))
    timed("to_u8 + copy to host", lambda: splat.to_u8(img).cpu().numpy())
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from treee_tpu_torch import config as tconfig
    from treee_tpu_torch import pipeline
    from treee_tpu_torch.io import las
    from treee_tpu_torch.ops import kernels, octree
    from treee_tpu_torch.ops.kernels import build
    from treee_tpu_torch.render import Camera, splat

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

    # --- phases 1-5: each kernel against its plain version ---
    calls = {k: [] for k, _, _ in KERNELS}
    with swapped(kernels, **{k: recorder(getattr(kernels, k), calls[k])
                             for k, _, _ in KERNELS}):
        session, _, _ = run_main_path(pts, pipeline, octree, dev)
        session.render(Camera.orbital(distance=ORBIT_DISTANCE, device=dev))
    del session
    results = {}
    for i, (k, _, _) in enumerate(KERNELS, start=1):
        log(f"phase {i}: {k}")
        if not calls[k]:
            raise AssertionError(f"the main path never called {k}")
        results[k] = check_kernel(k, getattr(kernels, k),
                                  getattr(kernels, k + "_plain"), calls[k])
    del calls

    # --- phase 6: the main path ---
    log("phase 6: main path, Session.from_points(...).segment(0.75) + "
        "build_keys")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
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
    del seg_kernel

    # --- phase 7: the frame ---
    log(f"phase 7: frame, Session.render of the segmented scan at "
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
    del session, frames, plain_frames

    # --- a small scene: the card's run against the port's CPU run ---
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
    cam = Camera.orbital(distance=60.0).rotate_orbital(ORBIT_STEP, -60.0)
    f_cpu = s_cpu.render(cam)
    f_gpu = s_gpu.render(cam.to(dev))
    diff = abs(f_cpu.astype(int) - f_gpu.astype(int))
    log(f"  small frame: card vs CPU max difference {int(diff.max())} per "
        f"channel, {float((diff.max(-1) > 0).mean()):.6f} of pixels differ")
    if diff.max() > 1:
        raise AssertionError("the card's frame differs from the CPU's by "
                             "more than 1 per channel")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "shapes": results[k]["shapes"]}
        for k, src, tpu in KERNELS]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
