"""Command-line application shell of the port (``treee_tpu/app.py``, over
the port's ``Session``).

The reference is a windowed egui app whose phases are driven by buttons and
sliders (treee/src/program.rs); every tunable is a widget (SURVEY.md §5 config
row).  The port is headless, so the app shell is a CLI that drives the same
phase machine — load -> segment -> characteristics -> interact/export — with
the widget knobs as flags (the JAX package's, with the same defaults),
orbit-sweep frame rendering in place of the live viewport, and the session
checkpoint for save/resume.

Every session and camera of a run lives on the CUDA card; ``--cpu`` puts
them on the CPU instead (the plain PyTorch versions of the kernels).  Without
``--cpu`` on a machine with no card, the run raises rather than falling back.
Frames are written as PNG by ``io.exports.png_encode`` (no imaging package).

Examples:
  python -m treee_tpu_torch scan.las --distance 0.75 --save session.npz
  python -m treee_tpu_torch session.npz --frames 8 --out-dir frames/
  python -m treee_tpu_torch scan.las --export-info info.json --export-ply seg.ply
  python -m treee_tpu_torch --demo
  python -m treee_tpu_torch --demo --cpu --frames 1
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="treee_tpu_torch",
        description="forest point-cloud pipeline on a CUDA card (PyTorch)"
    )
    p.add_argument("input", nargs="?",
                   help=".las/.laz scan, .npz checkpoint, or a reference-app "
                        ".ipc session")
    p.add_argument("--demo", action="store_true", help="run on a synthetic forest")
    p.add_argument("--max-points", type=int, default=None,
                   help="cap loaded points (webdemo caps at 15M, laz.rs:49-62)")
    p.add_argument("--mesh", choices=["auto"], default=None,
                   help="run the session point-sharded over ALL attached "
                        "devices (Session mesh mode; single device = no-op)")
    p.add_argument("--add", action="append", default=[], metavar="SCAN",
                   help="merge another .las/.laz into the scene "
                        "(Loading::add, loading.rs:79-88)")
    p.add_argument("--add-session", action="append", default=[],
                   metavar="NPZ_OR_IPC",
                   help="additively merge another session checkpoint — ours "
                        "(.npz) or the reference app's (.ipc) (mod.rs:300-338)")
    # segmentation knobs (slider 0.1-2.0, default 0.75, segmenting.rs:16,82)
    p.add_argument("--distance", type=float, default=0.75,
                   help="min distance between segments [m]")
    p.add_argument("--no-segment", action="store_true",
                   help="skip segmentation (e.g. when resuming a session)")
    # display knobs (program.rs:107-131)
    p.add_argument("--point-size", type=float, default=0.1)
    p.add_argument("--palette", choices=("turbo", "warm", "white"), default="turbo")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye-dome-strength", type=float, default=0.7,
                   help="eye-dome lighting strength 0-1 (program.rs:160)")
    p.add_argument("--prop-min", type=int, default=0,
                   help="property range filter lower bound (u32 scale, "
                        "point_cloud.wgsl:44-49)")
    p.add_argument("--prop-max", type=int, default=0xFFFFFFFF)
    p.add_argument("--brush-radius", type=float, default=0.5,
                   help="sphere brush radius for edits (mod.rs:259)")
    p.add_argument("--proj", default=None,
                   help="proj4 string for geo-referencing (mod.rs:53)")
    p.add_argument("--frames", type=int, default=0,
                   help="render an orbit sweep of this many frames")
    p.add_argument("--orbit-distance", type=float, default=100.0)
    p.add_argument("--lod", default=None, metavar="LEVEL",
                   help="render sweeps from the octree LOD subset at this "
                        "level (0-10, or 'adaptive' for finest-level voxel "
                        "dedup — near-pixel-exact full-scene frames)")
    p.add_argument("--out-dir", default="frames")
    p.add_argument("--display", default="segment",
                   choices=("segment", "intensity", "rgb",
                            "file_classification", "return_number",
                            "gps_time", "nir", "hag"),
                   help="frame-sweep coloring: segment ids (default), a "
                        "source point-record attribute the scan carries "
                        "(io/las.decode_attributes — fields the reference "
                        "loader discards), or height above the DTM (hag)")
    # exports / persistence
    p.add_argument("--save", help="write a session checkpoint (.npz, or "
                   ".ipc readable by the reference app)")
    p.add_argument("--export-info", help="write per-segment info JSON")
    p.add_argument("--export-ply",
                   help="write points .ply with expansion/height/curvature; "
                        "with --segment-id exports only that segment "
                        "(mod.rs:1069-1107)")
    p.add_argument("--export-crown-ply",
                   help="crown-only point export of --segment-id "
                        "(the Crown button, mod.rs:629-660)")
    p.add_argument("--export-trunk-ply",
                   help="trunk-only point export of --segment-id")
    p.add_argument("--export-ground-ply",
                   help="ground-only point export of --segment-id")
    p.add_argument("--export-traits", help="write per-segment forestry traits JSON")
    p.add_argument("--export-inventory",
                   help="write the whole-forest per-tree inventory table "
                        "(.csv, or .json by extension): counts, position, "
                        "heights, and all trait fields for every segment in "
                        "one batched device pass (Session.inventory)")
    p.add_argument("--export-summary",
                   help="write forest-level stand aggregates JSON: stems/ha, "
                        "basal area/ha, canopy cover, quadratic mean "
                        "diameter, volume totals (Session.forest_summary)")
    p.add_argument("--compare", metavar="NPZ",
                   help="earlier-epoch session checkpoint to diff the "
                        "current scan against: mutual-NN stem matching, "
                        "per-tree growth deltas, stand-level change "
                        "(change.py; no reference analogue)")
    p.add_argument("--match-dist", type=float, default=2.0,
                   help="max stem-position distance (m) for cross-epoch "
                        "tree matching (--compare)")
    p.add_argument("--export-changes",
                   help="with --compare: write the per-tree change table "
                        "(.csv = matched growth rows; .json adds "
                        "lost/new trees and the stand-level deltas)")
    p.add_argument("--export-chm-change",
                   help="with --compare: write the canopy-height change "
                        "raster (epoch-b CHM minus epoch-a, shared map "
                        "grid) as an ESRI ASCII .asc")
    p.add_argument("--export-las",
                   help="write the live cloud as classified LAS 1.4 "
                        "(.laz compresses): ASPRS ground/vegetation codes, "
                        "tree id in point_source_id, source-CRS header")
    p.add_argument("--export-dtm", help="write a ground-height ESRI ASCII "
                        "grid (.asc) — digital terrain model (rasters.py)")
    p.add_argument("--export-dsm", help="write a surface-height .asc — "
                        "digital surface model")
    p.add_argument("--export-chm", help="write a canopy-height .asc — "
                        "DSM minus hole-filled DTM")
    p.add_argument("--raster-cell", type=float, default=0.5,
                   help="raster cell size in meters (grown to fit the "
                        "4096-cell grid cap on huge scenes)")
    p.add_argument("--export-hull-ply",
                   help="write the focus segment's crown convex hull .ply "
                        "(hull.rs:583-624); requires --segment-id")
    p.add_argument("--export-landmarks",
                   help="write the focus segment's RBV landmark .txt rows "
                        "(hull.rs:308-331); requires --segment-id")
    p.add_argument("--export-rbv",
                   help="write the focus segment's RBV distances JSON "
                        "(hull.rs:293-306); requires --segment-id")
    p.add_argument("--segment-id", type=int, default=None,
                   help="focus segment for per-segment exports")
    p.add_argument("--hull-include", default="crown",
                   choices=("all", "crown", "trunk", "ground", "tree", "nocrown"),
                   help="class filter for the convex hull "
                        "(IncludeMode, hull.rs:15-67)")
    p.add_argument("--rbv-slices", type=int, default=None,
                   help="RBV slice count (hull.rs:248-285 widget)")
    p.add_argument("--rbv-sectors", type=int, default=None)
    p.add_argument("--rbv-method", choices=("max", "mean"), default="max")
    p.add_argument("--rbv-symmetric", action="store_true")
    p.add_argument("--trunk-axis-algorithm", choices=("average", "lowhigh"),
                   default="average",
                   help="trunk-axis estimation (trunk_axis.rs:9-14)")
    p.add_argument("--repl", action="store_true",
                   help="interactive command loop (the reference's windowed "
                        "Interactive phase as line commands; 'help' lists them)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="browser viewer: HTTP server rendering on the card "
                        "(the reference's web target, treee-wasm/src/lib.rs:6-17, "
                        "inverted to remote rendering; 0 picks a free port)")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="bind address for --serve (default loopback)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch "
                        "versions) instead of the CUDA card")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _inventory_kwargs(args) -> dict:
    """CLI rbv/axis flags -> Session.inventory keyword arguments (the one
    place the mapping lives; traits/inventory/summary exports all share it)."""
    kw = dict(
        method=args.rbv_method,
        symmetric=args.rbv_symmetric,
        axis_algo=("lowhigh" if args.trunk_axis_algorithm == "lowhigh"
                   else "average"),
    )
    if args.rbv_slices is not None:
        kw.update(crown_slices=args.rbv_slices, trunk_slices=args.rbv_slices)
    if args.rbv_sectors is not None:
        kw.update(crown_sectors=args.rbv_sectors,
                  trunk_sectors=args.rbv_sectors)
    return kw


def _get_inventory(session, args) -> dict:
    """One batched inventory pass per CLI run, shared by --export-traits,
    --export-inventory and --export-summary (same settings, same numbers)."""
    if getattr(session, "_cli_inventory", None) is None:
        session._cli_inventory = session.inventory(**_inventory_kwargs(args))
    return session._cli_inventory


def build_config(args):
    """The run's ``Config``: the defaults (``TREEE_APP_CONFIG=small``: the
    JAX package's shrunken capacities for its small test scenes, so that
    both CLIs run the same settings) with the display and brush flags."""
    import dataclasses

    from .config import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG
    if os.environ.get("TREEE_APP_CONFIG") == "small":
        cfg = cfg.replace(
            segmentation=dataclasses.replace(
                cfg.segmentation, grid_size=128, max_bands=16,
                max_segments=256, max_trees_per_band=32,
            ),
            characteristics=dataclasses.replace(
                cfg.characteristics, max_slices=96,
            ),
        )
    return cfg.replace(
        render=dataclasses.replace(
            cfg.render, width=args.width, height=args.height,
            point_size=args.point_size, palette=args.palette,
            eye_dome_strength=args.eye_dome_strength,
            prop_min=args.prop_min, prop_max=args.prop_max,
        ),
        interactive=dataclasses.replace(
            cfg.interactive, draw_radius=args.brush_radius,
            **({"source_location": args.proj} if args.proj else {}),
        ),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    if not args.verbose:
        return _run(args)
    # -v: the run's spans, and at its end their totals by name
    from .utils import profiling
    profiling.reset()
    with profiling.enable():
        rc = _run(args)
    if rc == 0:
        print("spans:")
        for line in profiling.table():
            print(line)
    return rc


def _run(args) -> int:
    if (args.export_changes or args.export_chm_change) and not args.compare:
        print("error: --export-changes/--export-chm-change require "
              "--compare", file=sys.stderr)
        return 2

    from .device import DEFAULT_DEVICE, resolve
    from .io import exports, las
    from .pipeline import Session
    from .render import Camera
    from .utils.profiling import span

    cfg = build_config(args)

    if not args.demo and args.input is None:
        print("error: provide an input file or --demo", file=sys.stderr)
        return 2
    # every session and camera of the run: the card, or the CPU on --cpu;
    # without a card (and without --cpu) this raises
    device = resolve("cpu" if args.cpu else DEFAULT_DEVICE)
    # --mesh auto: every card when there are several, else one device
    mesh = args.mesh
    if args.demo:
        pts = las.synthetic_forest(n_trees=16, points_per_tree=8000,
                                   ground_points=20000)
        session = Session.from_points(pts, cfg, device=device, mesh=mesh)
    elif args.input.endswith((".npz", ".ipc")):
        # .ipc: the reference app's own bincode session format
        # (io/ipc.read_reference_ipc) — a migrating user opens it directly
        with span("load-session", device):
            session = Session.open(args.input, cfg, device=device,
                                   mesh=mesh)
    else:
        with span("import", device):
            session = Session.from_las(args.input, cfg,
                                       max_points=args.max_points,
                                       device=device, mesh=mesh)

    for extra in args.add:
        with span("add", device):
            session.add_las(extra)
    for extra in args.add_session:
        with span("add-session", device):
            session.add_session(extra)
    if args.proj:
        session.source_location = args.proj

    print(f"points: {int(session.cloud.count):,}")

    should_segment = not args.no_segment and (
        args.demo or (args.input is not None
                      and not args.input.endswith((".npz", ".ipc")))
    )
    if should_segment:
        with span("segment", device):
            res = session.segment(args.distance)
            n_segments = int(res.n_segments)
        print(f"segments: {n_segments}")

    if args.serve is not None:
        from .serve import ViewerServer

        server = ViewerServer(session, host=args.serve_host, port=args.serve)
        print(f"viewer: http://{args.serve_host}:{server.port}/")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        session = server.repl.s

    if args.repl:
        from .repl import Repl

        r = Repl(session)
        r.run(sys.stdin)
        session = r.s  # 'open' inside the REPL rebinds the session

    if args.frames > 0:
        os.makedirs(args.out_dir, exist_ok=True)
        cam = Camera.orbital(distance=args.orbit_distance, device=device)
        use_lod = args.lod is not None
        if use_lod:
            level = 10 if args.lod == "adaptive" else int(args.lod)
            session.build_lod(level=level)
        prop, pal = (None, None)
        if args.display == "hag":
            prop = session.hag_prop()
        elif args.display != "segment":
            prop, pal = session.attribute_prop(args.display)
        for i in range(args.frames):
            cam = cam.rotate_orbital(2 * np.pi / args.frames / 0.002, 0.0)
            with span("frame", device):
                img = session.render(cam, use_lod=use_lod, prop=prop,
                                     palette=pal)
            with open(os.path.join(args.out_dir, f"frame_{i:03d}.png"),
                      "wb") as fh:
                fh.write(exports.png_encode(img))
        print(f"wrote {args.frames} frames to {args.out_dir}/")

    if args.save:
        session.save(args.save)
        print(f"session saved: {args.save}")

    if args.export_info:
        # full_table, not session.table: the post-segment() table has zero
        # x/z bounds placeholders (full_bbox=False fast path)
        table = session.full_table()
        # the table's columns come to the host once, not a value at a time
        host = {f: getattr(table, f).cpu().numpy()
                for f in ("present", "lo", "hi", "count", "trunk_height",
                          "crown_height", "ground_sep", "crown_sep")}
        seg_ids = np.flatnonzero(host["present"])
        out = {}
        for sid in seg_ids:
            # SegmentSave-shaped rows (exports.segment_info_json carries the
            # reference's min/max/offset fields, calculations.rs:62-73)
            entry = json.loads(exports.segment_info_json(
                {f: host[f][sid] for f in ("trunk_height", "crown_height",
                                           "ground_sep", "crown_sep")},
                host["lo"][sid], host["hi"][sid], session.world_offset,
                coords=session.segment_coords(int(sid)),
            ))
            entry["count"] = int(host["count"][sid])
            out[int(sid)] = entry
        with open(args.export_info, "w") as fh:
            json.dump(out, fh, indent=2)
        print(f"segment info: {args.export_info} ({len(out)} segments)")

    if args.export_ply:
        n = session.export_points_ply(args.export_ply,
                                      segment_id=args.segment_id)
        print(f"points ply: {args.export_ply} ({n} points)")

    if args.export_las:
        n = session.export_las(args.export_las, segment_id=args.segment_id)
        print(f"classified las: {args.export_las} ({n} points)")

    for flag, include in (("export_crown_ply", "crown"),
                          ("export_trunk_ply", "trunk"),
                          ("export_ground_ply", "ground")):
        path = getattr(args, flag)
        if not path:
            continue
        if args.segment_id is None:
            print(f"error: --{flag.replace('_', '-')} requires --segment-id",
                  file=sys.stderr)
            return 2
        n = session.export_points_ply(path, segment_id=args.segment_id,
                                      include=include)
        print(f"{include} ply: {path} ({n} points)")

    raster_paths = {w: getattr(args, f"export_{w}") for w in ("dtm", "dsm", "chm")}
    if any(raster_paths.values()):
        from .io import exports as exports_mod

        grids, (xll, yll), cell = session.rasters(args.raster_cell)
        for which, path in raster_paths.items():
            if not path:
                continue
            with open(path, "w") as fh:
                exports_mod.save_ascii_grid(fh, grids[which], xll, yll, cell)
            rows, cols = grids[which].shape
            print(f"{which}: {path} ({rows}x{cols} @ {cell:g} m)")

    if args.export_traits:
        from . import rbv as rbv_mod
        from . import trunk_axis

        if session.table is None:
            session.characteristics()
        table = session.table
        # same volume settings as the sibling RBV/landmark exports: method,
        # symmetry, slice/sector overrides AND the per-segment trunk-axis
        # transform — traits from a different volume than the exported RBV
        # would silently disagree for tilted trees
        rbv_kw = dict(
            method=(rbv_mod.METHOD_MEAN if args.rbv_method == "mean"
                    else rbv_mod.METHOD_MAX),
            symmetric=args.rbv_symmetric,
        )
        if args.rbv_slices is not None:
            rbv_kw.update(crown_slices=args.rbv_slices,
                          trunk_slices=args.rbv_slices)
        if args.rbv_sectors is not None:
            rbv_kw.update(crown_sectors=args.rbv_sectors,
                          trunk_sectors=args.rbv_sectors)
        axis_fn = (trunk_axis.low_high_layer
                   if args.trunk_axis_algorithm == "lowhigh"
                   else trunk_axis.average_direction)
        trait_fields = (
            "diameter_breast_height", "trunk_cross_area", "crown_diameter",
            "crown_projected_area", "crown_volume", "crown_surface",
            "stem_volume", "wood_volume",
        )
        if args.segment_id is None:
            # all segments: one batched pass (Session.inventory) instead of
            # S full-N loops — same JSON shape as the per-segment path
            inv = _get_inventory(session, args)
            out = {
                int(sid): {f: float(inv[f][i]) for f in trait_fields}
                for i, sid in enumerate(inv["segment"])
            }
        else:
            out = {}
            sid = args.segment_id
            pos, cls_, member = session.segment_rows(int(sid))
            if bool(member.any()):
                axis = axis_fn(pos, member & (cls_ == 1))
                crown, trunk = rbv_mod.split_rbv(
                    pos, cls_, member,
                    transform=trunk_axis.axis_transform(axis),
                    **rbv_kw,
                )
                out[int(sid)] = json.loads(
                    rbv_mod.traits(crown, trunk).to_json())
        with open(args.export_traits, "w") as fh:
            json.dump(out, fh, indent=2)
        print(f"traits: {args.export_traits} ({len(out)} segments)")

    if args.export_inventory:
        from .io import exports as exports_mod

        inv = _get_inventory(session, args)
        if args.export_inventory.lower().endswith(".json"):
            rows = {
                int(sid): {c: (inv[c][i].item() if hasattr(inv[c][i], "item")
                               else inv[c][i])
                           for c in inv if c != "segment"}
                for i, sid in enumerate(inv["segment"])
            }
            with open(args.export_inventory, "w") as fh:
                json.dump(rows, fh, indent=2)
            n_rows = len(rows)
        else:
            with open(args.export_inventory, "w") as fh:
                n_rows = exports_mod.save_inventory_csv(fh, inv)
        print(f"inventory: {args.export_inventory} ({n_rows} trees)")

    if args.export_summary:
        # same rbv/axis settings (and the same computed pass) as the sibling
        # inventory/traits exports — a summary from a different volume
        # method than inv.csv's columns would not sum up
        summary = session.forest_summary(
            inventory=_get_inventory(session, args))
        with open(args.export_summary, "w") as fh:
            json.dump(summary, fh, indent=2)
        print(f"summary: {args.export_summary} "
              f"({summary['n_trees']} trees, "
              f"{summary['stems_per_ha']:.1f} stems/ha)")

    if args.compare:
        from . import change as change_mod
        from .io import exports as exports_mod

        with span("compare", device):
            # epoch A = the earlier --compare checkpoint; epoch B = the
            # session built above (current scan, post-REPL edits)
            prev = Session.open(args.compare, cfg, device=device)
            inv_a = prev.inventory(**_inventory_kwargs(args))
            inv_b = _get_inventory(session, args)
            ch = change_mod.tree_changes(inv_a, inv_b, args.match_dist)
            stand = change_mod.stand_changes(
                prev.forest_summary(inventory=inv_a),
                session.forest_summary(inventory=inv_b),
            )
        n_match = len(ch["matched"]["segment_b"])
        dh = ch["matched"]["delta_tree_height"]
        print(f"compare: {n_match} matched trees "
              f"({len(ch['lost']['segment'])} lost, "
              f"{len(ch['new']['segment'])} new); "
              f"mean height change "
              f"{float(dh.mean()) if n_match else 0.0:+.2f} m; "
              f"stem volume {stand['total_stem_volume']['delta']:+.1f} m3")
        if args.export_changes:
            if args.export_changes.lower().endswith(".json"):
                def scalar(v):
                    # strict-JSON safe: degenerate trees (e.g. DBH on a
                    # sparse trunk) can carry NaN/inf traits, which
                    # json.dump would emit as non-strict NaN tokens
                    v = v.item() if hasattr(v, "item") else v
                    if isinstance(v, float) and not math.isfinite(v):
                        return None
                    return v

                def rows(tab):
                    cols = list(tab)
                    return [{c: scalar(tab[c][i]) for c in cols}
                            for i in range(len(tab[cols[0]]) if cols else 0)]
                def clean(v):
                    if isinstance(v, dict):
                        return {k: clean(x) for k, x in v.items()}
                    return scalar(v)

                with open(args.export_changes, "w") as fh:
                    json.dump({"matched": rows(ch["matched"]),
                               "lost": rows(ch["lost"]),
                               "new": rows(ch["new"]),
                               "stand": clean(stand)}, fh, indent=2)
            else:
                with open(args.export_changes, "w") as fh:
                    exports_mod.save_inventory_csv(fh, ch["matched"])
            print(f"changes: {args.export_changes} ({n_match} rows)")
        if args.export_chm_change:
            diff, (xll, yll), out_cell = change_mod.chm_change(
                prev, session, cell=args.raster_cell)
            with open(args.export_chm_change, "w") as fh:
                exports_mod.save_ascii_grid(fh, diff, xll, yll, out_cell)
            print(f"chm-change: {args.export_chm_change} "
                  f"({diff.shape[0]}x{diff.shape[1]} @ {out_cell} m)")

    if args.export_hull_ply or args.export_landmarks or args.export_rbv:
        if args.segment_id is None:
            print("error: --export-hull-ply/--export-landmarks/--export-rbv "
                  "require --segment-id", file=sys.stderr)
            return 2
        from . import hull3d, rbv as rbv_mod, trunk_axis
        from .cloud import include_mask

        if session.table is None:
            session.characteristics()
        pos, cls_, member = session.segment_rows(args.segment_id)

        if args.export_hull_ply:
            # device arrays straight through: the support reduction +
            # candidate gather stay on device (O(candidates) fetched)
            h = hull3d.convex_hull(
                pos, member & include_mask(cls_, args.hull_include),
                device=device,
            )
            if h is None:
                print(f"hull: segment has too few {args.hull_include} points",
                      file=sys.stderr)
            else:
                with open(args.export_hull_ply, "w") as fh:
                    exports.save_hull_ply(fh, h.vertices, h.faces)
                print(f"hull ply: {args.export_hull_ply}")

        if args.export_landmarks or args.export_rbv:
            axis_fn = (trunk_axis.low_high_layer
                       if args.trunk_axis_algorithm == "lowhigh"
                       else trunk_axis.average_direction)
            axis = axis_fn(pos, member & (cls_ == 1))
            tf = trunk_axis.axis_transform(axis)
            rbv_kw = dict(
                transform=tf,
                method=(rbv_mod.METHOD_MEAN if args.rbv_method == "mean"
                        else rbv_mod.METHOD_MAX),
                symmetric=args.rbv_symmetric,
            )
            if args.rbv_slices is not None:
                rbv_kw.update(crown_slices=args.rbv_slices,
                              trunk_slices=args.rbv_slices)
            if args.rbv_sectors is not None:
                rbv_kw.update(crown_sectors=args.rbv_sectors,
                              trunk_sectors=args.rbv_sectors)
            crown, trunk = rbv_mod.split_rbv(pos, cls_, member, **rbv_kw)
            if args.export_landmarks:
                rows = rbv_mod.split_landmarks(crown, trunk)
                with open(args.export_landmarks, "w") as fh:
                    for row in rows.reshape(-1, 3):
                        fh.write(exports.landmarks_txt(row))
                print(f"landmarks: {args.export_landmarks}")
            if args.export_rbv:
                with open(args.export_rbv, "w") as fh:
                    fh.write(exports.rbv_distances_json(
                        crown.center.cpu().numpy(), float(crown.min_y),
                        crown.distances.cpu().numpy(), crown.slices,
                        crown.sectors,
                    ))
                print(f"rbv distances: {args.export_rbv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
