"""Interactive command loop — the reference's Interactive phase as a REPL.

The reference drives interaction through a winit/egui window: a mode selector
(View/Draw/Combine/Spawn/Delete, interactive/mod.rs:958-968), mouse click
dispatch per mode (:713-804), right-drag brush edits (:807-954), camera
WASD/QE + drag-rotate + scroll (camera.rs:153-216, program.rs:412-450), egui
sliders (point size, brush radius, segmentation distance, eye-dome strength,
palette radios, property range) and a focused single-tree view with property
displays and hull/RBV/trunk-axis overlays (:971-1000).

The port is headless, so the same event surface is a line-oriented REPL
(``treee_tpu/repl.py``, over the port's ``Session``): every widget and mouse
interaction maps to a command; frames render to PNG on demand, written by
``io.exports.png_encode`` (stdlib zlib, no imaging package). All edits are the
``Session``/``interactive.py`` transitions on the session's device (the card
unless the session was made on the CPU) — the cloud never leaves the device
between commands; cameras and sessions a command makes go to the same device.
"""

from __future__ import annotations

import shlex
import sys
import time

import numpy as np

from .input import InputController
from .io.exports import png_encode
from .pipeline import Session
from .render import Camera

HELP = """\
commands (reference widget/mouse equivalents in parens):
  mode view|draw|combine|spawn|delete   interaction mode (Modus radio)
  click PX PY             mouse click at pixel: select / set draw target /
                          combine pair / spawn segment (mod.rs:713-804)
  drag PX PY              brush drag at pixel: delete / draw / reclassify
                          along current mode (mod.rs:807-954)
  radius R                brush radius slider 0.1-10 (mod.rs:455-463)
  distance D              re-segment with new min distance (segmenting slider)
  camera orbit|fp         controller (camera.rs Orbital/FirstPerson)
  key K [N]               WASD/QE movement, N ticks (program.rs:412-450)
  rotate DX DY | scroll V mouse-look / zoom
  event down|up BTN X Y | event move X Y | event wheel V | event key K 1|0
                          raw pointer/key events -> the shared
                          input.InputController (click select, drag rotate,
                          right-drag brush, WASD; the browser page posts
                          these — one event->action layer, program.rs:555)
  display classification|expansion|height|curve|shaded   focused property view
  display intensity|rgb|file_classification|return_number|gps_time|nir
                          source-attribute view (forest AND focused renders;
                          fields the reference loader discards, io/las.py)
  display hag             height above the DTM ground surface (whole-forest
                          normalized height, rasters.height_above_ground)
  overlay hull|rbv|axis on|off                     focused overlays
  hullinclude all|crown|trunk|ground|tree|nocrown  hull class filter
                          (IncludeMode combo, hull.rs:15-67)
  rbv slices N | sectors N | method max|mean | symmetric on|off
                          RBV knobs (hull.rs:248-285 widgets)
  axisalgo average|lowhigh                         trunk-axis algorithm
                          (trunk_axis.rs:9-14)
  classify ground|trunk|crown PX PY                focused reclassify brush
  export ply|crown|trunk|ground PATH               focused point export,
                          optionally class-filtered (mod.rs:629-660)
  export las PATH                                  whole live cloud as
                          classified LAS/LAZ (ASPRS codes + tree ids)
  export inventory PATH   whole-forest per-tree CSV: counts, position,
                          heights, DBH + all traits, one batched pass
                          (Session.inventory; uses the rbv/axis settings)
  raster dtm|dsm|chm PATH [CELL]                   terrain/surface/canopy
                          height .asc over the live cloud (rasters.py)
  lod on|off|adaptive [taupx]|level N   render from the octree LOD subset
                          (adaptive = screen-error cut at <= taupx pixels:
                          near field full detail, far field coarse — full-
                          scene frames at a fraction of the z-scatter cost)
  lod adaptive auto rows N|match F      solve tau from a row budget (one
                          ladder dispatch) or a measured pixel-match floor
                          (default view is AUTOMATIC: full cloud below 1M
                          live points, auto-tau adaptive above; any lod
                          command takes over)
  showdeleted on|off      include deleted points in renders (mod.rs:36)
  undelete PX PY          restore deleted points in the brush (draw with
                          show-deleted, mod.rs:845-870)
  pointsize V | palette turbo|warm|white | eyedome S | range MIN MAX
  render [PATH] | focusrender [PATH]               write a frame PNG
  info [SEG] | traits [SEG] | coords [SEG]         analytics (egui panels)
  summary                 forest-level stand aggregates: stems/ha, basal
                          area, canopy cover, QMD (Session.forest_summary)
  compare NPZ [DIST]      change report vs an earlier epoch's checkpoint:
                          matched/lost/new trees by stem position (within
                          DIST m, default 2), growth, stand deltas
                          (change.py)
  save PATH [SEG] | open PATH | add SCAN | addsession NPZ
  status | help | quit
"""


# auto view path: full-cloud frames below this live count, auto-tau
# adaptive above (the JAX package's policy and threshold, kept as they are;
# the port's times of both paths are in PERF.md)
AUTO_ADAPTIVE_MIN_POINTS = 1_000_000

# Source point-record attribute display modes (Session.attribute_prop keys).
ATTR_DISPLAYS = ("intensity", "rgb", "file_classification", "return_number",
                 "gps_time", "nir")


class Repl:
    """Line-command interactive session over a :class:`Session`."""

    def __init__(self, session: Session, out=sys.stdout):
        self.s = session
        self.out = out
        self.mode = "view"
        self.selected: int | None = None
        self.draw_target: int | None = None
        self.combine_first: int | None = None
        self.display = "classification"
        self.overlays = {"hull": False, "rbv": False, "axis": False}
        self.hull_include = "crown"  # IncludeMode (hull.rs:15-67)
        self.rbv_opts = {"slices": None, "sectors": None,
                         "method": "max", "symmetric": False}
        self.axis_algo = "average"  # TrunkAxisAlgorithm (trunk_axis.rs:9-14)
        self.use_lod = False
        # auto view-path selection: full cloud up to ~1M live points,
        # auto-tau screen-error adaptive above.  Any explicit `lod` command
        # takes over permanently.
        self._auto_view = True
        self.show_deleted = False  # mod.rs:36,261 show_deleted toggle
        self.fp = False  # Controller::FirstPerson vs Orbital (camera.rs:147-151)
        self.frame_idx = 0
        # the screen-error adaptive subset is VIEW-DEPENDENT (frustum cull +
        # distance-scaled level cut): remember its tau and rebuild it lazily
        # at the next render after any camera motion, else rotating away from
        # the build-time view would render permanently missing regions
        self._adaptive_tau: float | None = None
        self._lod_dirty = False
        # progressive feedback (serve.py): called with a u8 frame when a
        # load finishes (height preview) or a segmentation preview is ready
        self.preview_hook = None
        # ONE shared event->action layer: raw pointer/key events from any
        # frontend (`event ...` commands; the browser page posts them) fold
        # through input.InputController — click
        # discrimination, drag-rotate, right/shift-drag brush, WASD/QE —
        # exactly as the reference's Program consumes its input crate
        # (program.rs:412-450, 555-622).  rotate_scale keeps the page's
        # historical drag feel at frame-pixel coordinates.
        self.controller = InputController(
            camera=self.s.camera, on_click=self._click, on_drag=self._drag,
            rotate_scale=4.0)
        self._last_event_t = time.monotonic()

    # ---- helpers ---------------------------------------------------------

    def ensure_view_path(self) -> None:
        """Resolve the automatic render path before a whole-cloud frame.

        In auto mode: clouds below ``AUTO_ADAPTIVE_MIN_POINTS`` render full (the
        full frame is already fast there), larger ones get an auto-tau
        screen-error adaptive subset (Session.solve_adaptive_tau at a
        half-cloud row budget, like the bench's adaptive row).  An explicit
        ``lod`` command disables auto permanently for the session.
        """
        if not self._auto_view or self.s.cloud is None:
            return
        n = int(self.s.cloud.count)
        if n < AUTO_ADAPTIVE_MIN_POINTS:
            self.use_lod = False
            self._adaptive_tau = None
            return
        if self._adaptive_tau is None:
            tau = self.s.solve_adaptive_tau(
                budget_rows=max(1 << 16, n // 2))
            self.s.build_lod(camera=self.s.camera, adaptive_tau_px=tau)
            self._adaptive_tau = tau
            self.use_lod = True
            self._lod_dirty = False

    def prepare_frame(self) -> None:
        """Resolve the auto view path and refresh a camera-stale adaptive
        subset; call before rendering any whole-cloud frame."""
        self.ensure_view_path()
        if self.use_lod and self._lod_dirty and self._adaptive_tau is not None:
            self.s.build_lod(camera=self.s.camera,
                             adaptive_tau_px=self._adaptive_tau)
            self._lod_dirty = False

    def _reset_view_path(self) -> None:
        """Cloud changed (open/add/merge): re-resolve auto at next frame."""
        if self._auto_view:
            self.use_lod = False
            self._adaptive_tau = None
            self._lod_dirty = False

    @property
    def view_path(self) -> str:
        """Human-readable render path for /info and the viewer footer."""
        if not self.use_lod:
            return "full"
        if self._adaptive_tau is not None:
            return f"adaptive(tau={self._adaptive_tau:g}px)"
        return "lod"

    def _print(self, msg: str) -> None:
        print(msg, file=self.out)

    def _controller_event(self, kind: str, args) -> None:
        """Fold one raw input event through the shared InputController.

        ``event down|up BUTTON X Y`` / ``event move X Y`` /
        ``event wheel V`` / ``event key K 1|0`` — positions in frame
        pixels.  The controller owns click-vs-drag discrimination (<2 px),
        left-drag rotate, right-drag brush (on_click/_click, on_drag/_drag)
        and WASD/QE movement via tick(dt); camera updates write back to the
        session and mark an adaptive LOD subset stale.
        """
        c = self.controller
        c.mode = "first_person" if self.fp else "orbital"
        c.camera = self.s.camera  # session may have moved it (commands)
        before = c.camera
        # tick FIRST, with the PRE-event key state: the elapsed interval
        # belongs to the keys held DURING it — ticking after would drop the
        # whole held interval on key-up and credit pre-press time on
        # key-down
        now = time.monotonic()
        dt = min(max(now - self._last_event_t, 0.0), 0.1)
        self._last_event_t = now
        c.tick(dt)
        if kind in ("down", "up"):
            x = float(args[1]) if len(args) > 1 else None
            y = float(args[2]) if len(args) > 2 else None
            c.mouse_button(args[0], kind == "down", x, y)
        elif kind == "move":
            c.mouse_move(float(args[0]), float(args[1]))
        elif kind == "wheel":
            c.scroll(float(args[0]))
        elif kind == "key":
            c.key(args[0], len(args) < 2 or args[1] != "0")
        else:
            raise ValueError(f"unknown event kind {kind!r}")
        if c.camera is not before:
            self.s.camera = c.camera
            if self._adaptive_tau is not None:
                self._lod_dirty = True

    def _ray_hit(self, px: float, py: float, include_deleted: bool = False):
        """Pick through a pixel; returns (seg, hit_point) or (None, None).

        ``include_deleted`` (or the show-deleted toggle) makes deleted points
        targetable like the reference's show_deleted brush (mod.rs:845-870).
        """
        seg, dist, found = self.s.pick(
            px, py, include_deleted=include_deleted or self.show_deleted
        )
        if not found:
            return None, None
        cam = self.s.camera
        d = cam.ray_direction(
            px, py, self.s.config.render.width, self.s.config.render.height
        ).cpu().numpy()
        origin = cam.position.cpu().numpy()
        return seg, origin + d * dist

    def _resolve_seg(self, args) -> int | None:
        if args:
            return int(args[0])
        if self.selected is None:
            self._print("no segment selected (click in view mode first)")
            return None
        return self.selected

    def _save_png(self, img: np.ndarray, path: str | None) -> None:
        if path is None:
            path = f"frame_{self.frame_idx:03d}.png"
            self.frame_idx += 1
        with open(path, "wb") as fh:
            fh.write(png_encode(img))
        self._print(f"wrote {path}")

    # ---- command dispatch -------------------------------------------------

    def run(self, stream=sys.stdin) -> None:
        for line in stream:
            if not self.handle(line):
                break

    def handle(self, line: str) -> bool:
        """Execute one command line; returns False on quit."""
        line = line.split("#", 1)[0].strip()
        if not line:
            return True
        try:
            cmd, *args = shlex.split(line)
            cont = self._dispatch(cmd.lower(), args)
            if cmd.lower() in ("camera", "key", "rotate", "scroll") \
                    and self._adaptive_tau is not None:
                self._lod_dirty = True
            return cont
        except Exception as e:  # surface, keep looping (reference error toast)
            self._print(f"error: {e}")
            return True

    def _dispatch(self, cmd: str, args) -> bool:
        import dataclasses

        s = self.s
        rcfg = s.config.render
        if cmd in ("quit", "exit", "q"):
            return False
        elif cmd == "help":
            self._print(HELP)
        elif cmd == "mode":
            if args[0] not in ("view", "draw", "combine", "spawn", "delete"):
                raise ValueError(f"unknown mode {args[0]!r}")
            self.mode = args[0]
            self.combine_first = None
            self._print(f"mode: {self.mode}")
        elif cmd == "click":
            self._click(float(args[0]), float(args[1]))
        elif cmd == "drag":
            self._drag(float(args[0]), float(args[1]))
        elif cmd == "radius":
            s.config = s.config.replace(
                interactive=dataclasses.replace(
                    s.config.interactive, draw_radius=float(args[0])
                )
            )
        elif cmd == "distance":
            # preview_hook (set by serve.py): a 1/64-subsample segmentation
            # preview frame lands in the viewer before the full pipeline runs
            res = s.segment(float(args[0]), preview_cb=self.preview_hook)
            self._print(f"segments: {int(res.n_segments)}")
        elif cmd == "camera":
            if args[0] in ("orbit", "orbital"):
                s.camera = Camera.orbital(
                    distance=float(args[1]) if len(args) > 1 else 100.0,
                    device=s.device,
                )
                self.fp = False
            elif args[0] in ("fp", "first-person"):
                self.fp = True  # same transform, different controls
            else:
                raise ValueError(f"unknown camera {args[0]!r}")
        elif cmd == "event":
            # raw frontend events -> shared InputController (see above)
            self._controller_event(args[0], args[1:])
        elif cmd == "key":
            n = int(args[1]) if len(args) > 1 else 1
            for _ in range(n):
                s.camera = _apply_key(s.camera, args[0], self.fp)
        elif cmd == "rotate":
            s.camera = (
                s.camera.rotate_first_person(float(args[0]), float(args[1]))
                if self.fp
                else s.camera.rotate_orbital(float(args[0]), float(args[1]))
            )
        elif cmd == "scroll":
            s.camera = (
                s.camera.scroll_first_person(float(args[0]))
                if self.fp
                else s.camera.scroll_orbital(float(args[0]))
            )
        elif cmd == "display":
            if args[0] not in ("classification", "expansion", "height",
                               "curve", "shaded", "hag") + ATTR_DISPLAYS:
                raise ValueError(f"unknown display {args[0]!r}")
            if args[0] in ATTR_DISPLAYS and args[0] not in s.attributes:
                avail = ", ".join(sorted(s.attributes)) or "none"
                raise ValueError(
                    f"scan has no {args[0]!r} attribute (available: {avail})"
                )
            self.display = args[0]
        elif cmd == "overlay":
            self.overlays[args[0]] = args[1] == "on"
        elif cmd == "hullinclude":
            from .cloud import INCLUDE_MODES

            if args[0] not in INCLUDE_MODES:
                raise ValueError(
                    f"unknown include mode {args[0]!r} (one of {INCLUDE_MODES})"
                )
            self.hull_include = args[0]
            self._print(f"hull include: {self.hull_include}")
        elif cmd == "rbv":
            key, val = args[0], args[1]
            if key in ("slices", "sectors"):
                self.rbv_opts[key] = int(val)
            elif key == "method":
                if val not in ("max", "mean"):
                    raise ValueError("rbv method is max or mean")
                self.rbv_opts["method"] = val
            elif key == "symmetric":
                self.rbv_opts["symmetric"] = val == "on"
            else:
                raise ValueError(f"unknown rbv option {key!r}")
            self._print(f"rbv {key}: {val}")
        elif cmd == "axisalgo":
            if args[0] not in ("average", "lowhigh"):
                raise ValueError("axisalgo is average or lowhigh")
            self.axis_algo = args[0]
            self._print(f"trunk axis algorithm: {self.axis_algo}")
        elif cmd == "export":
            self._export(args[0], args[1])
        elif cmd == "raster":
            cell = float(args[2]) if len(args) > 2 else 0.5
            rows, cols = s.export_raster(args[1], args[0], cell=cell)
            self._print(f"wrote {args[1]} ({rows}x{cols})")
        elif cmd == "lod":
            self._auto_view = False  # explicit choice wins from here on
            if args[0] in ("on", "off"):
                self.use_lod = args[0] == "on"
            elif args[0] == "adaptive":
                # screen-error cut: per-region octree level by camera
                # distance (octree.adaptive_mask) — near field full detail,
                # far field coarse representatives; optional tau pixels arg.
                # bench measures it against the full render per-pixel
                # (screen_adaptive_pixel_match)
                if len(args) > 1 and args[1] == "auto":
                    # auto-tau: solve from a row budget or a pixel-match
                    # floor (Session.solve_adaptive_tau) so the cut degrades
                    # predictably at any scan scale
                    if len(args) < 4 or args[2] not in ("rows", "match"):
                        raise ValueError(
                            "lod adaptive auto rows N | match FRACTION")
                    if args[2] == "rows":
                        tau = self.s.solve_adaptive_tau(
                            budget_rows=int(args[3]))
                    else:
                        tau = self.s.solve_adaptive_tau(
                            match_floor=float(args[3]))
                    self._print(f"auto tau = {tau} px")
                else:
                    tau = float(args[1]) if len(args) > 1 else 1.0
                self.s.build_lod(camera=self.s.camera, adaptive_tau_px=tau)
                self.use_lod = True
                self._adaptive_tau = tau
                self._lod_dirty = False
            elif args[0] == "level":
                self.s.build_lod(level=int(args[1]))
                self.use_lod = True
                self._adaptive_tau = None  # level cut is view-independent
            else:
                raise ValueError("lod takes on|off|adaptive|level N")
        elif cmd == "showdeleted":
            self.show_deleted = args[0] == "on"
        elif cmd == "undelete":
            # restore deleted points in the brush into the selected segment
            # (the reference draws over deleted points when show_deleted is
            # on, mod.rs:845-870)
            seg, hit = self._ray_hit(float(args[0]), float(args[1]),
                                     include_deleted=True)
            if hit is None:
                self._print("miss")
            else:
                target = self.selected if self.selected is not None else seg
                if target == 0:  # picked a deleted point with nothing selected
                    target = self.s._alloc_id()
                self.s.draw_sphere(hit, target, include_deleted=True)
                self._print(
                    f"restored around {np.round(hit, 2)} -> segment {target}"
                )
        elif cmd == "pointsize":
            s.config = s.config.replace(
                render=dataclasses.replace(rcfg, point_size=float(args[0]))
            )
        elif cmd == "palette":
            from .render import palettes

            s.config = s.config.replace(
                render=dataclasses.replace(rcfg, palette=args[0])
            )
            s.palette = palettes.get(args[0], device=s.device)
        elif cmd == "eyedome":
            s.config = s.config.replace(
                render=dataclasses.replace(
                    rcfg, eye_dome_strength=float(args[0])
                )
            )
        elif cmd == "range":
            s.config = s.config.replace(
                render=dataclasses.replace(
                    rcfg, prop_min=int(args[0]), prop_max=int(args[1])
                )
            )
        elif cmd == "render":
            self.prepare_frame()
            prop, pal = (None, None)
            if self.display in ATTR_DISPLAYS:
                prop, pal = s.attribute_prop(self.display)
            elif self.display == "hag":
                prop = s.hag_prop()
            self._save_png(
                s.render(use_lod=self.use_lod,
                         show_deleted=self.show_deleted,
                         prop=prop, palette=pal),
                args[0] if args else None,
            )
        elif cmd == "focusrender":
            sid = self.selected
            if sid is None:
                raise ValueError("select a segment first (view-mode click)")
            img = s.render_focus(
                sid,
                display=self.display,
                show_hull=self.overlays["hull"],
                show_rbv=self.overlays["rbv"],
                show_axis=self.overlays["axis"],
                hull_include=self.hull_include,
                rbv_slices=self.rbv_opts["slices"],
                rbv_sectors=self.rbv_opts["sectors"],
                rbv_method=self.rbv_opts["method"],
                rbv_symmetric=self.rbv_opts["symmetric"],
                axis_algo=self.axis_algo,
            )
            self._save_png(img, args[0] if args else None)
        elif cmd == "classify":
            cls = {"ground": 0, "trunk": 1, "crown": 2}[args[0]]
            seg, hit = self._ray_hit(float(args[1]), float(args[2]))
            if hit is None:
                self._print("miss")
            else:
                target = self.selected if self.selected is not None else seg
                s.reclassify_sphere(hit, cls, target)
                self._print(f"classified {args[0]} around {np.round(hit, 2)}")
        elif cmd == "info":
            sid = self._resolve_seg(args)
            if sid is not None:
                self._info(sid)
        elif cmd == "traits":
            sid = self._resolve_seg(args)
            if sid is not None:
                self._traits(sid)
        elif cmd == "summary":
            import json as _json

            self._print(_json.dumps(
                s.forest_summary(
                    inventory=s.inventory(
                        method=self.rbv_opts["method"],
                        symmetric=self.rbv_opts["symmetric"],
                        axis_algo=self.axis_algo,
                    )
                ),
                indent=2,
            ))
        elif cmd == "compare":
            # multi-epoch change report against an earlier session
            # checkpoint (change.py; no reference analogue)
            import json as _json

            from . import change as change_mod

            if not args:
                raise ValueError("compare needs a session .npz path")
            prev = Session.open(args[0], s.config, device=s.device)
            kw = dict(method=self.rbv_opts["method"],
                      symmetric=self.rbv_opts["symmetric"],
                      axis_algo=self.axis_algo)
            dist = float(args[1]) if len(args) > 1 else 2.0
            inv_a, inv_b = prev.inventory(**kw), s.inventory(**kw)
            ch = change_mod.tree_changes(inv_a, inv_b, dist)
            m = ch["matched"]
            n = len(m["segment_b"])
            self._print(_json.dumps({
                "matched": n,
                "lost": len(ch["lost"]["segment"]),
                "new": len(ch["new"]["segment"]),
                "mean_delta_height": (
                    float(m["delta_tree_height"].mean()) if n else 0.0),
                "stand": change_mod.stand_changes(
                    prev.forest_summary(inventory=inv_a),
                    s.forest_summary(inventory=inv_b)),
            }, indent=2))
        elif cmd == "coords":
            sid = self._resolve_seg(args)
            if sid is not None:
                c = s.segment_coords(sid)
                if c is None:
                    self._print("proj string did not parse")
                else:
                    self._print(
                        f"lon {np.degrees(c[0]):.6f} lat {np.degrees(c[1]):.6f}"
                    )
        elif cmd == "save":
            # 'save PATH [SEG]': SEG saves just that segment (the focused
            # view's Segment .ipc button, mod.rs:655-668)
            sid = int(args[1]) if len(args) > 1 else None
            s.save(args[0], segment_id=sid)
            self._print(
                f"saved {args[0]}" + (f" (segment {sid})" if sid else "")
            )
        elif cmd == "open":
            self.s = Session.open(args[0], s.config, device=s.device)
            self.selected = None
            self.draw_target = None
            self.combine_first = None
            self._reset_view_path()
            self._print(f"opened {args[0]}")
            if self.preview_hook is not None:
                self.preview_hook(self.s.preview_frame(self.s.camera))
        elif cmd == "add":
            # ingest-time preview: coarse height frames stream to the viewer
            # per decoded slab, while the .laz is still decompressing
            # (loading.rs:91-115 chunk streaming)
            s.add_las(args[0], preview_cb=self.preview_hook)
            self._reset_view_path()
            self._print(f"added {args[0]}: {int(s.cloud.count):,} points")
            if self.preview_hook is not None:
                # reference behavior: freshly decoded points appear on screen
                # before any (re)segmentation (loading.rs:91-115)
                self.preview_hook(s.preview_frame(s.camera))
        elif cmd == "addsession":
            s.add_session(args[0])
            self._reset_view_path()
            self._print(f"merged {args[0]}: {int(s.cloud.count):,} points")
        elif cmd == "status":
            n_seg = (
                int(s.table.present.sum()) if s.table is not None else "?"
            )
            self._print(
                f"points {int(s.cloud.count):,}  segments {n_seg}  "
                f"mode {self.mode}  selected {self.selected}  lod {self.use_lod}"
            )
        else:
            raise ValueError(f"unknown command {cmd!r} (try 'help')")
        return True

    # ---- mouse dispatch (mod.rs:713-954) ----------------------------------

    def _click(self, px: float, py: float) -> None:
        seg, hit = self._ray_hit(px, py)
        if self.mode == "view":
            if seg is None:
                self.selected = None
                self._print("miss (deselected)")
            else:
                self.selected = seg
                self._print(f"selected segment {seg}")
        elif self.mode == "draw":
            # first click picks the target, later drags paint into it
            if seg is not None:
                self.draw_target = seg
                self._print(f"draw target: {seg}")
        elif self.mode == "combine":
            if seg is None:
                return
            if self.combine_first is None:
                self.combine_first = seg
                self._print(f"combine: first {seg}")
            else:
                # second click merges INTO the first-selected survivor
                # (Session.combine(a, b) relabels a's points to b)
                self.s.combine(seg, self.combine_first)
                self._print(f"combined {seg} into {self.combine_first}")
                self.combine_first = None
        elif self.mode == "spawn":
            if hit is not None:
                nid = self.s.spawn(hit)
                self.draw_target = nid
                self._print(f"spawned segment {nid}")
        elif self.mode == "delete":
            self._drag(px, py)

    def _drag(self, px: float, py: float) -> None:
        seg, hit = self._ray_hit(px, py)
        if hit is None:
            self._print("miss")
            return
        if self.mode == "delete":
            self.s.delete_sphere(hit)
            self._print(f"deleted around {np.round(hit, 2)}")
        elif self.mode == "draw":
            target = self.draw_target
            if target is None:
                self._print("no draw target (click a segment first)")
                return
            self.s.draw_sphere(hit, target)
            self._print(f"drew {np.round(hit, 2)} -> segment {target}")
        else:
            self._print(f"drag has no effect in {self.mode} mode")

    # ---- panels -----------------------------------------------------------

    def _info(self, sid: int) -> None:
        s = self.s
        if s.table is None:
            s.characteristics()
        t = s.table
        if not bool(t.present[sid]):
            self._print(f"segment {sid}: absent")
            return
        self._print(
            f"segment {sid}: {int(t.count[sid]):,} points  "
            f"trunk_height {float(t.trunk_height[sid]):.2f}  "
            f"crown_height {float(t.crown_height[sid]):.2f}  "
            f"ground_sep {float(t.ground_sep[sid]):.2f}  "
            f"crown_sep {float(t.crown_sep[sid]):.2f}"
        )

    def _traits(self, sid: int) -> None:
        from . import rbv as rbv_mod

        pos, cls_, member = self.s.segment_rows(sid)
        if not bool(member.any()):
            self._print(f"segment {sid}: absent")
            return
        crown, trunk = rbv_mod.split_rbv(
            pos, cls_, member,
            method=(rbv_mod.METHOD_MEAN if self.rbv_opts["method"] == "mean"
                    else rbv_mod.METHOD_MAX),
            symmetric=self.rbv_opts["symmetric"],
        )
        self._print(rbv_mod.traits(crown, trunk).to_json())

    def _export(self, what: str, path: str) -> None:
        """Focused point export, optionally class-filtered (the reference's
        Crown/Trunk/Ground/Points buttons, mod.rs:629-660).  ``export las``
        writes the whole live cloud as classified LAS/LAZ instead (a
        treee-tpu addition: Session.export_las)."""
        if what == "las":
            n = self.s.export_las(path)
            self._print(f"wrote {n} classified points to {path}")
            return
        if what == "inventory":
            from .io import exports

            inv = self.s.inventory(
                method=self.rbv_opts["method"],
                symmetric=self.rbv_opts["symmetric"],
                axis_algo=self.axis_algo,
            )
            with open(path, "w") as fh:
                n = exports.save_inventory_csv(fh, inv)
            self._print(f"wrote {n} trees to {path}")
            return
        sid = self.selected
        if sid is None:
            raise ValueError("select a segment first (view-mode click)")
        include = {"ply": "all", "crown": "crown", "trunk": "trunk",
                   "ground": "ground"}.get(what)
        if include is None:
            raise ValueError(f"unknown export {what!r} "
                             "(ply|crown|trunk|ground|las|inventory)")
        n = self.s.export_points_ply(path, segment_id=sid, include=include)
        self._print(f"wrote {n} points to {path}")


def _apply_key(cam: Camera, key: str, fp: bool) -> Camera:
    """WASD/QE movement (program.rs:418-447, camera.rs:153-171)."""
    step = {
        "w": (0.0, -1.0), "s": (0.0, 1.0), "a": (-1.0, 0.0), "d": (1.0, 0.0),
    }
    if key in step:
        dx, dy = step[key]
        return (
            cam.move_first_person(dx, dy) if fp else cam.move_orbital(dx, dy)
        )
    if key == "q":
        return cam.move_vertical(1.0)
    if key == "e":
        return cam.move_vertical(-1.0)
    raise ValueError(f"unknown key {key!r}")
