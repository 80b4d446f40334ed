"""The port's CLI (``treee_tpu_torch/app.py``) and REPL (``repl.py``) against
the JAX package's on the CPU.

One JAX CLI run of ``tests/test_app.py``'s argument list (the demo scene,
``TREEE_APP_CONFIG=small``, 192x108 frames, every export) and the port's
run of the same list with ``--cpu`` are made once, in a module fixture, and
their outputs compared; the REPL cases of ``tests/test_app.py`` run one
command script through a JAX ``Repl`` and a port ``Repl`` over the same
scene.  The port runs its kernels' plain versions (its tensors are on the
CPU).  The demo's connected components settle within the JAX CPU path's
early stop (ROADMAP Queue 3), so the JAX CLI itself is the reference: ids
and classes agree, which every comparison below rests on.

Tolerances, and why:

- the printed lines: equal, the run's directory aside;
- ``info.json``: keys and counts equal, heights, separators and boxes
  within rtol 1e-6 (the table's floats, tests/test_torch_pipeline.py);
- the inventory CSV, ``summary.json`` and ``traits.json``: rtol 1e-5, as
  tests/test_torch_inventory.py holds the inventory (the port sums in the
  segmented cumsum's order, JAX in scatter order); a CSV value may also
  differ by one unit in its last printed place, where the two round to
  neighbouring digits;
- ``chm.asc``: byte for byte, as tests/test_torch_rasters.py holds
  ``export_raster``;
- the ``.ply`` exports: their row counts; the RBV distances and landmarks
  rtol 1e-5 (tests/test_torch_focus.py's RBV mean grids); the port's hull
  is exact, so the JAX CLI's hull export takes ``exact=True`` (its own
  hull of more than 512 points is the 512 support candidates' alone);
- the frame: the share of equal pixels at least
  tests/test_torch_render.py's ``MIN_KEY_AGREEMENT``, because the JAX CLI
  renders jitted (XLA contracts the depth key's ``p22 * vz + p23`` into an
  FMA);
- checkpoints across the packages: arrays equal;
- the REPL: the printed text equal, the paths aside, but for decimal
  numbers within rtol 1e-5 (the traits and the summary come from the
  inventory's sums); the segment ids and classes bit for bit after every
  line of the script.
"""

import contextlib
import csv
import io
import json
import re

import numpy as np
import pytest
import torch

from tests.test_serve import _decode_png
from treee_tpu import app as japp
from treee_tpu import hull3d as jhull
from treee_tpu_torch import app as tapp

import torch_threads

torch_threads.share_cores()

MIN_KEY_AGREEMENT = 0.999

# tests/test_app.py:22-49, every output under the run's directory
ARGV = [
    "--demo", "--frames", "1",
    "--width", "192", "--height", "108",
    "--out-dir", "{d}/frames",
    "--save", "{d}/sess.npz",
    "--export-info", "{d}/info.json",
    "--export-traits", "{d}/traits.json",
    "--export-ply", "{d}/points.ply",
    "--segment-id", "1",
    "--export-hull-ply", "{d}/hull.ply",
    "--export-landmarks", "{d}/lm.txt",
    "--export-rbv", "{d}/rbv.json",
    "--export-crown-ply", "{d}/crown.ply",
    "--export-trunk-ply", "{d}/trunk.ply",
    "--export-ground-ply", "{d}/ground.ply",
    "--hull-include", "tree",
    "--rbv-method", "mean",
    "--rbv-symmetric",
    "--rbv-slices", "6",
    "--rbv-sectors", "8",
    "--trunk-axis-algorithm", "lowhigh",
    "--eye-dome-strength", "0.5",
    "--brush-radius", "1.5",
    "--export-chm", "{d}/chm.asc",
    "--raster-cell", "2.0",
    "--export-inventory", "{d}/inv.csv",
    "--export-summary", "{d}/summary.json",
]


def _run(main, argv) -> tuple[int, str]:
    """``main(argv)``'s return code and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX dir, JAX stdout, port dir, port stdout) of the one CLI run each."""
    pytest.importorskip("PIL")  # the JAX CLI writes its frames through PIL
    mp = pytest.MonkeyPatch()
    mp.setenv("TREEE_APP_CONFIG", "small")
    exact = jhull.convex_hull
    mp.setattr(jhull, "convex_hull", lambda pos, mask, **kw: exact(
        pos, mask, **{**kw, "exact": True}))
    try:
        jd = tmp_path_factory.mktemp("jax_cli")
        td = tmp_path_factory.mktemp("port_cli")
        rc_j, out_j = _run(japp.main, [a.format(d=jd) for a in ARGV])
        rc_t, out_t = _run(tapp.main, [a.format(d=td) for a in ARGV]
                           + ["--cpu"])
    finally:
        mp.undo()
    assert (rc_j, rc_t) == (0, 0)
    return jd, out_j, td, out_t


def test_cli_prints_the_jax_lines(runs):
    jd, out_j, td, out_t = runs
    assert out_t.replace(str(td), "D") == out_j.replace(str(jd), "D")
    segments = [ln for ln in out_t.splitlines() if ln.startswith("segments:")]
    assert len(segments) == 1 and int(segments[0].split()[1]) > 1


def test_cli_info_json_matches_jax(runs):
    jd, _, td, _ = runs
    got = json.load(open(td / "info.json"))
    ref = json.load(open(jd / "info.json"))
    assert sorted(got) == sorted(ref) and len(got) > 1
    for sid, row in ref.items():
        assert set(got[sid]) == set(row)
        assert got[sid]["count"] == row["count"]
        for key in ("trunk_height", "crown_height", "ground_sep", "crown_sep",
                    "min", "max", "offset"):
            np.testing.assert_allclose(got[sid][key], row[key], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{sid} {key}")


def _csv(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def _last_place(text: str) -> float:
    """One unit in the last printed place of a CSV value."""
    mant, _, exp = text.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - decimals)


def assert_inventory_csv_close(got_path, ref_path):
    """Both CSVs hold the same columns and rows, each value within rtol
    1e-5 of the reference plus one unit in its last printed place (a value
    within 1e-5 may still round to a neighbouring last digit: 0.001 m in
    the fixed-point map columns)."""
    head, got = _csv(got_path)
    ref_head, ref = _csv(ref_path)
    assert head == ref_head and len(got) == len(ref) > 1
    for g_row, r_row in zip(got, ref):
        for col, g, r in zip(head, g_row, r_row):
            g_v, r_v = float(g), float(r)
            tol = 1e-5 * abs(r_v) + _last_place(r)
            assert abs(g_v - r_v) <= tol, (col, g, r)


def test_cli_inventory_summary_and_traits_match_jax(runs):
    jd, _, td, _ = runs
    assert_inventory_csv_close(td / "inv.csv", jd / "inv.csv")
    for name in ("summary.json", "traits.json"):
        got = json.load(open(td / name))
        ref = json.load(open(jd / name))
        flat = lambda d: {f"{k}.{k2}": v2 for k, v in d.items()
                          for k2, v2 in (v.items() if isinstance(v, dict)
                                         else [("", v)])}
        g, r = flat(got), flat(ref)
        assert sorted(g) == sorted(r), name
        np.testing.assert_allclose([g[k] for k in sorted(r)],
                                   [r[k] for k in sorted(r)], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_cli_chm_is_byte_equal(runs):
    jd, _, td, _ = runs
    got = (td / "chm.asc").read_bytes()
    assert got == (jd / "chm.asc").read_bytes()
    assert got.startswith(b"ncols")


def _ply_rows(path) -> dict:
    head = open(path).read().split("end_header")[0]
    return {ln.split()[1]: int(ln.split()[2]) for ln in head.splitlines()
            if ln.startswith("element")}


def test_cli_ply_exports_and_rbv_match_jax(runs):
    jd, _, td, _ = runs
    for name in ("points", "crown", "trunk", "ground", "hull"):
        got, ref = _ply_rows(td / f"{name}.ply"), _ply_rows(jd / f"{name}.ply")
        assert got == ref and got["vertex"] > 0, name
    got, ref = json.load(open(td / "rbv.json")), json.load(open(jd / "rbv.json"))
    assert (got["slices"], got["sectors"]) == (ref["slices"], ref["sectors"]) \
        == (6, 8)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(np.loadtxt(td / "lm.txt"),
                               np.loadtxt(jd / "lm.txt"), rtol=1e-5,
                               atol=1e-5)


def test_cli_frame_matches_jax(runs):
    jd, _, td, _ = runs
    got = _decode_png((td / "frames" / "frame_000.png").read_bytes())
    from PIL import Image

    ref = np.asarray(Image.open(jd / "frames" / "frame_000.png").convert("RGB"))
    assert got.shape == ref.shape == (108, 192, 3)
    assert (got == ref).all(-1).mean() >= MIN_KEY_AGREEMENT
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 10


def _npz_arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cli_checkpoints_cross_the_packages(runs, tmp_path):
    """The port's CLI opens the JAX CLI's --save and saves it again, and the
    JAX CLI the port's: the arrays come back equal."""
    jd, _, td, _ = runs
    ref_j, ref_t = _npz_arrays(jd / "sess.npz"), _npz_arrays(td / "sess.npz")
    assert sorted(ref_j) == sorted(ref_t)
    for k in ref_j:
        np.testing.assert_array_equal(ref_t[k], ref_j[k], err_msg=k)
    out_t, out_j = tmp_path / "t.npz", tmp_path / "j.npz"
    rc, text = _run(tapp.main, [str(jd / "sess.npz"), "--cpu", "--save",
                                str(out_t)])
    assert rc == 0 and "points: 148,000" in text
    rc, text = _run(japp.main, [str(td / "sess.npz"), "--save", str(out_j)])
    assert rc == 0 and "points: 148,000" in text
    got_t, got_j = _npz_arrays(out_t), _npz_arrays(out_j)
    for k in ref_j:
        np.testing.assert_array_equal(got_t[k], ref_j[k], err_msg=k)
        np.testing.assert_array_equal(got_j[k], ref_t[k], err_msg=k)


def test_cli_reopen_renders_the_saved_session(runs, tmp_path):
    """``sess.npz --no-segment --frames 1``: the frame of the reopened
    checkpoint is the frame the first run drew."""
    _, _, td, _ = runs
    rc, _ = _run(tapp.main, [str(td / "sess.npz"), "--cpu", "--no-segment",
                             "--frames", "1", "--width", "192", "--height",
                             "108", "--eye-dome-strength", "0.5",
                             "--out-dir", str(tmp_path)])
    assert rc == 0
    assert ((tmp_path / "frame_000.png").read_bytes()
            == (td / "frames" / "frame_000.png").read_bytes())


def test_cli_arg_errors(tmp_path, monkeypatch):
    """tests/test_app.py's return codes, and --export-changes without
    --compare."""
    monkeypatch.setenv("TREEE_APP_CONFIG", "small")
    assert tapp.main(["--cpu"]) == 2  # no input, no --demo
    assert tapp.main([]) == 2         # a usage error before any device
    rc = tapp.main(["--demo", "--cpu", "--export-hull-ply",
                    str(tmp_path / "h.ply")])
    assert rc == 2
    assert tapp.main(["--demo", "--cpu", "--export-changes",
                      str(tmp_path / "c.csv")]) == 2


def test_cli_reference_ipc_roundtrip(tmp_path):
    """tests/test_app.py:547: the CLI opens a reference-app .ipc session and
    saves one back."""
    from treee_tpu_torch.io import ipc

    arrays = {
        "pos": np.array([[0, 0, 0], [1, 5, 1], [2, 1, 2], [0, 9, 9]],
                        np.float32),
        "segment": np.array([1, 1, 2, 0], np.int32),
        "classification": np.array([0, 2, 1, 0], np.int32),
    }
    src = tmp_path / "ref.ipc"
    ipc.write_reference_ipc(str(src), arrays, np.zeros(3), "+proj=utm")
    out = tmp_path / "back.ipc"
    rc, _ = _run(tapp.main, [str(src), "--cpu", "--save", str(out)])
    assert rc == 0
    got, _, loc = ipc.load(str(out))
    assert loc == "+proj=utm"
    assert len(got["pos"]) == 4
    assert set(np.unique(got["segment"])) == {0, 1, 2}


def test_cli_mesh_auto_on_one_device_is_a_no_op(tmp_path):
    src = _small_checkpoint(tmp_path)
    rc, text = _run(tapp.main, [src, "--cpu", "--mesh", "auto"])
    assert rc == 0 and "points: 600" in text


def test_cli_mesh_auto_over_several_cards_raises(tmp_path, monkeypatch):
    """Several cards: ``--mesh auto`` shards the session over all of them
    rather than quietly running on one; one card or the CPU is one device."""
    from treee_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = sharding.auto_mesh("cuda")
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert sharding.auto_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharding.auto_mesh("cuda") is None


def _small_checkpoint(tmp_path) -> str:
    from treee_tpu_torch.pipeline import Session

    pts = np.random.default_rng(35).uniform(-10, 10, (600, 3)).astype(
        np.float32)
    path = str(tmp_path / "small.npz")
    Session.from_points(pts, device="cpu").save(path)
    return path


# ---- the REPL: one script through both packages -------------------------------------

def _configs():
    from treee_tpu.config import CharacteristicsConfig as JCC
    from treee_tpu.config import Config as JConfig
    from treee_tpu.config import RenderConfig as JRC
    from treee_tpu.config import SegmentationConfig as JSC
    from treee_tpu_torch.config import CharacteristicsConfig as TCC
    from treee_tpu_torch.config import Config as TConfig
    from treee_tpu_torch.config import RenderConfig as TRC
    from treee_tpu_torch.config import SegmentationConfig as TSC

    seg = dict(grid_size=128, max_bands=16, max_segments=256,
               max_trees_per_band=32)
    # the JAX side with cc_iters=4096: its CPU connected components stop
    # after ceil(cc_iters / 4) bodies by default (ROADMAP Queue 3), which
    # leaves tests/test_app.py:140's scene unsettled; the port and the
    # JAX package's TPU path run to the fixpoint
    return (JConfig(segmentation=JSC(**seg, cc_iters=4096),
                    characteristics=JCC(max_slices=96),
                    render=JRC(width=192, height=108)),
            TConfig(segmentation=TSC(**seg),
                    characteristics=TCC(max_slices=96),
                    render=TRC(width=192, height=108)))


def _same_state(ts, js, what):
    n = ts.cloud.capacity
    for f in ("segment", "classification", "valid"):
        np.testing.assert_array_equal(
            getattr(ts.cloud, f).numpy(), np.asarray(getattr(js.cloud, f))[:n],
            err_msg=f"{what}: {f}")


def _repls(pts, tmp_path):
    """A JAX and a port Repl over the same segmented scene."""
    from treee_tpu.pipeline import Session as JSession
    from treee_tpu.repl import Repl as JRepl
    from treee_tpu_torch.pipeline import Session as TSession
    from treee_tpu_torch.repl import Repl as TRepl

    jcfg, tcfg = _configs()
    js = JSession.from_points(pts, jcfg)
    ts = TSession.from_points(pts, tcfg, device="cpu")
    js.segment(0.75)
    ts.segment(0.75)
    _same_state(ts, js, "segment(0.75)")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    return (JRepl(js, out=io.StringIO()), jdir), (TRepl(ts, out=io.StringIO()),
                                                  tdir)


_NUMBER = re.compile(r"-?\d+\.\d*(?:[eE][-+]?\d+)?")


def _same_text(got: str, ref: str, what: str) -> None:
    """The same text, but for decimal numbers (the panels' floats) within
    rtol 1e-5: the traits and the summary come from the inventory's sums."""
    g_parts, r_parts = _NUMBER.split(got), _NUMBER.split(ref)
    assert g_parts == r_parts, what
    np.testing.assert_allclose(
        np.array(_NUMBER.findall(got), np.float64),
        np.array(_NUMBER.findall(ref), np.float64), rtol=1e-5, atol=1e-6,
        err_msg=what)


def _drive(pair, script):
    """Each line through both Repls; the printed text the same (the run's
    directory aside) and the states bit-equal after every line."""
    (jr, jdir), (tr, tdir) = pair
    for line in script:
        j_alive = jr.handle(line.format(d=jdir))
        t_alive = tr.handle(line.format(d=tdir))
        assert t_alive == j_alive, line
        _same_state(tr.s, jr.s, line)
        _same_text(tr.out.getvalue().replace(str(tdir), "D"),
                   jr.out.getvalue().replace(str(jdir), "D"), line)
    return tr.out.getvalue()


def test_repl_interactive_session_matches_jax(tmp_path):
    """tests/test_app.py:120: select, edit, focus, panels, save."""
    from treee_tpu.io import las

    pts = las.synthetic_forest(n_trees=4, points_per_tree=4000,
                               ground_points=4000, seed=3)
    pair = _repls(pts, tmp_path)
    script = [
        "status",
        "mode view",
        "click 96 54           # center-ish pixel: a tree",
        "info",
        "camera orbit 60",
        "rotate 30 10",
        "scroll 1.0",
        "mode delete",       # pixels below: trees of this view
        "drag 104 36",
        "mode spawn",
        "click 84 36",
        "mode draw",
        "click 104 48",
        "drag 104 40",
        "mode combine",
        "click 84 32",
        "click 100 32",
        "key w 2",
        "radius 2.5",
        "pointsize 0.2",
        "palette warm",
        "eyedome 0.5",
        "range 0 4294967295",
        "display shaded",
        "render {d}/f.png",
        "display classification",
        "overlay axis on",
        "render {d}/f.png",
        "save {d}/repl.npz",
        "status",
        "quit",
    ]
    text = _drive(pair, script)
    assert "error:" not in text, text
    for needed in ("selected segment", "deleted around", "spawned segment",
                   "draw target", "drew", "combined", "wrote", "saved"):
        assert needed in text, needed
    (jr, jdir), (tr, tdir) = pair
    assert tr.s.palette.device.type == "cpu"
    img = _decode_png((tdir / "f.png").read_bytes())
    assert img.shape == (108, 192, 3)
    saved_t, saved_j = _npz_arrays(tdir / "repl.npz"), _npz_arrays(
        jdir / "repl.npz")
    for k in saved_j:
        np.testing.assert_array_equal(saved_t[k], saved_j[k], err_msg=k)


def test_repl_bad_commands_keep_looping(tmp_path):
    """tests/test_app.py:199."""
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    _, tcfg = _configs()
    pts = las.synthetic_forest(n_trees=2, points_per_tree=2000,
                               ground_points=2000, seed=4)
    r = Repl(Session.from_points(pts, tcfg, device="cpu"), out=io.StringIO())
    assert r.handle("frobnicate 1 2") is True
    assert "error" in r.out.getvalue()
    assert r.handle("mode dance") is True
    assert r.handle("click notanumber 3") is True
    assert r.handle("") is True
    assert r.handle("# pure comment") is True


def test_repl_showdeleted_undelete_focus_and_lod_match_jax(tmp_path):
    """tests/test_app.py:230, :270 and :336 in one script: the deleted
    brush and its undo, the focused view's widgets, overlays and exports,
    and the LOD levels."""
    from treee_tpu.io import las

    pts = las.synthetic_forest(n_trees=2, points_per_tree=4000,
                               ground_points=3000, seed=21)
    pair = _repls(pts, tmp_path)
    script = [
        "mode delete",
        "drag 96 54",
        "showdeleted on",
        "mode view",
        "undelete 96 54",
        "showdeleted off",
        "status",
        "click 96 54",
        "hullinclude tree",
        "rbv slices 6",
        "rbv sectors 8",
        "rbv method mean",
        "rbv symmetric on",
        "axisalgo lowhigh",
        "overlay hull on",
        "overlay rbv on",
        "overlay axis on",
        "display height",
        "focusrender {d}/focus.png",
        "export ply {d}/seg.ply",
        "export crown {d}/crown.ply",
        "export inventory {d}/inv.csv",
        "traits",
        "classify trunk 96 54",
        "info",
        "lod level 4",
        "render {d}/lod.png",
        "lod adaptive",
        "lod off",
        "lod sideways",
        "camera fp",
        "key a 1",
        "camera orbit",
    ]
    text = _drive(pair, script)
    assert text.count("error:") == 1 and "lod takes" in text, text
    for needed in ("deleted around", "restored around", "selected segment",
                   "hull include: tree", "wrote", "ground_sep",
                   "classified trunk", "diameter_breast_height"):
        assert needed in text, needed
    (_, jdir), (tr, tdir) = pair
    assert tr.hull_include == "tree" and tr.axis_algo == "lowhigh"
    assert tr.rbv_opts == {"slices": 6, "sectors": 8, "method": "mean",
                           "symmetric": True}
    for name in ("seg.ply", "crown.ply"):
        assert _ply_rows(tdir / name) == _ply_rows(jdir / name)
    assert_inventory_csv_close(tdir / "inv.csv", jdir / "inv.csv")


def test_repl_lod_levels_and_adaptive():
    """tests/test_app.py:336: 'lod adaptive' / 'lod level N' build the
    subset and switch the frames to it."""
    from treee_tpu_torch.config import Config, RenderConfig, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=128, max_bands=16, max_segments=256,
        max_trees_per_band=32), render=RenderConfig(width=192, height=108))
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=2000, seed=13)
    s = Session.from_points(pts, cfg, device="cpu")
    r = Repl(s, out=io.StringIO())
    assert r.handle("lod level 4") is True and r.use_lod
    n_coarse = int(s._lod[2])
    assert r.handle("lod adaptive") is True and r.use_lod
    n_fine = int(s._lod[2])
    assert n_fine > n_coarse
    assert r.handle("lod off") is True and not r.use_lod
    assert r.handle("lod sideways") is True
    assert "error" in r.out.getvalue()


def test_repl_adaptive_lod_rebuilds_after_camera_motion(tmp_path):
    """tests/test_app.py:465: after any camera motion the next render
    rebuilds the view-dependent adaptive subset, and only then."""
    from treee_tpu_torch.config import Config, RenderConfig, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=128, max_bands=16, max_segments=256,
        max_trees_per_band=32), render=RenderConfig(width=96, height=54))
    pts = las.synthetic_forest(n_trees=2, points_per_tree=2000,
                               ground_points=2000, seed=7)
    s = Session.from_points(pts, cfg, device="cpu")
    s.segment(0.75)
    calls = []
    orig = s.build_lod

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    s.build_lod = spy
    r = Repl(s, out=io.StringIO())
    png = str(tmp_path / "f.png")
    assert r.handle("lod adaptive 2.0") and len(calls) == 1
    assert r.handle(f"render {png}") and len(calls) == 1
    assert r.handle("rotate 90 0")
    assert r.handle(f"render {png}") and len(calls) == 2
    assert calls[-1]["adaptive_tau_px"] == 2.0
    assert r.handle(f"render {png}") and len(calls) == 2
    assert r.handle("event down left 10 10") and r.handle("event move 40 10")
    assert r._lod_dirty
    assert r.handle("event up left 40 10")
    assert r.handle(f"render {png}") and len(calls) == 3
    assert "error:" not in r.out.getvalue(), r.out.getvalue()


def test_repl_auto_view_takes_the_adaptive_cut_above_the_threshold(
        monkeypatch):
    """The auto view path: full below AUTO_ADAPTIVE_MIN_POINTS live points,
    the auto-tau adaptive cut (solve_adaptive_tau at half the points, then
    build_lod) above; an explicit lod command wins for good."""
    import treee_tpu_torch.repl as repl_mod
    from treee_tpu_torch.config import Config, RenderConfig, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=64, max_bands=16, max_segments=64,
        max_trees_per_band=32), render=RenderConfig(width=96, height=54))
    s = Session.from_points(las.synthetic_forest(
        n_trees=2, points_per_tree=2000, ground_points=1000, seed=5), cfg,
        device="cpu")
    s.segment(0.75)
    r = repl_mod.Repl(s, out=io.StringIO())
    r.prepare_frame()
    assert r.view_path == "full" and not r.use_lod
    monkeypatch.setattr(repl_mod, "AUTO_ADAPTIVE_MIN_POINTS", 1000)
    r._reset_view_path()
    r.prepare_frame()
    assert r.use_lod and r.view_path.startswith("adaptive(tau=")
    assert s._lod is not None
    assert r.handle("lod off") and r.view_path == "full"
    r.prepare_frame()
    assert not r.use_lod


def test_repl_attribute_display(tmp_path):
    """tests/test_app.py:512: source-attribute displays; an attribute the
    scan lacks errors without changing the display."""
    from tests.test_las import _attr_records
    from treee_tpu_torch.config import Config, RenderConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    rng = np.random.default_rng(35)
    n = 600
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    rec, _ = _attr_records(rng, n, 2)  # legacy + rgb, no gps
    src = str(tmp_path / "rgb.las")
    las.write_las(src, pos, point_format=2, records=rec)
    s = Session.from_las(src, Config(render=RenderConfig(width=96, height=64)),
                         device="cpu")
    r = Repl(s, out=io.StringIO())
    png = str(tmp_path / "f.png")
    assert r.handle("display intensity") and r.handle(f"render {png}")
    assert r.display == "intensity"
    assert r.handle("display rgb") and r.handle(f"render {png}")
    assert r.handle("display gps_time")
    assert "error" in r.out.getvalue()
    assert r.display == "rgb"
    assert _decode_png(open(png, "rb").read()).shape == (64, 96, 3)


def test_repl_open_compare_and_camera_stay_on_the_session_device(tmp_path):
    """``open``, ``compare`` and ``camera orbit`` build their session and
    camera on the session's device (here the CPU), never on the default
    card."""
    from treee_tpu_torch.config import Config, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=64, max_bands=16, max_segments=64, max_trees_per_band=32))
    s = Session.from_points(las.synthetic_forest(
        n_trees=2, points_per_tree=1500, ground_points=1000, seed=8), cfg,
        device="cpu")
    s.segment(0.75)
    ckpt = str(tmp_path / "a.npz")
    s.save(ckpt)
    r = Repl(s, out=io.StringIO())
    pushed = []
    r.preview_hook = pushed.append
    for line in ("camera orbit 50", f"compare {ckpt}", f"open {ckpt}",
                 "palette white", "status"):
        assert r.handle(line) is True
    text = r.out.getvalue()
    assert "error:" not in text, text
    assert '"matched"' in text and "opened" in text
    assert r.s is not s and r.s.device.type == "cpu"
    assert s.camera.device.type == "cpu" and r.s.palette.device.type == "cpu"
    assert len(pushed) == 1 and pushed[0].dtype == np.uint8


def test_build_lod_capacity_tracks_subset_size():
    """tests/test_app.py:439 (:380, the curvature routing after combine(),
    is tests/test_torch_focus.py's): build_lod(capacity=None) sizes the
    padded subset from the true mask count and truncates nothing."""
    from treee_tpu_torch.config import Config, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.ops import octree
    from treee_tpu_torch.pipeline import Session

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=128, max_bands=16, max_segments=256, max_trees_per_band=32))
    pts = las.synthetic_forest(n_trees=2, points_per_tree=3000,
                               ground_points=3000, seed=6)
    s = Session.from_points(pts, cfg, device="cpu")
    s.segment(0.75)
    # the finest level with a huge quota a node: every live point survives
    s.build_lod(level=10, points_per_node=1 << 20)
    _, idx, count = s._lod
    live = int((s.cloud.valid & (s.cloud.segment != 0)).sum())
    assert int(count) == live
    assert idx.shape[0] >= live
    assert idx.shape[0] == min(s.cloud.capacity, octree.snug_capacity(live))
