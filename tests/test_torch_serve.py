"""The port's browser-viewer server (``treee_tpu_torch/serve.py``) on the CPU:
the cases of ``tests/test_serve.py`` over a port session, real HTTP round
trips against a loopback server, and ``png_encode`` against the JAX
package's.

Tolerances: none.  ``png_encode`` gives the JAX package's bytes; the
served frames are the session's own ``render`` / ``render_focus`` frames
byte for byte (the render worker calls them).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_serve import _decode_png

import torch_threads

torch_threads.share_cores()


@pytest.mark.parametrize("shape", [(11, 7), (1, 1), (108, 192)])
def test_png_encode_matches_jax(shape):
    from treee_tpu.serve import png_encode as jpng
    from treee_tpu_torch.io.exports import png_encode

    img = np.random.default_rng(0).integers(0, 256, shape + (3,), np.uint8)
    got = png_encode(img)
    assert got == jpng(img)
    assert (_decode_png(got) == img).all()


def _config(grid=128, segments=256, width=192, height=108):
    from treee_tpu_torch.config import (
        CharacteristicsConfig, Config, RenderConfig, SegmentationConfig,
    )

    return Config(
        segmentation=SegmentationConfig(
            grid_size=grid, max_bands=16, max_segments=segments,
            max_trees_per_band=32),
        characteristics=CharacteristicsConfig(max_slices=96),
        render=RenderConfig(width=width, height=height),
    )


@pytest.fixture(scope="module")
def server():
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.serve import ViewerServer

    pts = las.synthetic_forest(n_trees=4, points_per_tree=4000,
                               ground_points=4000, seed=3)
    s = Session.from_points(pts, _config(), device="cpu")
    s.segment(0.75)
    v = ViewerServer(s, port=0)  # port 0: pick a free loopback port
    v.serve_background()
    yield v
    v.shutdown()
    assert not v._render_thread.is_alive()


def _get(server, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=60
        ) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _cmd(server, line):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/cmd", data=line.encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _settle(server, timeout=30.0):
    """Wait until the render worker has caught up with all requests."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with server._frame_cond:
            if server._req_gen == server._done_gen:
                return
        time.sleep(0.01)
    raise AssertionError("render worker never settled")


def test_serve_page_and_info(server):
    status, ctype, body = _get(server, "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"/frame.png" in body and b"/cmd" in body
    # the display dropdown offers only what this scan can show
    assert b"<option>classification</option>" in body
    assert b"<option>hag</option>" in body
    assert b"nir" not in body and b"intensity" not in body
    assert b"TPU" not in body

    status, ctype, body = _get(server, "/info")
    info = json.loads(body)
    assert info["points"] == 20000
    assert info["segments"] >= 1
    assert (info["width"], info["height"]) == (192, 108)

    status, _, _ = _get(server, "/nope")
    assert status == 404


def test_serve_frame_is_the_session_frame(server):
    """/frame.png and /frame.rgb are Session.render on the REPL's view path,
    byte for byte."""
    _settle(server)
    status, ctype, body = _get(server, "/frame.png")
    assert status == 200 and ctype == "image/png"
    img = _decode_png(body)
    assert img.shape == (108, 192, 3) and img.max() > 0
    _settle(server)
    status, ctype, raw = _get(server, "/frame.rgb")
    assert status == 200 and ctype == "application/octet-stream"
    r = server.repl
    with server.lock:
        ref = r.s.render(use_lod=r.use_lod, show_deleted=r.show_deleted)
    assert (img == ref).all()
    assert raw == ref.tobytes()


def test_serve_frame_and_commands(server):
    out = _cmd(server, "status")
    assert out["ok"] and "points" in out["output"] and not out["quit"]
    assert _cmd(server, "rotate 30 10")["ok"]
    assert _cmd(server, "mode delete")["ok"]
    out = _cmd(server, "click 96 54")
    assert out["ok"] and "error:" not in out["output"]

    # focused view: select something via the REPL, then fetch the focus frame
    _cmd(server, "mode view")
    sel = json.loads(_get(server, "/info")[2])["selected"]
    if sel is None:  # the click may have hit nothing; pick another pixel
        _cmd(server, "click 60 40")
    status, _, body = _get(server, "/frame.png?focus=1")
    # focus falls back to the plain frame when nothing is selected
    assert status == 200
    assert _decode_png(body).shape == (108, 192, 3)
    server.frame_png(focus=False)

    # bad commands surface as error text, never a dead server
    out = _cmd(server, "definitely-not-a-command")
    assert out["ok"] and "error:" in out["output"]
    status, _, _ = _get(server, "/frame.png")
    assert status == 200


def test_focused_view_is_render_focus(server):
    """A selected segment's focus frame is Session.render_focus's."""
    _settle(server)
    r = server.repl
    with server.lock:
        r.selected = 1
    png = server.frame_png(focus=True)
    with server.lock:
        ref = r.s.render_focus(1, display=r.display)
    assert (_decode_png(png) == ref).all()
    server.frame_png(focus=False)
    with server._frame_cond:
        assert not server._want_focus


# --- progressive previews --------------------------------------------------------

def test_preview_frame_before_segmentation():
    """Height-coloured imagery from a raw, never-segmented cloud."""
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session

    s = Session.from_points(
        las.synthetic_forest(n_trees=2, points_per_tree=2000,
                             ground_points=1000, seed=5),
        _config(grid=64, segments=64, width=128, height=96), device="cpu")
    img = s.preview_frame()
    assert img.shape == (96, 128, 3) and img.dtype == np.uint8
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 10


def test_segment_preview_callback_count():
    """segment(preview_cb=...) fires the callback exactly once with a
    segment-coloured subsample frame, before the full result lands."""
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session

    cfg = _config(grid=64, segments=64, width=128, height=96)
    s = Session.from_points(
        las.synthetic_forest(n_trees=3, points_per_tree=3000,
                             ground_points=1500, seed=6), cfg, device="cpu")
    got = []
    res = s.segment(0.75, preview_cb=got.append, preview_stride=8)
    assert len(got) == 1
    assert got[0].shape == (96, 128, 3) and got[0].dtype == np.uint8
    assert int(res.n_segments) > 0


def test_frame_png_serves_preview_while_locked(server):
    """While a command holds the session lock, /frame.png returns the
    pushed preview instead of blocking on the device."""
    server._push_preview(np.full((4, 4, 3), 99, np.uint8))
    preview = server._preview_png
    assert preview is not None
    server.lock.acquire()
    try:
        assert server.frame_png() == preview
    finally:
        server.lock.release()
    # unlocked again: a real frame renders and refreshes the cache
    real = server.frame_png()
    assert real != preview and server._last_png == real


def test_distance_command_pushes_preview(server):
    pushed = []
    orig = server._push_preview
    server.repl.preview_hook = lambda img: (pushed.append(1), orig(img))
    try:
        out = _cmd(server, "distance 0.75")
        assert out["ok"] and "segments:" in out["output"]
        assert pushed  # the hook fired mid-command
    finally:
        server.repl.preview_hook = orig


# --- frame pipelining --------------------------------------------------------------

def test_commands_decoupled_from_render_latency(server):
    """With an artificially slow renderer, a burst of drag-rotate commands
    returns at once and coalesces to ~1 render per render interval."""
    _settle(server)
    calls = []
    orig = server._frame_img_locked

    def slow(focus=False):
        calls.append(time.monotonic())
        time.sleep(0.2)
        return orig(focus)

    server._frame_img_locked = slow
    try:
        t0 = time.monotonic()
        for i in range(10):
            assert server.command(f"rotate {i + 1} 0")["ok"]
        cmd_elapsed = time.monotonic() - t0
        assert cmd_elapsed < 1.0, f"commands blocked on renders: {cmd_elapsed:.2f}s"
        _settle(server)
        assert 1 <= len(calls) <= 3, f"{len(calls)} renders for 10 commands"
    finally:
        server._frame_img_locked = orig
        _settle(server)


def test_raw_events_through_server(server):
    """A sub-2px down/up pair posted as raw events selects a segment
    end-to-end over HTTP."""
    _settle(server)
    _, _, body = _get(server, "/")
    assert b"event down" in body and b"event key" in body
    assert b"event wheel" in body
    w, h = server.repl.s.config.render.width, server.repl.s.config.render.height
    assert _cmd(server, "camera orbit")["ok"]
    assert _cmd(server, f"event down left {w / 2} {h / 2}")["ok"]
    assert _cmd(server, f"event up left {w / 2} {h / 2}")["ok"]
    _, _, body = _get(server, "/info")
    assert json.loads(body)["selected"] is not None


def test_adaptive_by_default_above_threshold(server, monkeypatch):
    """Sessions above the auto threshold serve the auto-tau adaptive path
    by default, /info carries the path and frame ms, and an explicit lod
    command overrides for good."""
    import treee_tpu_torch.repl as repl_mod

    monkeypatch.setattr(repl_mod, "AUTO_ADAPTIVE_MIN_POINTS", 1000)
    server.repl._auto_view = True
    server.repl._reset_view_path()
    assert _cmd(server, "focusview off")["ok"]
    server.request_render()
    _settle(server, timeout=600)
    status, _, _ = _get(server, "/frame.png")
    assert status == 200
    info = json.loads(_get(server, "/info")[2])
    assert info["view_path"].startswith("adaptive(tau="), info
    assert info["frame_ms"] is not None and info["frame_ms"] > 0
    assert info["lod"] is True

    assert _cmd(server, "lod off")["ok"]
    _get(server, "/frame.png")
    assert json.loads(_get(server, "/info")[2])["view_path"] == "full"


def test_full_path_below_threshold(server):
    _get(server, "/frame.png")
    info = json.loads(_get(server, "/info")[2])
    assert info["view_path"] == "full" and info["lod"] is False


def test_render_error_surfaces_after_first_frame(server):
    """A failing render after the first good frame surfaces on /info and as
    X-Render-Error on the stale /frame.png, and clears after a good one."""
    _settle(server)
    assert _get(server, "/frame.png")[0] == 200
    orig = server._frame_img_locked

    def boom(focus=False):
        raise RuntimeError("bad viewer state xyzzy")

    server._frame_img_locked = boom
    try:
        server.request_render()
        deadline = time.monotonic() + 10
        while server._last_error_msg is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server._last_error_msg and "xyzzy" in server._last_error_msg
        assert "xyzzy" in json.loads(_get(server, "/info")[2])["render_error"]
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/frame.png?wait=1&seq=0",
            timeout=60,
        ) as r:
            assert r.status == 200
            assert "xyzzy" in r.headers.get("X-Render-Error", "")
    finally:
        server._frame_img_locked = orig
    server.request_render()
    _settle(server)
    deadline = time.monotonic() + 10
    while server._last_error_msg is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert json.loads(_get(server, "/info")[2])["render_error"] is None


def test_frame_seq_advances_and_long_poll_returns(server):
    _settle(server)
    seq0 = server.frame_seq
    server.command("rotate 5 0")
    png, seq1 = server.frame_wait(seq0, timeout=30.0)
    assert seq1 > seq0 and png[:8] == b"\x89PNG\r\n\x1a\n"
    png2, seq2 = server.frame_wait(seq1, timeout=0.2)
    assert seq2 == seq1 and png2 == png


def test_frame_rgb_endpoint(server):
    server.command("rotate 1 0")
    _settle(server)
    status, ctype, body = _get(server, "/frame.rgb")
    assert status == 200 and ctype == "application/octet-stream"
    img, seq = server.frame_rgb()
    assert img is not None and len(body) == img.size
    assert img.shape == (108, 192, 3)


def test_focusview_command_switches_variant(server):
    _settle(server)
    assert server.command("focusview on")["ok"]
    _settle(server)
    with server._frame_cond:
        assert server._want_focus
    assert server.command("focusview off")["ok"]
    _settle(server)
    with server._frame_cond:
        assert not server._want_focus


def test_ingest_preview_streams_through_serve(server, tmp_path):
    """While a multi-slab scan decodes inside 'add', ingest previews publish
    (seq bumps) before the command completes."""
    from treee_tpu_torch.io import las

    pos = np.random.default_rng(9).uniform(-8, 8, (24_000, 3)).astype(
        np.float32)
    pos[:, 1] = np.abs(pos[:, 1])
    p = str(tmp_path / "s.las")
    las.write_las(p, pos)
    seqs_during = []
    orig = server._push_preview

    def spy(img):
        orig(img)
        seqs_during.append(server.frame_seq)

    server.repl.preview_hook = spy
    try:
        n0 = json.loads(_get(server, "/info")[2])["points"]
        out = _cmd(server, f"add {p}")
        assert out["ok"] and "error:" not in out["output"], out
        assert len(seqs_during) >= 2
        assert json.loads(_get(server, "/info")[2])["points"] == n0 + 24_000
    finally:
        server.repl.preview_hook = orig


def test_long_poll_does_not_reset_focusview(server):
    """The page's long-poll omits the focus param; it must not reset the
    focusview state the focusview command owns."""
    _settle(server)
    assert server.command("focusview on")["ok"]
    server.frame_wait(0, focus=None, timeout=0.1)
    with server._frame_cond:
        assert server._want_focus
    server.frame_png(focus=False)
    with server._frame_cond:
        assert not server._want_focus


def test_shutdown_ends_the_worker():
    """shutdown() returns and the render worker thread ends."""
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.serve import ViewerServer

    pts = np.random.default_rng(1).uniform(-5, 5, (500, 3)).astype(np.float32)
    v = ViewerServer(Session.from_points(pts, _config(grid=64, segments=64),
                                         device="cpu"), port=0)
    v.serve_background()
    assert _get(v, "/frame.png")[0] == 200
    v.shutdown()
    v._render_thread.join(timeout=10)
    assert not v._render_thread.is_alive()
