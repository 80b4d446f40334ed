"""The port's input controller (``treee_tpu_torch/input.py``) against the JAX
package's on the CPU.

``input.py`` holds no JAX: the port's copy is the JAX package's file byte
for byte (its relative import of ``Camera`` resolves to the port's camera).
The cases of ``tests/test_input.py`` run on the port's cameras, and one
event stream fed to both controllers must give the same camera.

Tolerance, and why: the cameras' ``transform`` and ``offset`` within rtol
1e-6 (atol 1e-6 of the largest entry), as ``tests/test_torch_render.py``'s
``test_camera_matches_jax`` holds the camera moves: the 4x4 products are
summed in another order.
"""

import io
import os
import time

import numpy as np
import pytest

from treee_tpu.input import InputController as JController
from treee_tpu.render.camera import Camera as JCamera
from treee_tpu_torch.input import InputController, Keyboard, Mouse
from treee_tpu_torch.render.camera import Camera

import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cam(distance: float) -> Camera:
    return Camera.orbital(distance=distance, device="cpu")


def _close(got, ref, rtol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def test_input_is_a_byte_equal_copy():
    """The port's input.py is the JAX package's, byte for byte: its one
    import, ``from .render.camera import Camera``, is relative and so names
    the port's camera."""
    with open(os.path.join(REPO, "treee_tpu", "input.py"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "treee_tpu_torch", "input.py"), "rb") as f:
        got = f.read()
    assert got == ref
    assert b"from .render.camera import Camera\n" in got
    assert b"jax" not in got


# ---- the cases of tests/test_input.py on the port -----------------------------------

def test_keyboard_mouse_state():
    kb = Keyboard()
    kb.update("W", True)
    assert kb.pressed("w") and not kb.pressed("a")
    kb.update("w", False)
    assert not kb.pressed("w")

    m = Mouse()
    m.update("left", True)
    assert m.pressed("LEFT")
    np.testing.assert_allclose(m.delta((3.0, 4.0)), [3.0, 4.0])
    np.testing.assert_allclose(m.delta((3.0, 4.0)), [0.0, 0.0])


def test_wasd_moves_camera_orbital():
    c = InputController(_cam(10.0))
    p0 = c.camera.position.numpy()
    c.key("w", True)
    c.tick(0.1)
    p1 = c.camera.position.numpy()
    assert np.linalg.norm(p1 - p0) > 0.1  # scaled by offset
    # normalized diagonals: w+d moves by the same distance as w
    c2 = InputController(_cam(10.0))
    c2.key("w", True)
    c2.key("d", True)
    c2.tick(0.1)
    np.testing.assert_allclose(
        np.linalg.norm(c2.camera.position.numpy() - p0),
        np.linalg.norm(p1 - p0), rtol=1e-5)


def test_vertical_and_scroll():
    c = InputController(_cam(10.0))
    y0 = float(c.camera.position[1])
    c.key("e", True)
    c.tick(0.5)
    assert float(c.camera.position[1]) > y0
    c.scroll(1.0)  # zoom out: offset grows 10%
    np.testing.assert_allclose(float(c.camera.offset), 11.0, rtol=1e-5)


def test_left_drag_rotates_click_selects():
    clicks = []
    c = InputController(_cam(10.0),
                        on_click=lambda x, y: clicks.append((x, y)))
    t0 = c.camera.transform.numpy()
    # drag: press, move far, release -> rotate, no click
    c.mouse_move(100.0, 100.0)
    c.mouse_button("left", True)
    c.mouse_move(160.0, 100.0)
    c.mouse_button("left", False)
    assert not clicks
    assert np.abs(c.camera.transform.numpy() - t0).max() > 1e-4
    # click: press, tiny move, release -> select fires
    c.mouse_button("left", True)
    c.mouse_move(160.5, 100.0)
    c.mouse_button("left", False)
    assert len(clicks) == 1


def test_first_person_controller():
    cam = _cam(5.0)
    # scroll changes sensitivity only, pose unchanged
    c2 = cam.scroll_first_person(1.0)
    np.testing.assert_allclose(float(c2.offset), 5.5, rtol=1e-6)
    np.testing.assert_allclose(c2.transform.numpy(), cam.transform.numpy())
    # movement translates in the local xz plane
    moved = cam.move_first_person(1.0, 0.0)
    np.testing.assert_allclose(moved.position.numpy(),
                               cam.position.numpy() + [5.0, 0.0, 0.0],
                               atol=1e-5)
    # rotation preserves the camera position (yaw through own origin)
    rot = cam.rotate_first_person(50.0, 20.0)
    np.testing.assert_allclose(rot.position.numpy(), cam.position.numpy(),
                               atol=1e-4)
    # rotation matrix stays orthonormal
    r = rot.transform.numpy()[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_input_controller_first_person_drag():
    c = InputController(_cam(5.0), mode="first_person")
    p0 = c.camera.position.numpy()
    c.mouse_move(10.0, 10.0)
    c.mouse_button("left", True)
    c.mouse_move(80.0, 10.0)
    assert np.allclose(c.camera.position.numpy(), p0, atol=1e-4)
    t = c.camera.transform.numpy()[:3, :3]
    assert np.abs(t - np.eye(3)).max() > 1e-3  # actually rotated


def test_repl_event_commands_drive_controller():
    """`event ...` commands (what the browser page posts) fold through the
    shared InputController: a sub-2px click selects, a left-drag rotates, a
    right-drag brushes, held WASD moves."""
    from treee_tpu_torch.config import Config, SegmentationConfig
    from treee_tpu_torch.io import las
    from treee_tpu_torch.pipeline import Session
    from treee_tpu_torch.repl import Repl

    cfg = Config(segmentation=SegmentationConfig(
        grid_size=128, max_bands=16, max_segments=256,
        max_trees_per_band=32))
    pts = las.synthetic_forest(n_trees=4, points_per_tree=4000,
                               ground_points=4000, seed=3)
    s = Session.from_points(pts, cfg, device="cpu")
    s.segment(0.75)
    r = Repl(s, out=io.StringIO())
    w, h = s.config.render.width, s.config.render.height

    # sub-2px left click at the frame center -> ray select (view mode)
    assert r.handle(f"event down left {w/2} {h/2}")
    assert r.handle(f"event up left {w/2} {h/2}")
    assert r.selected is not None

    # left-drag -> orbital rotate (camera changes), and NOT a click
    sel_before = r.selected
    t_before = s.camera.transform.numpy().copy()
    assert r.handle("event down left 10 10")
    assert r.handle("event move 60 10")
    assert r.handle("event up left 60 10")
    assert np.abs(s.camera.transform.numpy() - t_before).max() > 1e-4
    assert r.selected == sel_before  # drag did not re-select

    # right-drag in delete mode -> brush edit through on_drag
    n_before = int((s.cloud.valid & (s.cloud.segment != 0)).sum())
    assert r.handle("mode delete")
    assert r.handle(f"event down right {w/2} {h/2}")
    assert r.handle(f"event up right {w/2} {h/2}")
    n_after = int((s.cloud.valid & (s.cloud.segment != 0)).sum())
    assert n_after < n_before  # the brush deleted points under the cursor

    # held 'w' + elapsed time -> forward movement via tick
    pos_before = s.camera.position.numpy().copy()
    assert r.handle("event key w 1")
    time.sleep(0.03)
    assert r.handle("event move 60 10")  # any event ticks held keys
    assert r.handle("event key w 0")
    assert np.abs(s.camera.position.numpy() - pos_before).max() > 1e-5
    assert "error:" not in r.out.getvalue(), r.out.getvalue()


# ---- one event stream through both controllers --------------------------------------

# (method, args): mouse drags in both modes, clicks, scrolls, held keys with
# fixed ticks (no clock), in the order a browser page would send them
EVENTS = (
    ("mouse_move", (100.0, 80.0)),
    ("mouse_button", ("left", True)),
    ("mouse_move", (140.0, 95.0)),
    ("mouse_move", (171.5, 60.25)),
    ("mouse_button", ("left", False)),
    ("scroll", (-2.0,)),
    ("key", ("w", True)),
    ("key", ("d", True)),
    ("tick", (0.05,)),
    ("key", ("w", False)),
    ("key", ("e", True)),
    ("tick", (0.033,)),
    ("key", ("d", False)),
    ("key", ("e", False)),
    ("mouse_button", ("left", True, 20.0, 30.0)),
    ("mouse_move", (20.5, 30.5)),
    ("mouse_button", ("left", False)),
    ("key", ("q", True)),
    ("tick", (0.1,)),
    ("key", ("q", False)),
    ("mouse_button", ("right", True, 50.0, 50.0)),
    ("mouse_move", (55.0, 52.0)),
    ("mouse_button", ("right", False)),
    ("scroll", (1.5,)),
)


@pytest.mark.parametrize("mode", ["orbital", "first_person"])
@pytest.mark.parametrize("rotate_scale", [1.0, 4.0])
def test_event_stream_gives_the_jax_camera(mode, rotate_scale):
    got_events, ref_events = [], []
    jc = JController(JCamera.orbital(distance=37.5), mode=mode,
                     rotate_scale=rotate_scale,
                     on_click=lambda x, y: ref_events.append(("click", x, y)),
                     on_drag=lambda x, y: ref_events.append(("drag", x, y)))
    tc = InputController(_cam(37.5), mode=mode, rotate_scale=rotate_scale,
                         on_click=lambda x, y: got_events.append(("click", x, y)),
                         on_drag=lambda x, y: got_events.append(("drag", x, y)))
    for name, args in EVENTS:
        getattr(jc, name)(*args)
        getattr(tc, name)(*args)
        _close(tc.camera.transform, jc.camera.transform)
        _close(tc.camera.offset, jc.camera.offset)
    assert got_events == ref_events
    assert [e[0] for e in got_events] == ["click", "drag", "drag"]
    np.testing.assert_array_equal(tc.mouse.position, jc.mouse.position)
