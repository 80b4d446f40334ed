"""The port's splat frame against the JAX package on the CPU, at small sizes.

Inputs come from numpy seeds and go through both packages; the port runs
its kernels' plain versions, since its tensors are on the CPU.

The reference for the rasterizer and the whole frame is the JAX function
run op by op (``jax.disable_jit()``).  Under ``jit``, XLA's CPU fusion
contracts ``p22 * vz + p23`` of the projection into an FMA, which rounds
z01 once instead of twice; near z01 = 1 one ulp of z01 is half a step of
the 23-bit depth quantum, so about a fifth of the covered pixels get a key
one depth step apart.  Op by op, every JAX op rounds as the port's torch op
does.  The jitted keys are held to that difference
(``test_rasterize_keys_matches_jit_within_one_depth_step``).

Tolerances, and why:

- camera matrices, planes and rays: rtol 1e-6 (4x4 products summed in
  another order than XLA's dot);
- palettes, ``prop_from_segment``: byte-equal;
- key images: equal on >= 99.9% of pixels (the view rotation is a 3-term
  dot that XLA may sum with FMAs, which can move a point across a pixel
  edge);
- dilation: bit-equal to the XLA scan fed the same raw key image, and to
  the Pallas kernel (interpret mode) where no source offset exceeds 7;
- eye-dome: bit-equal to the op-by-op JAX function, within 1e-4 of XLA's
  fused form and of the Pallas kernel (s = 0.3^6 divides m - lin, so an
  FMA's ulp in lin is amplified ~1,400x);
- u8 frames: within 1 per channel wherever the key images agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import pipeline as jpl
from treee_tpu.config import CharacteristicsConfig as JCC
from treee_tpu.config import Config as JConfig
from treee_tpu.config import RenderConfig as JRC
from treee_tpu.config import SegmentationConfig as JSC
from treee_tpu.io import las as jlas
from treee_tpu.ops import pallas_kernels as pk
from treee_tpu.render import Camera as JCamera
from treee_tpu.render import lines as jlines
from treee_tpu.render import palettes as jpal
from treee_tpu.render import splat as jsplat
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch.config import CharacteristicsConfig as TCC
from treee_tpu_torch.config import Config as TConfig
from treee_tpu_torch.config import RenderConfig as TRC
from treee_tpu_torch.config import SegmentationConfig as TSC
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops.kernels.dilate import dilate_scan
from treee_tpu_torch.render import Camera as TCamera
from treee_tpu_torch.render import lines as tlines
from treee_tpu_torch.render import palettes as tpal
from treee_tpu_torch.render import splat as tsplat

import torch_threads

torch_threads.share_cores()

IBIG = 0x7FFFFFFF
MIN_KEY_AGREEMENT = 0.999
SMALL = dict(width=128, height=96, point_size=0.5)
# an index palette: colour channel 0 is the key's palette byte
INDEX_PALETTE = np.stack([np.arange(256), np.zeros(256), np.zeros(256)],
                         -1).astype(np.float32)


def _close(got, ref, rtol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def _port_camera(jc):
    return TCamera.from_numpy(np.asarray(jc.transform), np.asarray(jc.offset),
                              jc.fov_y, jc.near, jc.far, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- camera -------------------------------------------------------------------

MOVES = {
    "orbital": lambda c: c,
    "rotate_orbital": lambda c: c.rotate_orbital(40.0, -25.0).rotate_orbital(-3.0, 7.0),
    "scroll_orbital": lambda c: c.scroll_orbital(-2.5).scroll_orbital(1.0),
    "move_orbital": lambda c: c.rotate_orbital(15.0, 5.0).move_orbital(0.3, -0.7),
    "move_vertical": lambda c: c.rotate_orbital(-90.0, 40.0).move_vertical(1.5),
    "move_first_person": lambda c: c.rotate_first_person(20.0, 0.0).move_first_person(-0.4, 0.9),
    "rotate_first_person": lambda c: c.rotate_first_person(-60.0, 30.0),
    "scroll_first_person": lambda c: c.scroll_first_person(3.0).move_first_person(1.0, 1.0),
}


@pytest.mark.parametrize("move", sorted(MOVES))
def test_camera_matches_jax(move):
    jc = MOVES[move](JCamera.orbital(distance=37.5))
    tc = MOVES[move](TCamera.orbital(distance=37.5, device="cpu"))
    assert tc.transform.dtype == torch.float32 and tc.offset.dtype == torch.float32
    _close(tc.transform, jc.transform)
    _close(tc.offset, jc.offset)
    _close(tc.position, jc.position)
    _close(tc.view_matrix(), jc.view_matrix())
    for aspect in (16 / 9, 4 / 3):
        np.testing.assert_array_equal(tc.projection_matrix(aspect).numpy(),
                                      np.asarray(jc.projection_matrix(aspect)))
        _close(tc.frustum_planes(aspect), jc.frustum_planes(aspect))
    for px, py in ((0.0, 0.0), (300.5, 100.25), (1279.0, 719.0)):
        _close(tc.ray_direction(px, py, 1280, 720),
               jc.ray_direction(px, py, 1280, 720))


def test_camera_state_round_trips_from_jax():
    jc = JCamera.orbital(distance=52.0).rotate_orbital(70.0, -20.0)
    tc = _port_camera(jc)
    np.testing.assert_array_equal(tc.transform.numpy(), np.asarray(jc.transform))
    assert tc.to_numpy()["offset"] == np.float32(jc.offset)
    back = TCamera.from_numpy(**tc.to_numpy(), device="cpu")
    assert torch.equal(back.transform, tc.transform)
    assert torch.equal(back.offset, tc.offset)
    assert (back.fov_y, back.near, back.far) == (jc.fov_y, jc.near, jc.far)
    with pytest.raises(ValueError):
        TCamera.from_numpy(np.eye(3), 1.0, device="cpu")
    with pytest.raises(dataclasses.FrozenInstanceError):
        tc.near = 1.0


# ---- palettes and the segment hash ----------------------------------------------

@pytest.mark.parametrize("name,size", [("turbo", 256), ("warm", 256),
                                       ("white", 256), ("turbo", 17),
                                       ("warm", 5)])
def test_palettes_are_byte_equal(name, size):
    got = tpal.get(name, size, device="cpu")
    ref = np.asarray(jpal.get(name, size))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.numpy().tobytes() == ref.tobytes()


def test_rgb_cube_sample_and_unknown_palette():
    assert tpal.rgb_cube(device="cpu").numpy().tobytes() == np.asarray(jpal.rgb_cube()).tobytes()
    t = np.linspace(-0.5, 1.5, 101).astype(np.float32)
    pal = tpal.turbo(device="cpu")
    np.testing.assert_array_equal(
        tpal.sample(pal, _t(t)).numpy(),
        np.asarray(jpal.sample(jpal.turbo(), jnp.asarray(t))))
    with pytest.raises(ValueError, match="palette"):
        tpal.get("viridis", device="cpu")


def test_prop_from_segment_is_bit_equal():
    ids = np.concatenate([np.arange(4097), [2**31 - 1, 123456789, 65537]]
                         ).astype(np.int32)
    got = tsplat.prop_from_segment(_t(ids))
    ref = np.asarray(jsplat.prop_from_segment(jnp.asarray(ids)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == ref.tobytes()


# ---- rasterizer -------------------------------------------------------------------

def _padded(pts):
    n = len(pts)
    cap = max(1024, -(-n // 1024) * 1024)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = pts
    return pos, np.arange(cap) < n


SMALL_SEG = dict(grid_size=128, max_bands=32, cc_occupied_cap=1 << 14)
SMALL_CH = dict(max_slices=64)


def _render_scene():
    """tests/test_render.py's forest, seven hashed colours."""
    pts = jlas.synthetic_forest(n_trees=4, points_per_tree=3000,
                                ground_points=3000)
    prop = np.asarray(jsplat.prop_from_segment(jnp.arange(len(pts)) % 7 + 1))
    return pts, prop, np.ones(len(pts), bool)


def _segmented_scene():
    """A small synthetic forest, segmented by the JAX package: segment
    colours, deleted (unassigned) points masked out."""
    pts = jlas.synthetic_forest(n_trees=6, points_per_tree=400,
                                ground_points=400, seed=3)
    pos, valid = _padded(pts)
    cfg = JConfig(segmentation=JSC(**SMALL_SEG, use_pallas_cc=True,
                                   use_pallas_match=True),
                  characteristics=JCC(**SMALL_CH))
    seg, _, _, _ = jpl.full_pipeline(jnp.asarray(pos), jnp.asarray(valid),
                                     0.75, cfg)
    seg = np.asarray(seg)
    prop = np.asarray(jsplat.prop_from_segment(jnp.asarray(seg)))
    return pos, prop, valid & (seg != 0)


RASTER_SCENES = {"render": _render_scene, "segmented": _segmented_scene}
RASTER_CAMERAS = {
    "far": lambda: JCamera.orbital(distance=60.0),
    "rotated": lambda: JCamera.orbital(distance=45.0).rotate_orbital(40.0, -90.0),
    "near": lambda: JCamera.orbital(distance=20.0).rotate_orbital(130.0, 30.0),
}


@pytest.fixture(scope="module", params=sorted(RASTER_SCENES))
def raster_scene(request):
    return RASTER_SCENES[request.param]()


@pytest.mark.parametrize("cam", sorted(RASTER_CAMERAS))
def test_rasterize_keys_matches_jax(raster_scene, cam):
    pos, prop, mask = raster_scene
    jc = RASTER_CAMERAS[cam]()
    with jax.disable_jit():
        ref = np.asarray(jsplat.rasterize_keys(
            jnp.asarray(pos), jnp.asarray(prop), jnp.asarray(mask), jc,
            JRC(**SMALL)))
    got = tsplat.rasterize_keys(_t(pos), _t(prop), _t(mask), _port_camera(jc),
                                TRC(**SMALL))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert (ref != IBIG).sum() > 100
    share = float((got.numpy() == ref).mean())
    print(f"rasterize_keys {cam}: {share:.6f} of pixels equal")
    assert share >= MIN_KEY_AGREEMENT


def test_rasterize_keys_matches_jit_within_one_depth_step(raster_scene):
    pos, prop, mask = raster_scene
    jc = RASTER_CAMERAS["rotated"]()
    rk = jax.jit(jsplat.rasterize_keys, static_argnames=("cfg",))
    ref = np.asarray(rk(jnp.asarray(pos), jnp.asarray(prop), jnp.asarray(mask),
                        jc, cfg=JRC(**SMALL)))
    got = tsplat.rasterize_keys(_t(pos), _t(prop), _t(mask), _port_camera(jc),
                                TRC(**SMALL)).numpy()
    hit = (got != IBIG) & (ref != IBIG)
    one_step = hit & ((got & 255) == (ref & 255)) & (
        np.abs((got >> 8) - (ref >> 8)) <= 1)
    share = float(((got == ref) | one_step).mean())
    print(f"jit: {float((got == ref).mean()):.6f} equal, {share:.6f} within "
          "one depth step")
    assert share >= MIN_KEY_AGREEMENT


def test_rasterize_keys_filters():
    """Behind the camera, masked, outside the property range, off screen."""
    pos = np.array([[0, 0, 0], [0, 0, 20], [0.5, 0, 0], [0, 0.5, 0],
                    [500, 0, 0]], np.float32)
    prop = np.array([0.5, 0.5, 0.5, 0.9, 0.5], np.float32)
    mask = np.array([True, True, False, True, True])
    cam = JCamera.orbital(distance=10.0)
    cfg = dict(SMALL, prop_max=int(0.8 * 0xFFFFFFFF))
    ref = np.asarray(jsplat.rasterize_keys(jnp.asarray(pos), jnp.asarray(prop),
                                           jnp.asarray(mask), cam, JRC(**cfg)))
    got = tsplat.rasterize_keys(_t(pos), _t(prop), _t(mask), _port_camera(cam),
                                TRC(**cfg)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != IBIG).sum() == 1


# ---- dilation -----------------------------------------------------------------------

def _dilation_input(near: bool):
    """A 48x64 raw key image from the JAX rasterizer: 300 far points, and
    with ``near`` 40 more at 0.3-3 m whose splats span up to ~19 px."""
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(300, 3)).astype(np.float32) * 5.0
    if near:
        d = rng.uniform(0.3, 3.0, 40)
        xy = rng.uniform(-0.45, 0.45, (40, 2)) * d[:, None]
        near_pts = np.stack([xy[:, 0] * 1.3, xy[:, 1], 10.0 - d], -1)
        pos = np.concatenate([pos, near_pts.astype(np.float32)])
    prop = rng.random(len(pos)).astype(np.float32)
    cam = JCamera.orbital(distance=10.0)
    cfg = JRC(width=64, height=48)
    kimg = np.asarray(jsplat.rasterize_keys(
        jnp.asarray(pos), jnp.asarray(prop), jnp.ones(len(pos), bool), cam, cfg))
    return kimg, cam


@pytest.mark.parametrize("near", [False, True], ids=["far", "near"])
@pytest.mark.parametrize("radius", [1, 3, 7])
def test_dilate_plain_matches_xla_scan(near, radius):
    kimg, jc = _dilation_input(near)
    tc = _port_camera(jc)
    cfg = dict(width=64, height=48, max_splat_radius=radius)
    # the XLA scan's dilated keys, read back through an index palette
    # (channel 0 = palette byte) and z01 (= depth quantum * f32 scale)
    jcol, jz, jhit = jsplat.resolve_keys(jnp.asarray(kimg), jc,
                                         jnp.asarray(INDEX_PALETTE), JRC(**cfg))
    tcol, tz, thit = tsplat.resolve_keys(_t(kimg), tc, _t(INDEX_PALETTE),
                                         TRC(**cfg))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    params = tsplat.dilate_params(tc, TRC(**cfg))
    keys, sdx, sdy = dilate_scan(_t(kimg), radius, *params)
    assert torch.equal(keys, kernels.dilate(_t(kimg), radius, *params))
    assert int((keys != IBIG).sum()) > int((kimg != IBIG).sum())
    max_off = float(torch.maximum(sdx.abs(), sdy.abs()).max())
    if near and radius >= 3:
        assert max_off > 7  # beyond the Pallas kernel's 4-bit fields
    if max_off <= 7:
        ref = np.asarray(pk.dilate_pallas(jnp.asarray(kimg), *params,
                                          radius=radius, interpret=True))
        np.testing.assert_array_equal(keys.numpy(), ref)


# ---- eye-dome -----------------------------------------------------------------------

def _eye_dome_inputs(far: bool = False, h=48, w=64, seed=2):
    """tests/test_pallas.py's inputs; with ``far`` the top quarter holds
    depths in [0.999, 0.9999], where the linearization is steepest."""
    rng = np.random.default_rng(seed)
    z01 = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    z01[rng.uniform(size=(h, w)) < 0.3] = 1.0  # background holes
    if far:
        z01[: h // 4] = rng.uniform(0.9990, 0.9999, (h // 4, w))
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return color, z01


@pytest.mark.parametrize("far", [False, True], ids=["uniform", "far"])
@pytest.mark.parametrize("strength,ed", [(0.7, (0.0, 0.0, 0.0)),
                                         (0.5, (0.2, 0.4, 0.9))])
def test_eye_dome_plain_matches_jax(far, strength, ed):
    """Bit-equal to the JAX function op by op.  XLA's fused form and the
    Pallas kernel contract ``d * (f - n)`` into ``(f + n) - ...`` with an
    FMA: within 1e-4 of them on tests/test_pallas.py's depths, and within
    1e-2 where z01 > 0.999, since there one ulp of the linearization's
    denominator is ~1e-3 of it and s divides the excess."""
    color, z01 = _eye_dome_inputs(far)
    jcfg = JRC(width=64, height=48, eye_dome_strength=strength,
               eye_dome_color=ed)
    tcfg = TRC(width=64, height=48, eye_dome_strength=strength,
               eye_dome_color=ed)
    got = tsplat.eye_dome(_t(color), _t(z01), tcfg).numpy()
    with jax.disable_jit():
        ref = np.asarray(jsplat.eye_dome(jnp.asarray(color), jnp.asarray(z01),
                                         jcfg))
    np.testing.assert_array_equal(got, ref)
    fused = np.asarray(jax.jit(jsplat.eye_dome, static_argnames=("cfg",))(
        jnp.asarray(color), jnp.asarray(z01), cfg=jcfg))
    s = max(1.0 - strength, 0.1) ** 6
    pallas = np.asarray(pk.eye_dome_pallas(
        jnp.asarray(color), jnp.asarray(z01), jcfg.near, jcfg.far, s, ed,
        interpret=True))
    for other in (fused, pallas):
        np.testing.assert_allclose(got, other, rtol=0,
                                   atol=1e-2 if far else 1e-4)
    assert (np.abs(got - color).max(-1) > 1e-3).mean() > 0.1  # it darkens


# ---- lines --------------------------------------------------------------------------

def test_sample_lines_matches_jax():
    """Sample parameters equal XLA's linspace; the points within an ulp of
    the endpoints' size (XLA fuses a + (b - a) * t into an FMA)."""
    rng = np.random.default_rng(6)
    ends = rng.normal(size=(5, 2, 3)).astype(np.float32) * 10
    for samples in (1, 2, 32, 33):
        got = tlines.sample_lines(_t(ends), samples).numpy()
        ref = np.asarray(jlines.sample_lines(jnp.asarray(ends), samples))
        assert got.shape == ref.shape == (5 * samples, 3)
        _close(got, ref, rtol=2e-7 * 30)
    unit = np.array([[[0, 0, 0], [1, 1, 1]]], np.float32)
    np.testing.assert_array_equal(
        tlines.sample_lines(_t(unit), 32).numpy(),
        np.asarray(jlines.sample_lines(jnp.asarray(unit), 32)))


def test_overlay_matches_jax():
    pts, prop, mask = _render_scene()
    jc = JCamera.orbital(distance=40.0).rotate_orbital(25.0, -60.0)
    tc = _port_camera(jc)
    color, z01, _ = tsplat.render_points(_t(pts), _t(prop), _t(mask), tc,
                                         tpal.turbo(device="cpu"), TRC(**SMALL))
    rng = np.random.default_rng(7)
    ends = rng.uniform(-15, 15, (12, 2, 3)).astype(np.float32)
    ends[..., 1] += 12
    ends[0] = [[0, 0, 0], [0, 0, 200]]  # crosses the near plane
    args = (jnp.asarray(color.numpy()), jnp.asarray(z01.numpy()),
            jnp.asarray(ends), jc, JRC(**SMALL))
    got = tlines.overlay(color, z01, _t(ends), tc, TRC(**SMALL),
                         line_color=(1.0, 0.0, 1.0)).numpy()
    with jax.disable_jit():
        ref = np.asarray(jlines.overlay(*args, line_color=(1.0, 0.0, 1.0)))
    painted = (ref == [1.0, 0.0, 1.0]).all(-1)
    assert 100 < painted.sum() < painted.size // 4
    np.testing.assert_array_equal(got, ref)
    fused = np.asarray(jlines.overlay(*args, line_color=(1.0, 0.0, 1.0)))
    assert (got == fused).all(-1).mean() >= MIN_KEY_AGREEMENT


# ---- the frame through the Session --------------------------------------------------

FRAME = dict(width=160, height=120)
SESSION_SCENES = {
    "forest": lambda: jlas.synthetic_forest(
        n_trees=6, points_per_tree=400, ground_points=400, seed=3),
    "realistic": lambda: jlas.synthetic_forest_realistic(
        n_trees=10, extent=40.0, mean_points_per_tree=1500,
        ground_points=5000, seed=1),
}


def _within_one_where_keys_agree(got, ref, kgot, kref, radius):
    """u8 frames within 1 per channel away from the pixels whose raw keys
    differ (and the splats those could grow into); returns the share of
    raw keys that agree."""
    bad = torch.from_numpy(kgot != kref)[None, None].float()
    bad = torch.nn.functional.max_pool2d(bad, 2 * radius + 3, 1, radius + 1)
    near_bad = bad[0, 0].numpy() > 0
    diff = np.abs(got.astype(int) - ref.astype(int)).max(-1)
    assert diff[~near_bad].max(initial=0) <= 1
    return float((kgot == kref).mean())


@pytest.fixture(scope="module", params=sorted(SESSION_SCENES))
def sessions(request):
    pts = SESSION_SCENES[request.param]()
    jcfg = JConfig(segmentation=JSC(**SMALL_SEG, use_pallas_cc=True,
                                    use_pallas_match=True),
                   characteristics=JCC(**SMALL_CH), render=JRC(**FRAME))
    tcfg = TConfig(segmentation=TSC(**SMALL_SEG),
                   characteristics=TCC(**SMALL_CH), render=TRC(**FRAME))
    js = jpl.Session.from_points(pts, jcfg)
    ts = tpl.Session.from_points(pts, tcfg, device="cpu")
    # segmented once for every test of the scene: each view reads the same
    # ids (preview_frame draws the raw cloud)
    js.segment(0.75)
    ts.segment(0.75)
    return js, ts


def _raw_keys(js, ts, jc, tc, show_deleted):
    """Both sessions' raw key images of the frame ``render`` draws."""
    with jax.disable_jit():
        seg = js.cloud.segment
        mask = js.cloud.valid & ((seg != 0) | show_deleted)
        kref = np.asarray(jsplat.rasterize_keys(
            js.cloud.pos, jsplat.prop_from_segment(seg), mask, jc,
            js.config.render))
    seg = ts.cloud.segment
    mask = ts.cloud.valid & ((seg != 0) | show_deleted)
    kgot = tsplat.rasterize_keys(ts.cloud.pos, tsplat.prop_from_segment(seg),
                                 mask, tc, ts.config.render).numpy()
    return kgot, kref


@pytest.mark.parametrize("view", ["rotated", "default_show_deleted"])
def test_session_render_matches_jax(sessions, view):
    js, ts = sessions
    np.testing.assert_array_equal(ts.cloud.segment.numpy(),
                                  np.asarray(js.cloud.segment))
    show_deleted = view == "default_show_deleted"
    jc = (js.camera if show_deleted else
          JCamera.orbital(distance=70.0).rotate_orbital(40.0, -60.0))
    tc = _port_camera(jc)
    kernels.reset_launches()
    got = ts.render(tc, show_deleted=show_deleted)
    assert sum(kernels.launches().values()) == 0  # CPU tensors: plain only
    with jax.disable_jit():
        ref = js.render(jc, show_deleted=show_deleted)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (120, 160, 3)
    kgot, kref = _raw_keys(js, ts, jc, tc, show_deleted)
    assert (kref != IBIG).mean() > 0.01
    share = _within_one_where_keys_agree(got, ref, kgot, kref,
                                         ts.config.render.max_splat_radius)
    print(f"render {view}: raw keys agree on {share:.6f} of pixels")
    assert share >= MIN_KEY_AGREEMENT


FRAME_BG = np.round(np.array(TRC().background) * 255.0).astype(int)


def test_preview_frame_matches_jax(sessions):
    js, ts = sessions
    jc = JCamera.orbital(distance=60.0).rotate_orbital(-30.0, -40.0)
    with jax.disable_jit():
        ref = js.preview_frame(jc)
    got = ts.preview_frame(_port_camera(jc))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int)).max(-1)
    assert (diff <= 1).mean() >= MIN_KEY_AGREEMENT
    assert (np.abs(got.astype(int) - np.asarray(FRAME_BG)).max(-1) > 3).mean() > 0.02



def test_segment_preview_callback():
    """``segment(preview_cb=...)`` renders a subsample's segmentation with
    the session's camera, then segments the full cloud as without it."""
    pts = SESSION_SCENES["forest"]()
    cfg = TConfig(segmentation=TSC(**SMALL_SEG),
                  characteristics=TCC(**SMALL_CH), render=TRC(**FRAME))
    frames = []
    s = tpl.Session.from_points(pts, cfg, device="cpu")
    s.camera = TCamera.orbital(distance=50.0, device="cpu").rotate_orbital(
        10.0, -50.0)
    s.segment(0.75, preview_cb=frames.append, preview_stride=4)
    plain = tpl.Session.from_points(pts, cfg, device="cpu")
    plain.segment(0.75)
    assert torch.equal(s.cloud.segment, plain.cloud.segment)
    assert len(frames) == 1
    img = frames[0]
    assert img.dtype == np.uint8 and img.shape == (120, 160, 3)
    sub_pos = s.cloud.pos[::4]
    sub_valid = s.cloud.valid[::4]
    sub_seg, _, _, _ = tpl.full_pipeline(sub_pos.contiguous(),
                                         sub_valid.contiguous(), 0.75, cfg)
    ref = tsplat.to_u8(tsplat.render_frame(
        sub_pos, tsplat.prop_from_segment(sub_seg), sub_valid & (sub_seg != 0),
        s.camera, s.palette, cfg.render)).numpy()
    np.testing.assert_array_equal(img, ref)


def test_session_frame_state_lives_on_the_session_device():
    s = tpl.Session(TConfig(render=TRC(palette="warm")), device="cpu")
    assert s.camera.transform.device == s.device
    assert torch.equal(s.palette, tpal.warm(device="cpu"))
    assert float(s.camera.offset) == 100.0


# ---- the kernel wrappers' dispatch -------------------------------------------------

def test_frame_wrappers_take_plain_path_on_cpu_and_refuse_other_devices():
    kimg, jc = _dilation_input(True)
    params = tsplat.dilate_params(_port_camera(jc), TRC(width=64, height=48))
    color, z01 = _eye_dome_inputs(far=True)
    kernels.reset_launches()
    assert torch.equal(kernels.dilate(_t(kimg), 3, *params),
                       kernels.dilate_plain(_t(kimg), 3, *params))
    assert torch.equal(kernels.eye_dome(_t(color), _t(z01), 0.1, 1e4, 7e-4,
                                        (0, 0, 0)),
                       kernels.eye_dome_plain(_t(color), _t(z01), 0.1, 1e4,
                                              7e-4, (0, 0, 0)))
    assert sum(kernels.launches().values()) == 0
    with pytest.raises(ValueError, match="device"):
        kernels.dilate(_t(kimg).to("meta"), 3, *params)
    with pytest.raises(ValueError, match="device"):
        kernels.eye_dome(_t(color).to("meta"), _t(z01).to("meta"), 0.1, 1e4,
                         7e-4, (0, 0, 0))
    with pytest.raises(ValueError):
        kernels.dilate(_t(kimg), 0, *params)
    with pytest.raises(ValueError):
        kernels.dilate(_t(kimg).float(), 3, *params)
    with pytest.raises(ValueError):
        kernels.dilate(torch.zeros(0, 5, dtype=torch.int32), 3, *params)
    with pytest.raises(ValueError):
        kernels.eye_dome(_t(color)[:, :-1], _t(z01), 0.1, 1e4, 7e-4, (0, 0, 0))
    assert sum(kernels.launches().values()) == 0
