"""Camera model, the port of ``treee_tpu/render/camera.py``.

Perspective projection, orbital and first-person controllers, frustum
planes and pixel rays over a 4x4 camera-to-world transform: 45 deg vertical
FOV, near 0.1 / far 10000 (camera.rs:7,24-25).  A :class:`Camera` is a
frozen dataclass; every controller returns a new one.  Its tensors live on
one device, in f32.

The 4x4 products are written out as f32 multiplies and a sum, never as a
matrix multiply, so that no device setting (TF32 on a CUDA card) can lower
their precision.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import DEFAULT_DEVICE

ROTATE_SPEED = 0.002      # camera.rs:3 BASE_ROTATE_SPEED
VERTICAL_SPEED = 0.02     # camera.rs:4


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product of f32[..., n, k] and f32[k, m] (or f32[k]) in full f32."""
    if b.dim() == 1:
        return (a * b).sum(-1)
    return (a[..., :, :, None] * b[None, :, :]).sum(-2)


def _eye(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, zero, s, zero]),
                        torch.stack([zero, one, zero, zero]),
                        torch.stack([-s, zero, c, zero]),
                        torch.stack([zero, zero, zero, one])])


def _rot_x(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([one, zero, zero, zero]),
                        torch.stack([zero, c, -s, zero]),
                        torch.stack([zero, s, c, zero]),
                        torch.stack([zero, zero, zero, one])])


def _translation(v: torch.Tensor) -> torch.Tensor:
    t = _eye(v.device)
    t[:3, 3] = v
    return t


def _z_shift(z: torch.Tensor) -> torch.Tensor:
    t = _eye(z.device)
    t[2, 3] = z
    return t


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera state: camera-to-world transform + intrinsics."""

    transform: torch.Tensor            # f32[4,4] camera-to-world
    offset: torch.Tensor               # f32[] orbital pivot distance
    fov_y: float = 45.0 * math.tau / 360.0
    near: float = 0.1
    far: float = 10_000.0

    @property
    def device(self) -> torch.device:
        return self.transform.device

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    @classmethod
    def orbital(cls, distance: float = 100.0,
                device: str | torch.device = DEFAULT_DEVICE, **kw) -> "Camera":
        """Default view: camera backed off ``distance`` along +z (camera.rs:27-28)."""
        t = _eye(device)
        t[2, 3] = distance
        return cls(transform=t, offset=_f32(distance, device), **kw)

    @classmethod
    def from_numpy(cls, transform, offset, fov_y: float = 45.0 * math.tau / 360.0,
                   near: float = 0.1, far: float = 10_000.0,
                   device: str | torch.device = DEFAULT_DEVICE) -> "Camera":
        """A camera from host state, such as the JAX package's camera's
        ``np.asarray(cam.transform)`` and ``np.asarray(cam.offset)``."""
        t = np.asarray(transform, np.float32)
        if t.shape != (4, 4):
            raise ValueError(f"camera transform must be 4x4, got {t.shape}")
        return cls(transform=torch.from_numpy(t.copy()).to(device),
                   offset=_f32(np.float32(offset), device),
                   fov_y=float(fov_y), near=float(near), far=float(far))

    def to_numpy(self) -> dict:
        """Host state; ``Camera.from_numpy(**cam.to_numpy())`` round-trips."""
        return {"transform": self.transform.cpu().numpy(),
                "offset": np.float32(self.offset.cpu()),
                "fov_y": self.fov_y, "near": self.near, "far": self.far}

    def to(self, device: str | torch.device) -> "Camera":
        return self.replace(transform=self.transform.to(device),
                            offset=self.offset.to(device))

    # ---- matrices --------------------------------------------------------------

    def view_matrix(self) -> torch.Tensor:
        """World-to-camera (inverse of the rigid transform)."""
        r = self.transform[:3, :3]
        t = self.transform[:3, 3]
        inv = _eye(self.device)
        inv[:3, :3] = r.T
        inv[:3, 3] = -_mm(r.T, t)
        return inv

    def projection_entries(self, aspect: float) -> np.ndarray:
        """The projection matrix as np.float32[4,4]: each entry computed in
        double from the intrinsics, then rounded to f32 once."""
        f = 1.0 / math.tan(self.fov_y / 2.0)
        n, fr = self.near, self.far
        return np.array(
            [
                [f / aspect, 0.0, 0.0, 0.0],
                [0.0, f, 0.0, 0.0],
                [0.0, 0.0, fr / (n - fr), n * fr / (n - fr)],
                [0.0, 0.0, -1.0, 0.0],
            ],
            np.float32,
        )

    def projection_matrix(self, aspect: float) -> torch.Tensor:
        """Right-handed perspective, NDC z in [0,1] (wgpu convention)."""
        return torch.from_numpy(self.projection_entries(aspect)).to(self.device)

    @property
    def position(self) -> torch.Tensor:
        return self.transform[:3, 3]

    def _axis(self, v) -> torch.Tensor:
        return _mm(self.transform[:3, :3], _f32(v, self.device))

    # ---- orbital controller (camera.rs:134-217) ---------------------------------

    def rotate_orbital(self, delta_x, delta_y) -> "Camera":
        """Orbit around the pivot ``offset`` ahead of the camera (camera.rs:183-195)."""
        pivot = self.position + self._axis([0.0, 0.0, -1.0]) * self.offset
        yaw = _f32(-delta_x * ROTATE_SPEED, self.device)
        pitch = _f32(-delta_y * ROTATE_SPEED, self.device)
        # rotate around world y through the pivot
        t = _mm(_mm(_mm(_translation(pivot), _rot_y(yaw)),
                    _translation(-pivot)), self.transform)
        # pitch around the camera's local x at the pivot
        t = _mm(_mm(_mm(t, _z_shift(-self.offset)), _rot_x(pitch)),
                _z_shift(self.offset))
        return self.replace(transform=t)

    def scroll_orbital(self, value) -> "Camera":
        """Exponential zoom toward the pivot (camera.rs:207-214)."""
        new_offset = torch.clamp(self.offset * (1.0 + value / 10.0), min=0.01)
        t = _mm(self.transform, _z_shift(new_offset - self.offset))
        return self.replace(transform=t, offset=new_offset)

    def move_orbital(self, direction_x, direction_y) -> "Camera":
        """WASD pan scaled by the pivot distance (camera.rs:159-164)."""
        right = self._axis([1.0, 0.0, 0.0])
        fwd = torch.linalg.cross(right, _f32([0.0, 1.0, 0.0], self.device))
        v = (right * direction_x + fwd * direction_y) * self.offset
        t = self.transform.clone()
        t[:3, 3] += v
        return self.replace(transform=t)

    def move_vertical(self, amount) -> "Camera":
        t = self.transform.clone()
        t[:3, 3] += (_f32([0.0, 1.0, 0.0], self.device) * amount * self.offset
                     * VERTICAL_SPEED)
        return self.replace(transform=t)

    # ---- first-person controller (camera.rs:147-216, Controller::FirstPerson;
    # ``offset`` doubles as the move sensitivity, Controller::distance) -------

    def move_first_person(self, direction_x, direction_y) -> "Camera":
        """Translate in the camera's local xz plane (camera.rs:152-155)."""
        local = _translation(
            _f32([1.0, 0.0, 0.0], self.device) * direction_x * self.offset
            + _f32([0.0, 0.0, 1.0], self.device) * direction_y * self.offset)
        return self.replace(transform=_mm(self.transform, local))

    def rotate_first_person(self, delta_x, delta_y) -> "Camera":
        """Yaw around world y through the camera position, pitch around the
        local x axis (camera.rs:170-182)."""
        yaw = _f32(-delta_x * ROTATE_SPEED, self.device)
        pitch = _f32(-delta_y * ROTATE_SPEED, self.device)
        p = self.position
        t = _mm(_mm(_mm(_mm(_translation(p), _rot_y(yaw)), _translation(-p)),
                    self.transform), _rot_x(pitch))
        return self.replace(transform=t)

    def scroll_first_person(self, value) -> "Camera":
        """Scroll adjusts the move sensitivity, not the pose (camera.rs:202-206)."""
        return self.replace(
            offset=torch.clamp(self.offset * (1.0 + value / 10.0), min=0.01))

    # ---- frustum ----------------------------------------------------------------

    def frustum_planes(self, aspect: float) -> torch.Tensor:
        """World-space frustum planes f32[6,4]: a*x+b*y+c*z+d >= 0 inside.

        Planes come from the view-projection rows (Gribb-Hartmann), wgpu z
        in [0,1]; they feed LOD node culling.
        """
        m = _mm(self.projection_matrix(aspect), self.view_matrix())
        planes = torch.stack([
            m[3] + m[0],   # left
            m[3] - m[0],   # right
            m[3] + m[1],   # bottom
            m[3] - m[1],   # top
            m[2],          # near (z01 >= 0)
            m[3] - m[2],   # far
        ])
        norm = torch.linalg.vector_norm(planes[:, :3], dim=1, keepdim=True)
        return planes / torch.clamp(norm, min=1e-12)

    # ---- picking ----------------------------------------------------------------

    def ray_direction(self, pixel_x, pixel_y, width: int,
                      height: int) -> torch.Tensor:
        """World-space ray through a pixel (camera.rs:119-127)."""
        dist = (height / 2.0) / math.tan(self.fov_y / 2.0)
        v = _f32([pixel_x - width / 2.0, -(pixel_y - height / 2.0), -dist],
                 self.device)
        d = _mm(self.transform[:3, :3], v)
        return d / torch.linalg.vector_norm(d)
