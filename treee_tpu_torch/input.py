"""Input state and event-to-action mapping (the reference's ``input`` crate +
Program's event handling).

The reference wraps winit into ``Keyboard`` (pressed set + modifiers,
input/src/keyboard.rs:4-44) and ``Mouse`` (pressed set, position, delta,
input/src/mouse.rs:31-69), and its Program maps them to camera / interactive
actions: WASD/arrow accumulation normalized and scaled by frame time with Q/E
vertical movement (program.rs:412-450), left-drag rotate, sub-2-pixel
left-click select, right-press/drag brush edits (program.rs:555-622).

Here the same layer is a host-side shim: the framework's compute is pure
jitted functions, so the controller just folds events into (camera, action)
updates.  Any frontend (notebook widget, web bridge, offline script) feeds it
events and reads back the camera + the actions to apply to a Session.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .render.camera import Camera

CLICK_MAX_DRAG_PX = 2.0  # program.rs:566-569


class Keyboard:
    """Pressed-key set + modifier tracking (keyboard.rs:4-44)."""

    def __init__(self) -> None:
        self._pressed: set[str] = set()

    def update(self, key: str, pressed: bool) -> None:
        key = key.lower()
        if pressed:
            self._pressed.add(key)
        else:
            self._pressed.discard(key)

    def pressed(self, key: str) -> bool:
        return key.lower() in self._pressed

    @property
    def shift(self) -> bool:
        return self.pressed("shift")

    @property
    def ctrl(self) -> bool:
        return self.pressed("ctrl")


class Mouse:
    """Pressed-button set, position, and move delta (mouse.rs:31-69)."""

    def __init__(self) -> None:
        self._pressed: set[str] = set()
        self.position = np.zeros(2, np.float32)

    def update(self, button: str, pressed: bool) -> None:
        button = button.lower()
        if pressed:
            self._pressed.add(button)
        else:
            self._pressed.discard(button)

    def pressed(self, button: str) -> bool:
        return button.lower() in self._pressed

    def delta(self, position) -> np.ndarray:
        position = np.asarray(position, np.float32)
        d = position - self.position
        self.position = position
        return d


@dataclasses.dataclass
class InputController:
    """Folds keyboard/mouse events into camera updates + interactive actions.

    Mirrors Program::update/mouse_click/mouse_move (program.rs:412-450,
    555-622).  ``on_click(x, y)`` fires for a sub-2px left click (ray select),
    ``on_drag(x, y)`` for right-press and right-drag (brush edit).
    """

    camera: Camera
    mode: str = "orbital"  # or "first_person" (camera.rs Controller variants)
    on_click: Callable[[float, float], None] | None = None
    on_drag: Callable[[float, float], None] | None = None
    # rotation sensitivity multiplier on drag deltas: frontends that deliver
    # FRAME-pixel positions (browser canvas downscaled from the client rect)
    # see smaller deltas than the reference's window-pixel winit events —
    # the serve page sets 4.0 to keep its historical drag feel.  Positions
    # (clicks, brush) are never scaled.
    rotate_scale: float = 1.0

    def __post_init__(self) -> None:
        self.keyboard = Keyboard()
        self.mouse = Mouse()
        self._mouse_start: np.ndarray | None = None

    # ---- events -------------------------------------------------------------

    def key(self, key: str, pressed: bool) -> None:
        self.keyboard.update(key, pressed)

    def mouse_button(self, button: str, pressed: bool,
                     x: float | None = None, y: float | None = None) -> None:
        """Button event; pass the cursor position when the frontend delivers
        it with the event — winit sends CursorMoved before presses so the
        reference never sees a stale position, but a frontend that doesn't
        stream hover moves would otherwise click at the last drag point (or
        the (0,0) init)."""
        if x is not None and y is not None:
            self.mouse.position = np.asarray((x, y), np.float32)
        self.mouse.update(button, pressed)
        if button == "left":
            if pressed:
                self._mouse_start = self.mouse.position.copy()
            else:
                start = self._mouse_start
                self._mouse_start = None
                if (
                    start is not None
                    and np.linalg.norm(start - self.mouse.position)
                    < CLICK_MAX_DRAG_PX
                    and self.on_click is not None
                ):
                    self.on_click(*self.mouse.position)
        elif button == "right" and pressed and self.on_drag is not None:
            self.on_drag(*self.mouse.position)

    def mouse_move(self, x: float, y: float) -> None:
        d = self.mouse.delta((x, y)) * self.rotate_scale
        if self.mouse.pressed("left"):
            if self.mode == "first_person":
                self.camera = self.camera.rotate_first_person(d[0], d[1])
            else:
                self.camera = self.camera.rotate_orbital(d[0], d[1])
        elif self.mouse.pressed("right") and self.on_drag is not None:
            self.on_drag(x, y)

    def scroll(self, value: float) -> None:
        if self.mode == "first_person":
            self.camera = self.camera.scroll_first_person(value)
        else:
            self.camera = self.camera.scroll_orbital(value)

    # ---- per-frame movement (program.rs:412-450) ------------------------------

    def tick(self, dt: float) -> None:
        kb = self.keyboard
        direction = np.zeros(2, np.float32)
        if kb.pressed("d") or kb.pressed("arrowright"):
            direction[0] += 1.0
        if kb.pressed("a") or kb.pressed("arrowleft"):
            direction[0] -= 1.0
        if kb.pressed("s") or kb.pressed("arrowdown"):
            direction[1] += 1.0
        if kb.pressed("w") or kb.pressed("arrowup"):
            direction[1] -= 1.0
        norm = float(np.linalg.norm(direction))
        if norm > 0.0:
            direction *= dt / norm
            if self.mode == "first_person":
                self.camera = self.camera.move_first_person(
                    direction[0], direction[1]
                )
            else:
                self.camera = self.camera.move_orbital(direction[0], direction[1])
        if kb.pressed("q"):
            self.camera = self.camera.move_vertical(dt * -10.0)
        if kb.pressed("e"):
            self.camera = self.camera.move_vertical(dt * 10.0)
