"""Headless fly-camera controller (a copy of
webdgs_tpu/render/camera_control.py, which is numpy already).

Ports the interaction semantics of the reference's ``CameraControl``
(src/camera/camera-control.ts): WASD/Space/Ctrl translation at 4 units/s
along the camera's look/right/up axes, Q/E roll at 80 deg/s about the look
axis, pointer-drag yaw/pitch at 0.003 rad/pixel (yaw about camera up, pitch
about camera right), wheel dolly at 0.002 units per wheel delta along look.

The reference drives this from DOM events inside a rAF loop; here the same
math is a plain object usable from scripts, the offline viewer, and tests.
"""

from __future__ import annotations

import math

import numpy as np

LOOK_SENSITIVITY = 0.003  # camera-control.ts:40
MOVE_SPEED = 4.0  # camera-control.ts:83
ROLL_SPEED_DEG = 80.0  # camera-control.ts:100
WHEEL_DOLLY = 0.002  # camera-control.ts:172

CANONICAL_FORWARD = np.array([0.0, 0.0, 1.0], np.float32)
CANONICAL_RIGHT = np.array([1.0, 0.0, 0.0], np.float32)
CANONICAL_UP = np.array([0.0, 1.0, 0.0], np.float32)


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    t = 1.0 - c
    return np.array([
        [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
        [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
    ], dtype=np.float32)


class FlyCamera:
    """Position + rotation state with the reference's control responses.

    ``rotation`` is the world-to-camera matrix (the reference stores the
    same convention in Camera.rotation and composes view = R @ T(-pos)).
    """

    def __init__(self, position=(0.0, 0.0, 5.0), rotation=None):
        self.position = np.asarray(position, np.float32).copy()
        self.rotation = (np.asarray(rotation, np.float32).copy()
                         if rotation is not None
                         else np.eye(3, dtype=np.float32))

    # camera.ts:172-179: basis vectors from the inverse view rotation
    @property
    def look(self) -> np.ndarray:
        return self.rotation.T @ CANONICAL_FORWARD

    @property
    def right(self) -> np.ndarray:
        return self.rotation.T @ CANONICAL_RIGHT

    @property
    def up(self) -> np.ndarray:
        return self.rotation.T @ CANONICAL_UP

    def move(self, dt: float, forward=False, backward=False, left=False,
             right=False, up=False, down=False) -> None:
        """WASD/Space/Ctrl translation (camera-control.ts:78-98)."""
        v = np.zeros(3, np.float32)
        if forward:
            v += self.look
        if backward:
            v -= self.look
        if left:
            v -= self.right
        if right:
            v += self.right
        if up:
            v += self.up
        if down:
            v -= self.up
        n = np.linalg.norm(v)
        if n > 0:
            self.position += v / n * (MOVE_SPEED * dt)

    def drag(self, dx_pixels: float, dy_pixels: float) -> None:
        """Pointer-drag yaw/pitch (camera-control.ts:177-201)."""
        yaw = dx_pixels * LOOK_SENSITIVITY
        pitch = -dy_pixels * LOOK_SENSITIVITY
        if yaw != 0.0:
            self.rotation = self.rotation @ _axis_angle_matrix(self.up, yaw)
        if pitch != 0.0:
            self.rotation = self.rotation @ _axis_angle_matrix(self.right,
                                                               pitch)

    def roll(self, dt: float, left=False, right=False) -> None:
        """Q/E roll about the look axis (camera-control.ts:100-102,203-209)."""
        angle = math.radians(ROLL_SPEED_DEG) * dt
        if left:
            self.rotation = self.rotation @ _axis_angle_matrix(self.look,
                                                               angle)
        if right:
            self.rotation = self.rotation @ _axis_angle_matrix(self.look,
                                                               -angle)

    def wheel(self, delta_y: float) -> None:
        """Wheel dolly (camera-control.ts:169-175)."""
        self.position += self.look * (-delta_y * WHEEL_DOLLY)
