"""Camera model (counterpart of webdgs_tpu/core/camera.py:54-153).

The same math as the reference: view matrix ``x_view = R (x - C)``, a
projection with a Y flip and z in [0, 1] (znear 0.01, zfar 100), and one
focal length derived from fovY and the viewport height, used for both axes.
``Camera`` holds torch tensors on one device; the viewport size stays a
plain Python pair passed beside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass
class CameraData:
    """Host-side camera record: ``rotation`` is world-to-camera,
    ``position`` the camera center in world space."""

    id: int = 0
    position: np.ndarray | None = None  # (3,)
    rotation: np.ndarray | None = None  # (3,3) world-to-camera
    width: int | None = None
    height: int | None = None
    fx: float | None = None
    fy: float | None = None
    cx: float | None = None
    cy: float | None = None
    img_name: str | None = None
    camera_id: int | None = None


class Camera(NamedTuple):
    """Device-side camera parameters (float32 tensors on one device)."""

    view: torch.Tensor  # (4,4) world->view
    proj: torch.Tensor  # (4,4) view->clip
    cam_pos: torch.Tensor  # (3,) camera center in world space
    focal: torch.Tensor  # (2,) pixels
    viewport: torch.Tensor  # (2,) (W, H) as floats


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov * 0.5))


def projection_matrix(fov_x: float, fov_y: float,
                      znear: float = ZNEAR, zfar: float = ZFAR) -> np.ndarray:
    """Y-flipped projection; z_ndc = (zfar*z - zfar*znear)/((zfar-znear)*z)."""
    tan_y = math.tan(fov_y / 2.0)
    tan_x = math.tan(fov_x / 2.0)
    top = tan_y * znear
    right = tan_x * znear
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 2.0 * znear / (2.0 * right)
    p[1, 1] = -2.0 * znear / (2.0 * top)
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def view_matrix(rotation_w2c: np.ndarray, position: np.ndarray) -> np.ndarray:
    """``x_view = R (x - C)``."""
    v = np.eye(4, dtype=np.float32)
    r = np.asarray(rotation_w2c, dtype=np.float32)[:3, :3]
    v[:3, :3] = r
    v[:3, 3] = -r @ np.asarray(position, dtype=np.float32)
    return v


def make_camera(data: CameraData, width: int | None = None,
                height: int | None = None, *,
                device: str | torch.device) -> Camera:
    """Build a device Camera from a CameraData record: fovY comes from
    (fy, image height); the render focal from fovY and the render viewport
    height, used for both axes."""
    width = int(width if width is not None else (data.width or 0))
    height = int(height if height is not None else (data.height or 0))
    if width <= 0 or height <= 0:
        raise ValueError("camera requires a positive viewport size")

    if data.fy is not None and data.height:
        fov_y = 2.0 * math.atan(data.height / (2.0 * data.fy))
    else:
        fov_y = math.radians(45.0)

    focal = 0.5 * height / math.tan(fov_y * 0.5)
    fov_x = focal2fov(focal, width)

    rot = data.rotation if data.rotation is not None else np.eye(3)
    pos = data.position if data.position is not None else np.zeros(3)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    return Camera(
        view=dev(view_matrix(rot, pos)),
        proj=dev(projection_matrix(fov_x, fov_y)),
        cam_pos=dev(pos),
        focal=dev([focal, focal]),
        viewport=dev([width, height]),
    )


def default_camera(width: int, height: int, position=(0.0, 0.0, 5.0), *,
                   device: str | torch.device) -> Camera:
    """Camera at ``position`` with identity rotation and fovY 45 degrees."""
    fov_y = math.radians(45.0)
    focal = 0.5 * height / math.tan(fov_y * 0.5)
    data = CameraData(position=np.asarray(position, dtype=np.float32),
                      rotation=np.eye(3, dtype=np.float32),
                      fy=focal, height=height)
    return make_camera(data, width, height, device=device)
