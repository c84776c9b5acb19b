"""Offline viewer: load a splat, fly or orbit a camera, render frames to
arrays or PNG files (counterpart of webdgs_tpu/render/viewer.py:22-256).

The viewer renders on one device, ``"cuda"`` by default.  There is no CPU
fallback: asking for CUDA where there is none raises.  Frames at or above
the 16-bit tile-key limit (8K and up at 32x16 tiles) render in serial
bands, in both render modes.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from webdgs_tpu_torch import trace
from webdgs_tpu_torch.config import (DEFAULT_SETTINGS, CapacityBudget,
                                     RenderSettings)
from webdgs_tpu_torch.core.camera import Camera, CameraData, make_camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.render.camera_control import FlyCamera
from webdgs_tpu_torch.render.renderer import (render, render_banded,
                                              render_points)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to render on; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "webdgs_tpu_torch does not fall back to the CPU (pass "
            "device='cpu' to render there)")
    return dev


def save_png(path: str | os.PathLike, image: np.ndarray) -> None:
    from PIL import Image
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def look_at_rotation(position: np.ndarray, target: np.ndarray,
                     up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera rotation looking from position toward target, with
    the +z-forward view convention."""
    fwd = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    true_up = np.cross(fwd, right)
    return np.stack([right, true_up, fwd]).astype(np.float32)


def _frame_center_radius(scene: GaussianScene) -> tuple[np.ndarray, float]:
    means = scene.means.detach().cpu().numpy()
    alive = scene.alive.cpu().numpy()
    pts = means[alive] if alive.any() else means
    center = pts.mean(axis=0)
    radius = float(np.percentile(
        np.linalg.norm(pts - center, axis=1), 90) * 2.5 + 1e-3)
    return center, radius


def _host_copy(image: torch.Tensor) -> np.ndarray:
    with trace.span("view.host_copy"):
        return image.cpu().numpy()


class Viewer:
    """Render a scene interactively-by-script: a FlyCamera plus render()."""

    def __init__(self, scene: GaussianScene, width: int = 800,
                 height: int = 600,
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 fov_y_deg: float = 45.0,
                 render_mode: str = "gaussian",
                 point_size_px: float = 3.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.width = width
        self.height = height
        self.settings = settings
        self.fov_y = math.radians(fov_y_deg)
        self.control = FlyCamera(position=(0.0, 0.0, 5.0))
        self.render_mode = render_mode  # 'gaussian' | 'pointcloud'
        self.point_size_px = point_size_px
        self.gaussian_scaling = float(settings.gaussian_scaling)
        # adaptive tile-entry capacity, sized from the last frame's demand
        self._entry_budget = CapacityBudget(headroom=1.5, decay=0.0,
                                            shrink=3, floor=8)
        # tile entries the last gaussian-mode frame asked for (in a banded
        # frame, its largest band)
        self.entry_demand: int | None = None

    def set_render_mode(self, mode: str) -> None:
        if mode not in ("gaussian", "pointcloud"):
            raise ValueError(f"unknown render mode {mode!r}")
        self.render_mode = mode

    def set_point_size(self, value: float) -> None:
        self.point_size_px = float(value)

    def set_gaussian_scaling(self, value: float) -> None:
        self.gaussian_scaling = max(0.05, float(value))

    def set_point_cloud(self, scene: GaussianScene) -> None:
        self.scene = scene.to(self.device)

    def frame_scene(self) -> None:
        """Place the camera to frame the alive-point centroid."""
        center, radius = _frame_center_radius(self.scene)
        pos = center - np.array([0.0, 0.0, radius], np.float32)
        self.control.position = pos.astype(np.float32)
        # look_at_rotation is y-up; the projection maps +y_view to
        # increasing image row, so roll 180 degrees (negate the x and y
        # camera axes) for upright frames
        rot = look_at_rotation(pos, center)
        self.control.rotation = np.stack([-rot[0], -rot[1], rot[2]])

    def camera(self, width: int | None = None,
               height: int | None = None) -> Camera:
        w = width or self.width
        h = height or self.height
        # fovY is preserved at any viewport; focal re-derives from height
        fy = 0.5 * h / math.tan(self.fov_y * 0.5)
        data = CameraData(position=self.control.position,
                          rotation=self.control.rotation,
                          fy=fy, height=h)
        return make_camera(data, w, h, device=self.device)

    def render(self, downscale: int = 1) -> np.ndarray:
        """Render a frame as an (H, W, 3) numpy array; ``downscale`` > 1
        renders at a reduced viewport (same fov)."""
        with trace.span("view.frame"):
            return self._render(downscale)

    def _render(self, downscale: int) -> np.ndarray:
        w = max(1, self.width // downscale)
        h = max(1, self.height // downscale)
        cam = self.camera(w, h)
        ntx, nty = binning_ops.tile_grid(w, h, self.settings)
        if ntx * nty >= binning_ops.TILE_KEY_LIMIT:
            return self._render_banded(cam, w, h, downscale)
        with torch.no_grad():
            if self.render_mode == "pointcloud":
                img = render_points(
                    self.scene, cam, w, h, self.settings,
                    point_size_px=self.point_size_px,
                    gaussian_scaling=self.gaussian_scaling)
                return _host_copy(img)
            res = render(self.scene, cam, w, h, self.settings,
                         entry_capacity=self._entry_budget.value,
                         gaussian_scaling=self.gaussian_scaling)
            image = _host_copy(res.image)
        # the pre-drop demand: total_entries saturates at the capacity
        self.entry_demand = int(res.binning.expansion_entries)
        if downscale == 1:
            self._entry_budget.observe(self.entry_demand,
                                       self.settings.chunk)
        return image

    def _render_banded(self, cam: Camera, w: int, h: int,
                       downscale: int) -> np.ndarray:
        """A frame above the tile-key limit, in serial bands (both modes);
        the entry capacity adapts to the largest band's demand, and only
        at full resolution, as in the plain branch."""
        with torch.no_grad():
            img, observed = render_banded(
                self.scene, cam, w, h, self.settings,
                entry_capacity=self._entry_budget.value,
                gaussian_scaling=self.gaussian_scaling,
                mode=self.render_mode, point_size_px=self.point_size_px,
                return_entries=True)
            image = _host_copy(img)
        if observed is not None:
            observed = int(observed)
            if self.render_mode == "gaussian":
                self.entry_demand = observed
            if downscale == 1:
                self._entry_budget.observe(observed, self.settings.chunk)
        return image


def orbit_cameras(center, radius: float, n_frames: int, width: int,
                  height: int, elevation_deg: float = 15.0,
                  fov_y_deg: float = 45.0, *,
                  device: str | torch.device) -> list[Camera]:
    center = np.asarray(center, np.float32)
    el = math.radians(elevation_deg)
    fy = 0.5 * height / math.tan(math.radians(fov_y_deg) * 0.5)
    cams = []
    for i in range(n_frames):
        az = 2.0 * math.pi * i / n_frames
        pos = center + radius * np.array([
            math.cos(el) * math.sin(az),
            math.sin(el),
            math.cos(el) * math.cos(az)], np.float32)
        rot = look_at_rotation(pos, center)
        cams.append(make_camera(CameraData(position=pos, rotation=rot,
                                           fy=fy, height=height),
                                width, height, device=device))
    return cams


def render_orbit(scene: GaussianScene, out_dir: str | os.PathLike,
                 n_frames: int = 24, width: int = 800, height: int = 600,
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 radius: float | None = None) -> list[str]:
    """Render an orbit around the alive-point centroid to PNG frames, on
    the scene's device.  Above the tile-key limit ``render`` raises, as in
    the reference."""
    center, auto_radius = _frame_center_radius(scene)
    radius = auto_radius if radius is None else radius
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    cams = orbit_cameras(center, radius, n_frames, width, height,
                         device=scene.device)
    for i, cam in enumerate(cams):
        with torch.no_grad():
            img = render(scene, cam, width, height, settings).image
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        save_png(p, img.cpu().numpy())
        paths.append(p)
    return paths


def frames_to_video(frame_paths: list[str], out_path: str | os.PathLike,
                    fps: int = 12) -> str:
    """Encode rendered frames into a video file: ``.gif`` with PIL; any
    other extension with ``ffmpeg`` when present, else ``<out>.gif``."""
    out_path = str(out_path)
    if not frame_paths:
        raise ValueError("no frames to encode")
    if not out_path.lower().endswith(".gif"):
        import shutil
        import subprocess
        import tempfile
        if shutil.which("ffmpeg"):
            # feed the exact frame list via the concat demuxer
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".txt", delete=False,
                    dir=os.path.dirname(os.path.abspath(out_path))) as lf:
                for fp in frame_paths:
                    lf.write(f"file '{os.path.abspath(fp)}'\n")
                    lf.write(f"duration {1.0 / fps}\n")
                list_path = lf.name
            try:
                subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "error", "-f", "concat",
                     "-safe", "0", "-i", list_path, "-vf", f"fps={fps}",
                     "-pix_fmt", "yuv420p", out_path], check=True)
            finally:
                os.unlink(list_path)
            return out_path
        out_path = os.path.splitext(out_path)[0] + ".gif"
    from PIL import Image
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
              for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(1, round(1000 / fps)), loop=0)
    return out_path
